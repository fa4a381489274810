"""The analyse/factorize/solve session front door.

Symbolic analysis and partitioning happen ONCE per sparsity pattern, then
many numeric solves amortize it. :class:`SpTRSVContext` is that lifecycle
as an object:

* **analyse** — block structure + levels + partition, keyed by a
  sparsity-*pattern* hash × options and shared across every handle on the
  same pattern; distinct numeric contents get distinct *handles* via ``tag``
  so one factorization can never clobber another's values.
* **factorize** — numeric tile/diagonal refresh into the existing plans
  (:func:`repro_torch.core.solver.refresh_plan`); live executors are re-armed
  with the new values, schedules untouched.
* **solve** — cached executors per handle and sweep direction. The L^T
  sweep is a lazy transpose extension of the same handle.

The session runs on one device, the card unless the caller passes
``device="cpu"``. Auto-tuning, the persistent plan store and the metrics
registry are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.api.options import PlanOptions, as_options
from repro_torch.core.blocking import BlockStructure, build_blocks
from repro_torch.core.partition import Partition, make_partition
from repro_torch.core.solver import (
    Plan, Solver, SolverConfig, build_plan, dispatch_stats, refresh_plan,
)
from repro_torch.device import resolve_device
from repro_torch.sparse.matrix import CSR


def pattern_key(a: CSR) -> str:
    """Hash of the exact scalar sparsity pattern (structure only, no values)."""
    h = hashlib.sha1()
    h.update(np.int64(a.n).tobytes())
    h.update(np.ascontiguousarray(a.row_ptr, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(a.col_idx, dtype=np.int32).tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class _Symbolic:
    """The per-pattern analysis every handle on that pattern shares."""

    bs: BlockStructure
    part: Partition


@dataclasses.dataclass
class SpTRSVHandle:
    """One numeric factorization on one analysed pattern (opaque to callers).

    References the shared symbolic analysis and owns the current numeric
    plans (forward; transpose built lazily) and their executors.
    """

    pattern: str
    tag: str
    options: PlanOptions
    config: SolverConfig
    matrix: CSR  # current numeric values on this pattern
    symbolic: _Symbolic
    plan: Plan | None = None  # forward plan (lazy)
    tplan: Plan | None = None  # transpose plan (lazy)
    solvers: dict = dataclasses.field(default_factory=dict)  # transpose -> Solver
    shapes: set = dataclasses.field(default_factory=set)  # (transpose, R) served
    n_factorize: int = 0

    @property
    def part(self) -> Partition:
        return self.symbolic.part

    @property
    def bs(self) -> BlockStructure:
        return self.symbolic.bs


class SpTRSVContext:
    """Analyse-once / factorize-cheaply / solve-many session on one device.

    ``device=None`` means the card and raises when there is none; tests pass
    ``device="cpu"``. ``options`` set the session default; ``analyse`` and
    ``factorize`` accept per-call overrides. Counters (:meth:`stats`) audit
    the amortization: ``analyses`` counts real partition constructions
    (shared-pattern handles do NOT re-count), ``solves`` the executor
    invocations. ``cache_capacity`` bounds the handle cache LRU-style, counted
    under ``evictions``; the symbolic cache is kept, so an evicted pattern
    re-enters without re-partitioning.
    """

    n_devices = 1  # multi-device sessions are not ported yet

    def __init__(self, device: str | torch.device | None = None,
                 options: PlanOptions | SolverConfig | None = None,
                 cache_capacity: int | None = None):
        self.device = resolve_device(device)
        self.options = as_options(options)
        if cache_capacity is not None and cache_capacity < 1:
            raise ValueError("cache_capacity must be >= 1 (or None: unbounded)")
        self.cache_capacity = cache_capacity
        self._entries: collections.OrderedDict[tuple, SpTRSVHandle] = \
            collections.OrderedDict()
        self._symbolic: dict[tuple, _Symbolic] = {}
        self._counters: collections.Counter = collections.Counter()

    def _evict(self) -> None:
        while (self.cache_capacity is not None
               and len(self._entries) > self.cache_capacity):
            self._entries.popitem(last=False)
            self._counters["evictions"] += 1

    # -- analyse ----------------------------------------------------------

    def _analyse_symbolic(self, a: CSR, pattern: str, opts: PlanOptions) -> _Symbolic:
        # everything the partition construction reads
        key = (pattern, opts.block_size, opts.partition.value,
               opts.tasks_per_device, opts.rhs_hint)
        sym = self._symbolic.get(key)
        if sym is not None:
            self._counters["symbolic_hits"] += 1
            return sym
        self._counters["analyses"] += 1
        bs = build_blocks(a, opts.block_size)
        part = make_partition(bs, self.n_devices, opts.partition.value,
                              opts.tasks_per_device, cost_R=opts.rhs_hint)
        sym = _Symbolic(bs=bs, part=part)
        self._symbolic[key] = sym
        return sym

    def analyse(self, a: CSR, options: PlanOptions | SolverConfig | None = None,
                *, tag: str = "") -> SpTRSVHandle:
        """Symbolic analysis of ``a``'s sparsity pattern (cached).

        ``tag`` names the numeric content: handles with different tags on the
        same pattern share the analysis but hold independent values. The
        returned handle carries ``a``'s values until the next
        :meth:`factorize`.
        """
        opts = as_options(options) if options is not None else self.options
        pat = pattern_key(a)
        key = (pat, opts, tag)
        hit = self._entries.get(key)
        if hit is not None:
            self._counters["analysis_hits"] += 1
            self._entries.move_to_end(key)
            if hit.matrix is not a and not np.array_equal(hit.matrix.val, a.val):
                # same pattern, new values: refresh so the handle never goes stale
                self.factorize(a, hit)
            return hit
        handle = SpTRSVHandle(pattern=pat, tag=tag, options=opts,
                              config=opts.to_config(), matrix=a,
                              symbolic=self._analyse_symbolic(a, pat, opts))
        self._entries[key] = handle
        self._evict()
        return handle

    # -- factorize --------------------------------------------------------

    def factorize(self, a: CSR, handle: SpTRSVHandle | None = None,
                  options: PlanOptions | SolverConfig | None = None,
                  *, tag: str = "") -> SpTRSVHandle:
        """Numeric refresh: install ``a``'s values into an existing analysis.

        ``a`` must share the handle's exact sparsity pattern (checked by
        hash). With no handle given, the (pattern, options, tag) entry is
        looked up and analysed first if unseen.
        """
        if handle is None:
            opts = as_options(options) if options is not None else self.options
            handle = self._entries.get((pattern_key(a), opts, tag))
            if handle is None:
                handle = self.analyse(a, opts, tag=tag)
                self._counters["factorizes"] += 1
                handle.n_factorize += 1
                return handle
        else:
            if options is not None and as_options(options) != handle.options:
                raise ValueError(
                    "factorize: options conflict with the given handle's — "
                    "pass either a handle or options, not both"
                )
            if tag and tag != handle.tag:
                raise ValueError(
                    f"factorize: tag {tag!r} conflicts with the given "
                    f"handle's tag {handle.tag!r}"
                )
            if pattern_key(a) != handle.pattern:
                raise ValueError(
                    "factorize: sparsity pattern differs from the analysed "
                    "one — numeric refresh requires an identical pattern; "
                    "call analyse() for a new pattern"
                )
        self._counters["factorizes"] += 1
        handle.n_factorize += 1
        handle.matrix = a
        if handle.plan is not None:
            handle.plan = refresh_plan(handle.plan, a)
            if False in handle.solvers:
                handle.solvers[False].refresh(handle.plan)
        if handle.tplan is not None:
            handle.tplan = refresh_plan(handle.tplan, a)
            if True in handle.solvers:
                handle.solvers[True].refresh(handle.tplan)
        return handle

    # -- solve ------------------------------------------------------------

    def solve(self, handle: SpTRSVHandle | CSR, b: np.ndarray, *,
              transpose: bool = False) -> np.ndarray:
        """Solve ``L x = b`` (or ``L^T x = b``) with the cached executor.
        ``b`` is ``(n,)`` or an ``(n, R)`` panel; the result is numpy."""
        if isinstance(handle, CSR):
            handle = self.analyse(handle)
        key = (handle.pattern, handle.options, handle.tag)
        if key in self._entries:  # LRU: a served handle is recently used
            self._entries.move_to_end(key)
        solver = self.executor(handle, transpose=transpose)
        b = np.asarray(b)
        shape = (transpose, b.shape[1] if b.ndim == 2 else 1)
        if shape in handle.shapes:
            self._counters["solve_cache_hits"] += 1
        else:
            self._counters["solve_cache_misses"] += 1
            handle.shapes.add(shape)
        self._counters["solves"] += 1
        return solver.solve(b)

    def executor(self, handle: SpTRSVHandle, *, transpose: bool = False) -> Solver:
        """The :class:`Solver` for one sweep direction, built lazily (the
        transpose executor extends the same analysis, not a second one)."""
        solver = handle.solvers.get(transpose)
        if solver is None:
            solver = Solver(self.plan(handle, transpose=transpose), self.device)
            handle.solvers[transpose] = solver
        return solver

    def plan(self, handle: SpTRSVHandle, *, transpose: bool = False) -> Plan:
        """Current numeric plan for the handle (forward plans reuse the
        analysis partition; transpose plans analyse the reversed structure
        once, lazily)."""
        if transpose:
            if handle.tplan is None:
                handle.tplan = build_plan(handle.matrix, self.n_devices,
                                          handle.config, transpose=True)
                self._counters["transpose_extensions"] += 1
            return handle.tplan
        if handle.plan is None:
            handle.plan = build_plan(handle.matrix, self.n_devices,
                                     handle.config, part=handle.part)
        return handle.plan

    # -- introspection ----------------------------------------------------

    def dispatch_stats(self, handle: SpTRSVHandle) -> dict:
        """Dispatch counts for the handle's forward plan."""
        return dict(dispatch_stats(self.plan(handle)))

    def stats(self) -> dict:
        """Counter snapshot incl. the cache hit rate over analyse + solve
        (symbolic-analysis reuse across handles counts as hits too)."""
        c = dict(self._counters)
        hits = (c.get("analysis_hits", 0) + c.get("solve_cache_hits", 0)
                + c.get("symbolic_hits", 0))
        misses = c.get("analyses", 0) + c.get("solve_cache_misses", 0)
        c["cache_hit_rate"] = hits / (hits + misses) if hits + misses else 0.0
        return c
