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
``device="cpu"``; given a ``torch.distributed`` ``group`` of D ranks, each
rank's session is one device of a D-device session (either comm mode,
every scheduler; every rank builds the same plans and runs its own
device's tables). Auto
mode (:class:`repro_torch.api.options.PlanOptions`
with ``sched``/``comm``/``kernel`` set to ``"auto"``) resolves the execution
mode per matrix at analyse time (:mod:`repro_torch.api.autotune`); the
decision is kept on the handle and reported by
:meth:`SpTRSVContext.dispatch_stats`. The stages open ``sptrsv.*`` spans
(:mod:`repro_torch.obs.trace`) and count into a metrics registry
(:meth:`SpTRSVContext.metrics_snapshot`). With a ``plan_store``
(:class:`repro_torch.service.planstore.PlanStore`) the analysis persists
across processes: ``analyse`` loads a stored plan, strict-verified, before it
analyses, and every plan the session builds is saved.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import time

import numpy as np
import torch

from repro_torch.api import autotune
from repro_torch.api.options import KernelBackend, PlanOptions, as_options
from repro_torch.core import comm
from repro_torch.core.blocking import BlockStructure, build_blocks
from repro_torch.core.partition import Partition, make_partition
from repro_torch.core.solver import (
    Plan, Solver, SolverConfig, build_plan, dispatch_stats, refresh_plan,
)
from repro_torch.device import resolve_device
from repro_torch.obs.metrics import MetricsRegistry, get_registry, record_plan_metrics
from repro_torch.obs.trace import get_tracer
from repro_torch.sparse.matrix import CSR


def plan_digest(plan: Plan) -> int:
    """A 62-bit digest of everything symbolic in ``plan`` (partition,
    schedules, step table, configuration): equal on ranks that built the
    same plan."""
    h = hashlib.sha1(repr((plan.config, plan.n_devices, plan.transpose, plan.buckets)).encode())
    for arr in (plan.part.owner, plan.lvl_off, plan.solve_rows, plan.upd_tiles,
                plan.tile_row, plan.tile_col, plan.ex_rows,
                np.zeros(0) if plan.step_off is None else plan.step_off):
        h.update(np.ascontiguousarray(arr).tobytes())
    return int.from_bytes(h.digest()[:8], "little") >> 2


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
    # auto-tuning is a property of (pattern, options), not of the numeric
    # content: one tuner pass serves every tagged handle on this analysis
    tuned: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SpTRSVHandle:
    """One numeric factorization on one analysed pattern (opaque to callers).

    References the shared symbolic analysis and owns the current numeric
    plans (forward; transpose built lazily), their executors and the
    auto-tuning decision.
    """

    pattern: str
    tag: str
    options: PlanOptions
    config: SolverConfig  # resolved (post-auto) engine config
    matrix: CSR  # current numeric values on this pattern
    symbolic: _Symbolic
    plan: Plan | None = None  # forward plan (lazy unless auto probing built it)
    tplan: Plan | None = None  # transpose plan (lazy)
    auto: autotune.AutoDecision | None = None
    solvers: dict = dataclasses.field(default_factory=dict)  # transpose -> Solver
    shapes: set = dataclasses.field(default_factory=set)  # (transpose, R) served
    n_factorize: int = 0
    plan_store_hit: bool = False  # the analysis came from the persistent store

    @property
    def part(self) -> Partition:
        return self.symbolic.part

    @property
    def bs(self) -> BlockStructure:
        return self.symbolic.bs


class SpTRSVContext:
    """Analyse-once / factorize-cheaply / solve-many session on one device.

    ``device=None`` means the card and raises when there is none; tests pass
    ``device="cpu"``. ``group`` (a ``torch.distributed`` process group)
    makes the session one rank of a multi-device session: ``n_devices`` is
    the group's size, each rank builds the same plans (host numpy, the same
    bits on every rank, checked once per plan with one collective on its
    digest) and runs its own device's tables, and every solve returns the
    whole ``x`` on every rank (:class:`repro_torch.core.solver.Solver`):
    ``comm="zerocopy"`` and ``"unified"``, every scheduler and backend.
    ``"auto"`` options tune on every rank to one decision
    (:func:`repro_torch.api.autotune.tune`); with a ``plan_store`` every rank
    loads, the ranks agree on hit or miss with one collective, and only
    rank 0 saves (the others wait for it).
    ``options`` set the session default; ``analyse`` and
    ``factorize`` accept per-call overrides. Counters (:meth:`stats`) audit
    the amortization: ``analyses`` counts real partition constructions
    (shared-pattern handles do NOT re-count), ``solves`` the executor
    invocations. ``cache_capacity`` bounds the handle cache LRU-style, counted
    under ``evictions``; the symbolic cache is kept, so an evicted pattern
    re-enters without re-partitioning. Every counter is mirrored as a
    ``session.*`` counter of ``registry`` (default: the process-wide
    :func:`repro_torch.obs.metrics.get_registry`), beside the
    ``session.solve_us`` histogram.

    ``plan_store`` (a :class:`repro_torch.service.planstore.PlanStore`,
    duck-typed) makes ``analyse`` consult the persistent store before it
    runs a symbolic analysis — a warm worker serves without one partition or
    schedule construction (``plan_store_hits``, not ``analyses``) — and
    saves every plan the session builds; a save that fails counts under
    ``plan_store_save_errors`` and never fails a solve.
    """

    def __init__(self, device: str | torch.device | None = None,
                 options: PlanOptions | SolverConfig | None = None,
                 cache_capacity: int | None = None,
                 registry: MetricsRegistry | None = None, plan_store=None, group=None):
        self.device = resolve_device(device)
        self.group = group
        self.n_devices = 1 if group is None else comm.size(group)
        self.options = as_options(options)
        self.registry = registry if registry is not None else get_registry()
        self.plan_store = plan_store
        if cache_capacity is not None and cache_capacity < 1:
            raise ValueError("cache_capacity must be >= 1 (or None: unbounded)")
        self.cache_capacity = cache_capacity
        self._entries: collections.OrderedDict[tuple, SpTRSVHandle] = \
            collections.OrderedDict()
        self._symbolic: dict[tuple, _Symbolic] = {}
        self._counters: collections.Counter = collections.Counter()

    def _count(self, name: str) -> None:
        """One event: the session counter and its ``session.*`` mirror."""
        self._counters[name] += 1
        self.registry.counter(f"session.{name}").inc()

    def _evict(self) -> None:
        while (self.cache_capacity is not None
               and len(self._entries) > self.cache_capacity):
            self._entries.popitem(last=False)
            self._count("evictions")

    def _store_save(self, handle: SpTRSVHandle, plan: Plan) -> None:
        """Persist a freshly built plan; a read-only or full store degrades
        to no persistence, never to a failed solve. In a group only rank 0
        writes, and every rank waits for it, so a later session on any rank
        finds the file."""
        if self.plan_store is None:
            return
        if self.group is None or comm.rank(self.group) == 0:
            try:
                self.plan_store.save(plan, pattern=handle.pattern, options=handle.options)
            except Exception:
                self._count("plan_store_save_errors")
        comm.barrier(self.group)

    def _store_load(self, a: CSR, opts: PlanOptions, *, transpose: bool = False) -> Plan | None:
        """The stored plan for ``a`` under ``opts``, or ``None``. In a group
        every rank loads and the ranks agree with one collective (the
        smallest hit flag): a plan that one rank misses is a miss on all, so
        every rank takes the same branch; a hit is checked like a built
        plan (:meth:`_agreed`)."""
        plan = self.plan_store.load(a, self.n_devices, opts, transpose=transpose)
        if self.group is None:
            return plan
        hit = torch.tensor([int(plan is not None)], dtype=torch.int32, device=self.device)
        if not int(comm.all_reduce_min_(hit, self.group)):
            return None
        return self._agreed(plan)

    # -- analyse ----------------------------------------------------------

    @staticmethod
    def _symbolic_key(pattern: str, opts: PlanOptions) -> tuple:
        # everything the partition construction reads; the kernel backend
        # only matters when it feeds calibrated malleable cost weights
        return (pattern, opts.block_size, opts.partition.value,
                opts.tasks_per_device, opts.rhs_hint, opts.calibrate_cost,
                opts.kernel.value if opts.calibrate_cost else None)

    def _analyse_symbolic(self, a: CSR, pattern: str, opts: PlanOptions) -> _Symbolic:
        key = self._symbolic_key(pattern, opts)
        sym = self._symbolic.get(key)
        if sym is not None:
            self._count("symbolic_hits")
            return sym
        self._count("analyses")
        bs = build_blocks(a, opts.block_size)
        cost_weights = None
        if opts.calibrate_cost and opts.partition.value == "malleable":
            from repro_torch.core.costmodel import calibrate_weights

            backend = (None if opts.kernel in (KernelBackend.AUTO, KernelBackend.DEFAULT)
                       else opts.kernel.value)
            cost_weights = calibrate_weights(opts.block_size, backend, device=self.device)
        part = make_partition(bs, self.n_devices, opts.partition.value,
                              opts.tasks_per_device, cost_weights=cost_weights,
                              cost_R=opts.rhs_hint)
        sym = _Symbolic(bs=bs, part=part)
        self._symbolic[key] = sym
        return sym

    def analyse(self, a: CSR, options: PlanOptions | SolverConfig | None = None,
                *, tag: str = "") -> SpTRSVHandle:
        """Symbolic analysis of ``a``'s sparsity pattern (cached).

        ``tag`` names the numeric content: handles with different tags on the
        same pattern share the analysis but hold independent values. Under
        auto options the tuner runs here, once per (analysis, options);
        candidates share the one partition. With a plan store, a stored plan
        for (pattern, options) replaces the whole analysis (auto resolution
        included). The returned handle carries ``a``'s values until the next
        :meth:`factorize`.
        """
        opts = as_options(options) if options is not None else self.options
        pat = pattern_key(a)
        key = (pat, opts, tag)
        hit = self._entries.get(key)
        if hit is not None:
            self._count("analysis_hits")
            self._entries.move_to_end(key)
            if hit.matrix is not a and not np.array_equal(hit.matrix.val, a.val):
                # same pattern, new values: refresh so the handle never goes stale
                self.factorize(a, hit)
            return hit
        plan, decision, solver = None, None, None
        with get_tracer().span("sptrsv.analyse", pattern=pat, tag=tag, n=int(a.n),
                               n_devices=self.n_devices) as span:
            if (self.plan_store is not None
                    and self._symbolic_key(pat, opts) not in self._symbolic):
                plan = self._store_load(a, opts)
            stored = plan is not None
            if stored:
                # a store hit: the symbolic analysis and the resolved config
                # (auto dimensions included) arrive built, hydrated with a's
                # values and verified; no partition or schedule is built
                sym = _Symbolic(bs=plan.bs, part=plan.part)
                config = plan.config
                if opts.is_auto:
                    sym.tuned[opts] = (config, None)
                self._symbolic[self._symbolic_key(pat, opts)] = sym
                self._count("plan_store_hits")
                span.set(plan_store_hit=True, sched=config.sched)
            elif opts.is_auto:
                sym = self._analyse_symbolic(a, pat, opts)
                tuned = sym.tuned.get(opts)
                if tuned is not None:
                    # another handle on this analysis already paid the tuner
                    # (candidate plans + probes): reuse its decision
                    config, decision = tuned
                    self._count("auto_reuses")
                else:
                    config, plan, decision, solver = autotune.tune(
                        a, opts, self.device, bs=sym.bs, part=sym.part, group=self.group)
                    plan = self._agreed(plan)
                    sym.tuned[opts] = (config, decision)
                span.set(sched=config.sched, comm=config.comm,
                         kernel=config.kernel_backend or "default")
            else:
                sym = self._analyse_symbolic(a, pat, opts)
                config = opts.to_config()
        handle = SpTRSVHandle(pattern=pat, tag=tag, options=opts, config=config,
                              matrix=a, symbolic=sym, plan=plan, auto=decision,
                              plan_store_hit=stored)
        if solver is not None:  # probing already built the winner's executor
            handle.solvers[False] = solver
            handle.shapes.add((False, opts.rhs_hint))
        if not stored and plan is not None:
            self._store_save(handle, plan)  # the tuner built the winner already
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
                self._count("factorizes")
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
        self._count("factorizes")
        handle.n_factorize += 1
        handle.matrix = a
        with get_tracer().span("sptrsv.factorize", pattern=handle.pattern,
                               tag=handle.tag, n_factorize=handle.n_factorize):
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
        ``b`` is ``(n,)`` or an ``(n, R)`` panel; the result is numpy, so the
        ``sptrsv.solve`` span and the ``session.solve_us`` observation cover
        the device's work too."""
        if isinstance(handle, CSR):
            handle = self.analyse(handle)
        key = (handle.pattern, handle.options, handle.tag)
        if key in self._entries:  # LRU: a served handle is recently used
            self._entries.move_to_end(key)
        solver = self.executor(handle, transpose=transpose)
        b = np.asarray(b)
        R = b.shape[1] if b.ndim == 2 else 1
        shape = (transpose, R)
        if shape in handle.shapes:
            self._count("solve_cache_hits")
        else:
            self._count("solve_cache_misses")
            handle.shapes.add(shape)
        self._count("solves")
        with get_tracer().span("sptrsv.solve", pattern=handle.pattern,
                               tag=handle.tag, transpose=transpose, R=R):
            t0 = time.perf_counter()
            x = solver.solve(b)
            self.registry.histogram("session.solve_us").observe(
                (time.perf_counter() - t0) * 1e6)
        return x

    def executor(self, handle: SpTRSVHandle, *, transpose: bool = False) -> Solver:
        """The :class:`Solver` for one sweep direction, built lazily (the
        transpose executor extends the same analysis, not a second one)."""
        solver = handle.solvers.get(transpose)
        if solver is None:
            solver = Solver(self.plan(handle, transpose=transpose), self.device, self.group)
            handle.solvers[transpose] = solver
        return solver

    def plan(self, handle: SpTRSVHandle, *, transpose: bool = False) -> Plan:
        """Current numeric plan for the handle (forward plans reuse the
        analysis partition; transpose plans analyse the reversed structure
        once, lazily)."""
        if transpose:
            if handle.tplan is None:
                if self.plan_store is not None:
                    handle.tplan = self._store_load(handle.matrix, handle.options,
                                                    transpose=True)
                if handle.tplan is not None:
                    self._count("plan_store_hits")
                else:
                    handle.tplan = self._agreed(build_plan(
                        handle.matrix, self.n_devices, handle.config, transpose=True,
                        device=self.device, verify=handle.options.verify))
                    self._count("transpose_extensions")
                    self._store_save(handle, handle.tplan)
            return handle.tplan
        if handle.plan is None:
            handle.plan = self._agreed(build_plan(
                handle.matrix, self.n_devices, handle.config, part=handle.part,
                device=self.device, verify=handle.options.verify))
            self._store_save(handle, handle.plan)
        return handle.plan

    def _agreed(self, plan: Plan) -> Plan:
        """``plan``, after one collective showing that every rank of the
        group built the same (no-op without a group): the largest and the
        smallest :func:`plan_digest` over the ranks must be equal."""
        if self.group is not None:
            d = plan_digest(plan)
            both = torch.tensor([d, -d], dtype=torch.int64, device=self.device)
            comm.all_reduce_max_(both, self.group)
            if int(both[0]) != -int(both[1]):
                raise RuntimeError(f"the ranks of the group built different plans (digest "
                                   f"{d:#x} on rank {comm.rank(self.group)})")
        return plan

    # -- introspection ----------------------------------------------------

    def dispatch_stats(self, handle: SpTRSVHandle) -> dict:
        """Dispatch counts for the handle's forward plan, plus the recorded
        auto-tuning decision (``"auto"``) when auto mode ran."""
        stats = dict(dispatch_stats(self.plan(handle)))
        stats["plan_store_hit"] = handle.plan_store_hit
        if handle.auto is not None:
            d = handle.auto
            stats["auto"] = {
                "chosen": d.chosen, "mode": d.mode,
                "scores": dict(d.scores), "probe_us": dict(d.probe_us),
                "compile_us": dict(d.compile_us),
                "probe_overhead_us": d.probe_overhead_us,
            }
        return stats

    def stats(self) -> dict:
        """Counter snapshot incl. the cache hit rate over analyse + solve
        (symbolic-analysis reuse across handles counts as hits too)."""
        c = dict(self._counters)
        hits = (c.get("analysis_hits", 0) + c.get("solve_cache_hits", 0)
                + c.get("symbolic_hits", 0) + c.get("plan_store_hits", 0))
        misses = c.get("analyses", 0) + c.get("solve_cache_misses", 0)
        c["cache_hit_rate"] = hits / (hits + misses) if hits + misses else 0.0
        return c

    def metrics_snapshot(self, handle: SpTRSVHandle | None = None) -> dict:
        """One JSON-safe view over the session's registry: the ``session.*``
        counters and the solve wall-clock histogram, the derived cache hit
        rate, and — given a handle — that handle's plan-static ``plan.*``
        gauges (``dispatch_stats``/``cut_stats``) plus the recorded auto
        probe/build timings (``auto.*``)."""
        self.registry.gauge("session.cache_hit_rate").set(self.stats()["cache_hit_rate"])
        if handle is not None:
            record_plan_metrics(self.registry, self.plan(handle))
            if handle.auto is not None:
                d = handle.auto
                self.registry.gauge("auto.probe_overhead_us").set(d.probe_overhead_us)
                for combo, us in d.probe_us.items():
                    self.registry.gauge("auto.probe_us." + "/".join(combo)).set(us)
                for combo, us in d.compile_us.items():
                    self.registry.gauge("auto.compile_us." + "/".join(combo)).set(us)
        return self.registry.snapshot()
