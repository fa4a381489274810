"""Persistent plan store: the symbolic analysis reused across processes.

Inside one process the session (:class:`repro_torch.api.SpTRSVContext`)
caches the analysis per pattern; this module extends that across
*processes*: the symbolic analysis — block structure, partition, compacted
schedules, ``step_off``, bucket tables — serializes to disk keyed by
**pattern sha1 x options signature**, so a short-lived worker loads a plan
instead of re-running ``build_blocks`` + ``make_partition`` + the schedule
construction.

Only the *symbolic* half of a :class:`repro_torch.core.solver.Plan` is
stored. Numeric values (``diag`` / ``tiles`` and the block structure's tile
values) are rehydrated from the caller's matrix through
:func:`repro_torch.core.solver.refresh_plan`, the factorize path, so a
loaded plan carries exactly the values a fresh ``build_plan`` on that matrix
would, and a matrix whose pattern does not match the stored analysis is
rejected by the refresh's pattern check rather than silently mis-paired.

Trust boundary: every load runs the static plan verifier
(:func:`repro_torch.verify.verify_plan`, ``strict`` by default) over the
hydrated plan. A truncated file, a wrong version header, a config naming a
kernel backend the port does not have, or a mutated schedule table makes
``load`` return ``None`` (counted under ``rejected``) and the caller falls
back to a fresh analysis: the store can only *skip* work, never corrupt a
solve or crash the worker.

File format (the reference package's, so a store written by either package
loads in the other): one ``.plan.npz`` per (pattern, signature) under the
store root — a zip of the symbolic arrays plus a ``meta`` JSON header
(format tag, version, pattern, signature, shapes, the resolved
:class:`~repro_torch.core.solver.SolverConfig`). Writes go to a temporary
file in the same directory and ``os.replace`` into place, so concurrent
workers never observe a half-written entry.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import hashlib
import json
import os
import tempfile

import numpy as np

from repro_torch.core.blocking import BlockStructure
from repro_torch.core.partition import Partition
from repro_torch.core.solver import Plan, SolverConfig, refresh_plan
from repro_torch.kernels.ops import BACKENDS
from repro_torch.obs.trace import get_tracer
from repro_torch.sparse.matrix import CSR

FORMAT = "repro-sptrsv-plan"
VERSION = 1

# the symbolic (values-free) arrays of a Plan, stored verbatim; diag/tiles
# and the block structure's numeric tiles are rehydrated via refresh_plan
_BS_ARRAYS = ("off_rows", "off_cols", "block_level", "block_indeg")
_PART_ARRAYS = ("owner", "boundary")
_PLAN_ARRAYS = ("lvl_off", "lvl_bucket", "solve_rows", "upd_tiles", "ex_rows",
                "ex_boundary", "local_rows", "tile_row", "tile_col", "indeg")


def _jsonable_options(options) -> dict:
    d = dataclasses.asdict(options)
    return {k: (v.value if isinstance(v, enum.Enum) else v)
            for k, v in sorted(d.items())}


def options_signature(options, n_devices: int, *, transpose: bool = False) -> str:
    """Stable short hash of everything that shapes the symbolic plan: the
    options (a :class:`repro_torch.api.options.PlanOptions` — auto
    dimensions included, so a warm auto session keys to the entry its cold
    run saved — or a resolved :class:`SolverConfig`), the device count, and
    the sweep direction. The ``verify`` / ``probe_solves`` knobs are
    excluded: they change how a plan is checked or chosen, never the plan.
    Equal options give the reference package's signature, byte for byte."""
    d = _jsonable_options(options)
    d.pop("verify", None)
    d.pop("probe_solves", None)
    d["n_devices"] = int(n_devices)
    d["transpose"] = bool(transpose)
    h = hashlib.sha1(json.dumps(d, sort_keys=True).encode())
    return h.hexdigest()[:16]


class PlanStore:
    """On-disk plan cache under one root directory.

    ``verify`` sets the :func:`repro_torch.verify.verify_plan` level every
    load must pass (``"strict"`` promotes warnings to failures — the serving
    default: a stale or tampered entry is a fresh-analysis fallback, never a
    wrong answer). Counters (:attr:`stats`) are mirrored into the metrics
    registry as ``planstore.*``.
    """

    def __init__(self, root: str, *, verify: str = "strict", registry=None):
        self.root = root
        self.verify = verify
        if registry is None:
            from repro_torch.obs.metrics import get_registry

            registry = get_registry()
        self.registry = registry
        self._counters: collections.Counter = collections.Counter()
        os.makedirs(root, exist_ok=True)

    # -- bookkeeping -------------------------------------------------------

    def _count(self, name: str) -> None:
        self._counters[name] += 1
        self.registry.counter(f"planstore.{name}").inc()

    @property
    def stats(self) -> dict:
        c = dict(self._counters)
        looked = c.get("hits", 0) + c.get("misses", 0) + c.get("rejected", 0)
        c["hit_rate"] = c.get("hits", 0) / looked if looked else 0.0
        return c

    def path_for(self, pattern: str, signature: str) -> str:
        return os.path.join(self.root, f"{pattern}-{signature}.plan.npz")

    # -- save --------------------------------------------------------------

    def save(self, plan: Plan, *, pattern: str, signature: str | None = None,
             options=None) -> str:
        """Persist ``plan``'s symbolic analysis atomically; returns the path.

        ``pattern`` is the matrix's :func:`repro_torch.api.pattern_key`. The
        key's second half comes from ``options`` (the *pre-resolution*
        :class:`~repro_torch.api.options.PlanOptions` — pass it so auto
        sessions warm-start under their auto key) or an explicit
        ``signature``; with neither, the plan's own resolved config signs the
        entry.
        """
        if signature is None:
            signature = options_signature(
                options if options is not None else plan.config,
                plan.n_devices, transpose=plan.transpose)
        bs, part = plan.bs, plan.part
        meta = {
            "format": FORMAT, "version": VERSION,
            "pattern": pattern, "signature": signature,
            "n": int(bs.n), "B": int(bs.B), "nb": int(bs.nb),
            "n_tiles": int(bs.n_tiles),
            "n_devices": int(plan.n_devices), "n_levels": int(plan.n_levels),
            "transpose": bool(plan.transpose),
            "tiles_width": int(plan.tiles.shape[1]),
            "frontier_caps": [int(v) for v in plan.frontier_caps],
            "buckets": [[int(v) for v in b] for b in plan.buckets],
            "has_step_off": plan.step_off is not None,
            "config": dataclasses.asdict(plan.config),
            "partition": {"strategy": part.strategy,
                          "tasks_per_device": int(part.tasks_per_device)},
        }
        arrays = {f"bs_{k}": np.asarray(getattr(bs, k)) for k in _BS_ARRAYS}
        arrays.update({f"part_{k}": np.asarray(getattr(part, k))
                       for k in _PART_ARRAYS})
        arrays.update({k: np.asarray(getattr(plan, k)) for k in _PLAN_ARRAYS})
        if plan.step_off is not None:
            arrays["step_off"] = np.asarray(plan.step_off)
        path = self.path_for(pattern, signature)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, meta=np.array(json.dumps(meta, sort_keys=True)),
                         **arrays)
            os.replace(tmp, path)  # atomic: readers see old or new, never half
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        self._count("saves")
        return path

    # -- load --------------------------------------------------------------

    def load(self, a: CSR, n_devices: int, options=None, *,
             transpose: bool = False, signature: str | None = None
             ) -> Plan | None:
        """Load + hydrate + verify the plan for ``a`` under ``options``.

        Returns ``None`` on a miss *or* on any defect — unreadable file,
        format/version/key mismatch, a kernel backend the port lacks,
        pattern drift, or a :func:`repro_torch.verify.verify_plan` finding
        at the store's level — so callers need exactly one fallback: run the
        fresh analysis.
        """
        from repro_torch.api.context import pattern_key

        if signature is None:
            if options is None:
                raise ValueError("load needs options or an explicit signature")
            signature = options_signature(options, n_devices,
                                          transpose=transpose)
        pattern = pattern_key(a)
        path = self.path_for(pattern, signature)
        if not os.path.exists(path):
            self._count("misses")
            return None
        with get_tracer().span("planstore.load", pattern=pattern,
                               signature=signature) as span:
            try:
                plan = self._read(path, a, pattern, signature, n_devices,
                                  transpose)
            except Exception as e:  # corrupt/stale: fall back, never crash
                self._count("rejected")
                span.set(rejected=True, reason=type(e).__name__)
                return None
        self._count("hits")
        return plan

    def _read(self, path: str, a: CSR, pattern: str, signature: str,
              n_devices: int, transpose: bool) -> Plan:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"][()]))
            if meta.get("format") != FORMAT:
                raise ValueError(f"not a plan file: {meta.get('format')!r}")
            if meta.get("version") != VERSION:
                raise ValueError(f"unsupported plan version {meta.get('version')!r}")
            for key, want in (("pattern", pattern), ("signature", signature),
                              ("n", a.n), ("n_devices", n_devices),
                              ("transpose", transpose)):
                if meta.get(key) != want:
                    raise ValueError(f"stale entry: {key} {meta.get(key)!r} != {want!r}")
            arrs = {k: z[k] for k in z.files if k != "meta"}
        backend = meta["config"].get("kernel_backend")
        if backend is not None and backend not in BACKENDS:
            # e.g. the reference's "pallas": never mapped onto another backend
            raise ValueError(f"stale entry: kernel backend {backend!r} is not one of "
                             f"{BACKENDS}")
        config = SolverConfig(**meta["config"])
        B, nb, m = int(meta["B"]), int(meta["nb"]), int(meta["n_tiles"])
        # values-free skeleton: zero tiles, replaced wholesale by the refresh
        # below (bit-identical to a fresh build on the same matrix)
        bs = BlockStructure(
            n=int(meta["n"]), B=B, nb=nb,
            diag=np.zeros((nb, B, B), np.float32),
            off_rows=arrs["bs_off_rows"], off_cols=arrs["bs_off_cols"],
            off_tiles=np.zeros((m, B, B), np.float32),
            block_level=arrs["bs_block_level"],
            block_indeg=arrs["bs_block_indeg"],
        )
        part = Partition(
            n_devices=n_devices, strategy=meta["partition"]["strategy"],
            tasks_per_device=int(meta["partition"]["tasks_per_device"]),
            owner=arrs["part_owner"], boundary=arrs["part_boundary"],
        )
        D, ML1 = n_devices, int(meta["tiles_width"])
        skeleton = Plan(
            bs=bs, part=part, config=config, n_devices=D,
            n_levels=int(meta["n_levels"]),
            diag=np.zeros((nb + 1, B, B), np.float32),
            owner=np.concatenate([part.owner, [-1]]).astype(np.int32),
            indeg=arrs["indeg"], ex_rows=arrs["ex_rows"],
            ex_boundary=arrs["ex_boundary"], lvl_off=arrs["lvl_off"],
            lvl_bucket=arrs["lvl_bucket"],
            buckets=tuple(tuple(int(v) for v in b) for b in meta["buckets"]),
            solve_rows=arrs["solve_rows"], upd_tiles=arrs["upd_tiles"],
            local_rows=arrs["local_rows"], tile_row=arrs["tile_row"],
            tile_col=arrs["tile_col"],
            tiles=np.zeros((D, ML1, B, B), np.float32),
            transpose=transpose,
            frontier_caps=tuple(int(v) for v in meta["frontier_caps"]),
            step_off=arrs.get("step_off") if meta.get("has_step_off") else None,
        )
        # hydrate numeric values through the factorize path: validates the
        # block pattern against `a` and rebuilds diag/tiles bit-identically
        plan = refresh_plan(skeleton, a)
        from repro_torch.verify import verify_plan

        verify_plan(plan, level=self.verify).raise_if_failed()
        return plan
