"""Helpers for the PyTorch port's parity tests (``tests/test_torch_*.py``).

The JAX package is the reference: the same inputs, made with numpy, go
through both packages and the results are compared as numpy arrays — plans
byte for byte, solves bit for bit on the dyadic suites and by tolerance
otherwise.
"""
from __future__ import annotations

import dataclasses

import numpy as np

import repro_torch.core.solver as tsolver
import repro_torch.sparse.matrix as tmatrix

# the port's SolverConfig fields (the reference has more, e.g. verify)
PORT_CONFIG_FIELDS = tuple(f.name for f in dataclasses.fields(tsolver.SolverConfig))
PLAN_ARRAYS = ("diag", "owner", "indeg", "ex_rows", "ex_boundary", "lvl_off",
               "lvl_bucket", "solve_rows", "upd_tiles", "local_rows", "tile_row",
               "tile_col", "tiles")
PLAN_SCALARS = ("n_devices", "n_levels", "buckets", "transpose", "frontier_caps")
BS_FIELDS = ("n", "B", "nb", "diag", "off_rows", "off_cols", "off_tiles",
             "block_level", "block_indeg")
PART_FIELDS = ("n_devices", "strategy", "tasks_per_device", "owner", "boundary")


def to_torch_csr(a) -> tmatrix.CSR:
    """The reference's CSR as the port's (copied arrays)."""
    return tmatrix.CSR(n=a.n, row_ptr=a.row_ptr.copy(), col_idx=a.col_idx.copy(),
                       val=a.val.copy())


def port_config(cfg, **overrides) -> tsolver.SolverConfig:
    """The port's SolverConfig with the same values as a reference config."""
    kw = {name: getattr(cfg, name) for name in PORT_CONFIG_FIELDS}
    kw.update(overrides)
    return tsolver.SolverConfig(**kw)


def flatten_plan(plan) -> dict:
    """A reference ``Plan`` as the plain dict ``plan_from_arrays`` takes."""
    out = {name: getattr(plan, name) for name in PLAN_ARRAYS + PLAN_SCALARS}
    out["step_off"] = plan.step_off
    out.update({f"bs.{k}": getattr(plan.bs, k) for k in BS_FIELDS})
    out.update({f"part.{k}": getattr(plan.part, k) for k in PART_FIELDS})
    out.update({f"config.{k}": getattr(plan.config, k) for k in PORT_CONFIG_FIELDS})
    return out


def assert_arrays_identical(a, b, what: str) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} != {b.dtype}"
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    assert np.array_equal(a, b), f"{what}: values differ"


def assert_plans_identical(ref_plan, port_plan) -> None:
    """Every array of the Plan, its BlockStructure and Partition is
    byte-identical (same dtype, shape and values); scalars are equal."""
    for name in PLAN_ARRAYS:
        assert_arrays_identical(getattr(ref_plan, name), getattr(port_plan, name), name)
    for name in PLAN_SCALARS:
        assert getattr(ref_plan, name) == getattr(port_plan, name), name
    if ref_plan.step_off is None:
        assert port_plan.step_off is None
    else:
        assert_arrays_identical(ref_plan.step_off, port_plan.step_off, "step_off")
    for name in BS_FIELDS:
        assert_arrays_identical(getattr(ref_plan.bs, name), getattr(port_plan.bs, name),
                                f"bs.{name}")
    for name in PART_FIELDS:
        assert_arrays_identical(getattr(ref_plan.part, name),
                                getattr(port_plan.part, name), f"part.{name}")


# dispatch_stats keys that follow the port's rule for the fused executor's
# on-chip plan (core/solver.py) instead of the reference's TPU VMEM budget:
# "streamed" is true for kernel_backend="fused_streamed", and for "fused"
# when the resident store (diag + tiles bytes) exceeds the port's stream
# limit (measured on the card; 0 unless REPRO_TORCH_STREAM_LIMIT or paired
# calibration samples set it), at every block size;
# "fused_vmem_bytes" is the megakernel's dynamic shared memory per CTA and
# "stream_dma_bytes" the bytes the streamed kernel copies per vector solve
HOPPER_FUSED_KEYS = ("streamed", "fused_vmem_bytes", "stream_dma_bytes")
SHARED_LIMIT = 232_448  # bytes of dynamic shared memory one Hopper block may use

# Other deliberate differences of the port, pinned by the tests that name them:
# - environment variables: REPRO_TORCH_TRACE, REPRO_TORCH_CALIBRATION and
#   REPRO_TORCH_STREAM_LIMIT (the reference reads REPRO_TRACE,
#   REPRO_CALIBRATION and REPRO_STREAM_VMEM_LIMIT), so one process holding
#   both packages never switches on both (test_torch_obs.py);
# - calibration store keys and probe signatures carry the device type
#   ("cuda:fused/B32", "cpu:levelset/..."): CPU samples time the plain
#   versions and never mix with the card's (test_torch_obs.py,
#   test_torch_autotune.py);
# - "fused" streams by the port's measured rule above, where the reference's
#   streams above 8 MiB of VMEM;
# - the auto-tuner's INTERPRET_PENALTY applies where the port runs a
#   megakernel's plain version (fused levelset/dagpart on the CPU), where the
#   reference applies it in Pallas interpret mode (test_torch_autotune.py);
# - the verifier's switch is REPRO_TORCH_VERIFY (the reference reads
#   REPRO_VERIFY) (test_torch_verify.py);
# - the verifier's kc.stream.slices, kc.stream.bytes, kc.scratch.shape and
#   kc.carry.donation check the port's Hopper contracts (the streamed
#   layout's work items, the bytes the streamed kernel copies per column,
#   the shared memory a launch requests, the wrappers' fresh outputs) where
#   the reference's check its TPU kernel's level-slice DMA bursts, VMEM
#   scratch and input_output_aliases; they keep the reference's ids and fire
#   on the same mutations of the plan (test_torch_verify.py);
# - the verifier has one rule the reference lacks, kc.pull.wait (the
#   resident kernel's pull table waits exactly on rows the launch solves),
#   run after the streaming rules: PORT_ONLY_RULES (test_torch_verify.py);
# - SpTRSVContext, SolveEngine and the CLIs take device= (the card unless
#   "cpu"), where the reference's take mesh=; the engine launches on one CUDA
#   stream of its own choosing (test_torch_service.py, test_torch_cuda.py).
PORT_ONLY_RULES = ("kc.pull.wait",)


def hopper_fused_stats(ref_plan) -> dict:
    """The three keys by the port's rule, derived here from the reference's
    plan (not through the port's layout builder).

    Streamed, each device's work items are its solved rows (incoming tiles
    stored on the device, then the diagonal tile) and the rows it updates
    but does not solve (incoming tiles only). Store entries are tiles with
    rows padded to B + 1 floats, then to a multiple of four; each warp
    double-buffers its widest item when 8, 4, 2 or 1 warps of them fit the
    shared memory, besides two mbarriers and three B-float columns; where
    not even one warp's two stages of one tile fit, one CTA of
    :func:`stream_chunk_warps` warps runs each item, the warps sharing two
    stages of :func:`stream_chunk_rows` padded tile rows and one set of
    columns (:func:`stream_chunk_shared_bytes`).
    """
    B = ref_plan.bs.B
    entry = 4 * (-(-B * (B + 1) // 4) * 4)

    def size(warps, cap):
        return warps * (16 + 2 * cap * entry + 12 * B)

    kernel = ref_plan.config.kernel_backend
    streamed = ref_plan.config.sched in ("levelset", "dagpart") and (
        kernel == "fused_streamed"
        or (kernel == "fused"
            and ref_plan.diag.nbytes + ref_plan.tiles.nbytes > tsolver.stream_limit()))
    if not streamed:
        # 8 warps, each with a ring of three 1056-float prefetch stages and
        # three B-float columns (the row's sum and two source columns)
        return {"streamed": False, "stream_dma_bytes": 0,
                "fused_vmem_bytes": 4 * 8 * (3 * 33 * 32 + 3 * B)}
    nb = ref_plan.bs.nb
    widest, copied = 0, 0
    for d in range(ref_plan.n_devices):
        solved = ref_plan.solve_rows[d][ref_plan.solve_rows[d] >= 0]
        dest = ref_plan.tile_row[d][ref_plan.tile_row[d] != nb]
        items = np.bincount(dest, minlength=nb + 1)
        items[solved] += 1
        widest = max(widest, int(items.max()))
        copied = max(copied, int(items.sum()))

    need = max(1, widest)
    fits = [w for w in (8, 4, 2, 1) if size(w, need) <= SHARED_LIMIT]
    if fits:
        vmem = size(fits[0], need)
    elif size(1, 1) <= SHARED_LIMIT:
        vmem = size(1, min(need, (SHARED_LIMIT - size(1, 0)) // (2 * entry)))
    else:
        vmem = stream_chunk_shared_bytes(B)
    return {"streamed": True, "fused_vmem_bytes": vmem,
            "stream_dma_bytes": copied * entry if ref_plan.n_levels else 0}


def stream_chunk_warps(B: int) -> int:
    """Warps of the CTA that runs each work item of the streamed kernel in
    row chunks: one per 32 tile rows, at most eight."""
    return min(8, (B + 31) // 32)


def stream_chunk_rows(B: int) -> int:
    """Padded tile rows (B + 1 floats each) of one stage of the streamed
    kernel in row chunks: the fewest chunks of at most the largest multiple
    of four rows whose two stages, two mbarriers and three B-float columns
    (one set for the whole CTA) fit the shared memory, each chunk
    ``ceil(B / chunks)`` rows rounded up to a multiple of four."""
    most = 0
    while stream_chunk_shared_bytes(B, most + 4) <= SHARED_LIMIT:
        most += 4
    chunks = -(-B // most)
    return -(-(-(-B // chunks)) // 4) * 4


def stream_chunk_shared_bytes(B: int, rows: int | None = None) -> int:
    """Shared memory of one CTA of the streamed kernel in row chunks: two
    8-byte mbarriers, two stages of ``rows`` padded tile rows and three
    B-float columns."""
    rows = stream_chunk_rows(B) if rows is None else rows
    return 16 + 2 * 4 * rows * (B + 1) + 12 * B


def stream_chunk_bytes(B: int) -> list:
    """Byte ranges of the bulk copies of one store entry at a B whose tile
    is copied in row chunks: ``rows`` padded rows at a time from the
    entry's start, the last chunk to the entry's padded end."""
    rows, end = stream_chunk_rows(B), 4 * (-(-B * (B + 1) // 4) * 4)
    return [(4 * i0 * (B + 1), 4 * (i0 + rows) * (B + 1) if i0 + rows < B else end)
            for i0 in range(0, B, rows)]


def assert_dispatch_stats_match(ref_stats: dict, ref_plan, port_stats: dict) -> None:
    """Every key equals the reference's but the three of
    :data:`HOPPER_FUSED_KEYS`, which equal :func:`hopper_fused_stats`."""
    assert set(port_stats) == set(ref_stats)
    for key, want in ref_stats.items():
        if key not in HOPPER_FUSED_KEYS:
            assert port_stats[key] == want, key
    assert {k: port_stats[k] for k in HOPPER_FUSED_KEYS} == hopper_fused_stats(ref_plan)


# ---------------------------------------------------------------------------
# multi-device runs: the reference on a mesh of forced host devices, the port
# on D forked gloo ranks (tests/test_torch_unified.py, test_torch_zerocopy.py)
# ---------------------------------------------------------------------------

# the megakernel wrappers a multi-device solve may launch
SUPERSTEP_WRAPPERS = ("superstep_call", "superstep_streamed_call", "superstep_split_",
                      "superstep_streamed_split_")
RANK_TIMEOUT = 600  # seconds a side may take


def multi_device_inputs(path: str, B: int) -> dict:
    """The problems both sides solve, written to ``path`` (one ``.npz``);
    returns them as ``{key: (reference CSR, b)}``: the dyadic suites of
    ``tests/strategies.py`` with a two-column panel (``banded``,
    ``skewed``), new dyadic values on ``skewed``'s pattern for a refresh
    (``skewed_new``), a real-valued problem (``real``) and eight copies of
    one two-block matrix, which a contiguous partition of four or eight
    devices cuts nowhere (``uncut``)."""
    import scipy.sparse as sp

    import strategies
    from repro.sparse.matrix import CSR

    data, probs = {}, {}

    def put(key, a, b, panel=None):
        probs[key] = (a, b)
        data.update({f"{key}/n": a.n, f"{key}/row_ptr": a.row_ptr,
                     f"{key}/col_idx": a.col_idx, f"{key}/val": a.val, f"{key}/b": b})
        if panel is not None:
            data[f"{key}/panel"] = panel

    for m in ("banded", "skewed"):
        a = strategies.EXACT_MATRICES[m]()
        b = strategies.dyadic_rhs(a.n)
        put(m, a, b, np.stack([b, strategies.dyadic_rhs(a.n, seed=2)], axis=1))
    skewed = probs["skewed"][0]
    put("skewed_new", strategies.dyadic(skewed, seed=1), probs["skewed"][1])
    real = strategies.SOLVER_MATRICES["levelled"]()
    put("real", real, np.random.default_rng(1).uniform(-1, 1, real.n).astype(np.float32))
    one = strategies.dyadic(strategies.random_triangular(n=2 * B, seed=3, m=40))
    L = sp.block_diag([sp.csr_matrix((one.val, one.col_idx, one.row_ptr))] * 8, format="csr")
    L.sort_indices()
    uncut = CSR(n=L.shape[0], row_ptr=L.indptr.astype(np.int64),
                col_idx=L.indices.astype(np.int32), val=L.data.astype(np.float32))
    put("uncut", uncut, strategies.dyadic_rhs(uncut.n, seed=5))
    np.savez(path, **data)
    return probs


def read_csr(data, key: str) -> tmatrix.CSR:
    """Problem ``key`` of :func:`multi_device_inputs`' file as the port's CSR."""
    return tmatrix.CSR(n=int(data[key + "/n"]), row_ptr=data[key + "/row_ptr"],
                       col_idx=data[key + "/col_idx"], val=data[key + "/val"])


def count_calls(module, names, calls: dict) -> None:
    """Wrap each function ``names`` of ``module`` so that every call adds one
    to ``calls[name]``."""
    for name in names:
        fn = getattr(module, name)

        def wrapper(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kwargs)
        setattr(module, name, wrapper)


def fork_ranks(target, D: int, args: tuple) -> None:
    """Fork ``D`` processes running ``target(rank, D, *args)`` (what the
    caller imported is shared) and wait for them; exits non-zero if one
    fails."""
    import multiprocessing
    import sys

    fork = multiprocessing.get_context("fork")
    procs = [fork.Process(target=target, args=(r, D) + tuple(args)) for r in range(D)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(RANK_TIMEOUT)
    codes = [p.exitcode for p in procs]
    if codes != [0] * D:
        for p in procs:
            p.kill()
        sys.exit(f"ranks exited {codes}")


def run_together(commands: dict, env: dict) -> None:
    """Start every ``{name: (argv, extra env)}`` command at once and wait
    for all; each must exit 0."""
    import subprocess

    procs = {name: subprocess.Popen(argv, env=dict(env, **extra), stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, (argv, extra) in commands.items()}
    for name, p in procs.items():
        log, _ = p.communicate(timeout=RANK_TIMEOUT)
        assert p.returncode == 0, f"{name} run failed:\n{log[-3000:]}"


def rank_results(out, D: int) -> list:
    """Each rank's ``(xs, report)`` as the ranks wrote them to ``out``."""
    import json
    import os

    return [(dict(np.load(os.path.join(out, f"rank{r}.npz"))),
             json.load(open(os.path.join(out, f"rank{r}.json")))) for r in range(D)]


class RankRecorder:
    """One rank's solves in a multi-device parity run: each ``x`` under its
    tag, and beside it the solve's exchanges, ``all_reduce`` calls and
    megakernel launches (counted by :func:`count_calls` on
    :data:`SUPERSTEP_WRAPPERS`), what ``dispatch_stats`` predicts, the
    syncfree sweeps, and whether its plan verifies strict."""

    def __init__(self):
        from repro_torch.kernels import superstep

        self.calls, self.xs, self.report, self._verified = {}, {}, {}, {}
        count_calls(superstep, SUPERSTEP_WRAPPERS, self.calls)

    def solve(self, ctx, h, rhs, tag: str, transpose: bool = False) -> None:
        from repro_torch.core import comm
        from repro_torch.verify import verify_plan

        self.calls.clear()
        before = comm.all_reduce_sum_.calls
        x = ctx.solve(h, rhs, transpose=transpose)
        solver = ctx.executor(h, transpose=transpose)
        plan = solver.plan
        stats = tsolver.dispatch_stats(plan)
        if id(plan) not in self._verified:
            self._verified[id(plan)] = verify_plan(plan, "strict").passed
        c = self.calls
        self.xs[tag] = x
        self.report[tag] = {
            "exchanges": solver.exchanges, "want_exchanges": stats["exchanges"],
            "all_reduces": comm.all_reduce_sum_.calls - before,
            "want_launches": stats["fused_launches"],
            "split": c.get("superstep_split_", 0) + c.get("superstep_streamed_split_", 0),
            "whole": c.get("superstep_call", 0) + c.get("superstep_streamed_call", 0),
            "streamed": c.get("superstep_streamed_split_", 0)
            + c.get("superstep_streamed_call", 0),
            "levels": plan.n_levels, "boundary": plan.n_boundary_rows,
            "sweeps": None if solver._syncfree is None else solver._syncfree.sweeps,
            "verified": self._verified[id(plan)]}

    def ranges(self, ctx, h, b) -> dict:
        """The ``record_function`` ranges one solve enters, untraced and
        traced, with the plan's supersteps."""
        import torch

        from repro_torch.obs import trace

        names, real = [], torch.profiler.record_function

        def counted(name, *args, **kwargs):
            names.append(name)
            return real(name, *args, **kwargs)

        torch.profiler.record_function = counted
        try:
            ctx.solve(h, b)
            off = list(names)
            with trace.trace_to():
                ctx.solve(h, b)
        finally:
            torch.profiler.record_function = real
        return {"off": off, "on": {n: names.count(n) for n in set(names)},
                "supersteps": ctx.plan(h).n_supersteps}

    def save(self, out: str, rank: int) -> None:
        import json
        import os

        np.savez(os.path.join(out, f"rank{rank}.npz"), **self.xs)
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(self.report, f)
