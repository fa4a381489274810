"""The streamed megakernel at B > 169 on the CPU, where two stages of one
whole tile do not fit a Hopper CTA and the kernel copies each tile in row
chunks (``kernels/superstep.py::streamed_shape``).

The problems are ``strategies.dyadic(random_triangular(n=3B, m=8B),
seed=5)`` at B = 170, 176, 203 and 256 (three block rows; 203 is odd): on
these dyadic twins every intermediate is exact, so the reference's
executors agree bit for bit (checked first) and the port's
``kernel_backend="fused_streamed"`` is held to their bits, forward,
transpose and on a 3-column panel. The reference's own ``fused_streamed``
does not run on the installed jax; its contract makes it bit-equal to its
``fused`` (``tests/test_superstep.py``), which runs here in interpret mode.
Besides: the chunk rule against the mirror in ``tests/torch_parity.py``,
``dispatch_stats``, strict verification, probed ``"auto"``, and one
two-rank ``comm="zerocopy"`` solve on forked gloo ranks against the
reference's two-device ``fused`` run (both sides in processes of their
own, started together).
"""
from __future__ import annotations

import functools
import os
import sys
import textwrap

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import strategies
from torch_parity import (
    RANK_TIMEOUT, SHARED_LIMIT, assert_dispatch_stats_match, port_config, rank_results,
    stream_chunk_bytes, stream_chunk_rows, stream_chunk_shared_bytes, stream_chunk_warps,
    to_torch_csr,
)
from repro.core import DistributedSolver, SolverConfig, build_plan
from repro.core import solver as jsolver
from repro.sparse.matrix import reference_solve, to_scipy
from repro_torch.api import PlanOptions, SpTRSVContext
from repro_torch.core import solver as tsolver
from repro_torch.kernels import superstep as tss
from repro_torch.sparse import suite as tsuite
from repro_torch.verify import verify_plan

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WIDE_B = (170, 176, 203, 256)
FORMS = ("forward", "transpose", "panel")
D2_B = 176  # the two-rank run's block size


@functools.lru_cache(maxsize=None)
def _problem(B: int):
    a = strategies.dyadic(strategies.random_triangular(n=3 * B, m=8 * B), seed=5)
    b = strategies.dyadic_rhs(a.n)
    panel = np.stack([strategies.dyadic_rhs(a.n, seed=s) for s in (1, 2, 3)], axis=1)
    return a, b, panel


def _exact(a, rhs, transpose: bool) -> np.ndarray:
    """scipy's float64 solve, which is exact on the dyadic twin."""
    L = to_scipy(a)
    if transpose:
        return spla.spsolve_triangular(L.T.tocsr(), rhs, lower=False)
    return reference_solve(a, rhs)


@functools.lru_cache(maxsize=None)
def _reference(B: int, transpose: bool, kernel: str) -> dict:
    """The reference's solves of the three forms with one plan."""
    a, b, panel = _problem(B)
    plan = build_plan(a, 1, SolverConfig(block_size=B, kernel_backend=kernel),
                      transpose=transpose)
    solver = DistributedSolver(plan, strategies.mesh1())
    rhs = {"forward": b, "panel": panel} if not transpose else {"transpose": b}
    return {form: np.asarray(solver.solve(v)) for form, v in rhs.items()}


@pytest.mark.parametrize("B", WIDE_B)
def test_reference_executors_agree_on_the_twin(B):
    """The twin is exact: the reference's fused megakernel (interpret mode)
    and its switch executor give scipy's float64 solution, every form."""
    a, b, panel = _problem(B)
    for transpose in (False, True):
        fused, switch = (_reference(B, transpose, k) for k in ("fused", "reference"))
        for form, x in fused.items():
            want = _exact(a, panel if form == "panel" else b, transpose)
            np.testing.assert_array_equal(x, want.astype(np.float32), err_msg=form)
            np.testing.assert_array_equal(switch[form], x, err_msg=form)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("B", WIDE_B)
def test_fused_streamed_bit_identical_to_the_reference(B, form):
    """The port's ``fused_streamed`` Solver takes the chunked shape (one
    CTA of W warps an item, sharing two stages of ``rows < B`` tile rows)
    and gives the reference's fused bits."""
    a, b, panel = _problem(B)
    transpose = form == "transpose"
    plan = tsolver.build_plan(to_torch_csr(a), 1, tsolver.SolverConfig(
        block_size=B, kernel_backend="fused_streamed"), transpose=transpose)
    solver = tsolver.Solver(plan, "cpu")
    layout = solver._fused.layout
    assert layout is not None
    assert tss.streamed_shape(B, layout.max_item_tiles) == (
        stream_chunk_warps(B), 1, stream_chunk_rows(B))
    x = solver.solve(panel if form == "panel" else b)
    np.testing.assert_array_equal(x, _reference(B, transpose, "fused")[form])


def test_chunk_rule_against_the_mirror_at_every_block_size():
    """At every B < 1056: the CTA fits ``SHARED_LIMIT``; from B = 170 the
    CTA has the mirror's W warps, its stage holds the mirror's ``rows`` (a
    multiple of four) and the chunks of an entry start and end on 16-byte
    boundaries, fit a stage and cover the entry once; below 170 whole
    tiles. B = 1056 is refused."""
    for B in range(1, 1056):
        warps, cap, rows = tss.streamed_shape(B, 1)
        assert tss.streamed_shared_bytes(B, 1) <= SHARED_LIMIT, B
        tss.check_streamed_fits(B)
        if B < 170:
            assert rows == B and tss.stream_chunks(B, rows) == [(0, tss.stream_tile_floats(B))]
            continue
        assert (warps, cap, rows) == (stream_chunk_warps(B), 1, stream_chunk_rows(B)), B
        chunks = [(4 * f, 4 * t) for f, t in tss.stream_chunks(B, rows)]
        assert chunks == stream_chunk_bytes(B), B
        stage = 4 * tss.stage_floats(B, cap, rows)
        assert all(f % 16 == 0 and t % 16 == 0 and 0 < t - f <= stage for f, t in chunks), B
        assert chunks[-1][1] == 4 * tss.stream_tile_floats(B)
    with pytest.raises(ValueError, match="block size B=1056"):
        tss.check_streamed_fits(1056)


@pytest.mark.parametrize("kernel", ["fused", "fused_streamed"])
@pytest.mark.parametrize("B", WIDE_B)
def test_dispatch_stats_match_the_reference(B, kernel):
    """Every key the reference's, but the three of the port's Hopper rule,
    which follow the chunk rule (``fused_vmem_bytes`` one CTA's two stages
    of ``rows`` tile rows, shared by its W warps; ``stream_dma_bytes``
    whole entries)."""
    a = _problem(B)[0]
    cfg = SolverConfig(block_size=B, kernel_backend=kernel)
    for transpose in (False, True):
        ref = build_plan(a, 1, cfg, transpose=transpose)
        port = tsolver.build_plan(to_torch_csr(a), 1, port_config(cfg), transpose=transpose)
        stats = tsolver.dispatch_stats(port)
        assert_dispatch_stats_match(jsolver.dispatch_stats(ref), ref, stats)
        assert stats["streamed"]
        widest = max(layout.max_item_tiles for layout in tsolver.fused_layouts(port))
        assert tss.streamed_shape(B, widest) == (stream_chunk_warps(B), 1, stream_chunk_rows(B))
        assert stats["fused_vmem_bytes"] == tsolver.fused_vmem_bytes(port, streamed=True) == (
            stream_chunk_shared_bytes(B))


def test_cta_rule_at_every_chunked_block_size():
    """From B = 170 to 1055: one CTA of W = min(8, ceil(B / 32)) warps an
    item, at most one chunk row a thread (so at most one sweep block a
    warp); one pair of stages and one set of columns, not one a warp,
    within ``SHARED_LIMIT``; ``rows`` a multiple of four, as few chunks a
    tile as any ``rows`` that fits allows, evened out; the bulk copies of
    an entry 16-byte aligned, each fitting a stage, covering the entry
    once."""
    for B in range(170, 1056):
        warps, cap, rows = tss.streamed_shape(B, 5)
        assert (warps, cap) == (stream_chunk_warps(B), 1) and warps == tss.chunk_warps(B), B
        assert rows % 4 == 0 and 0 < rows < B and rows <= 32 * warps, B
        shared = tss.streamed_shared_bytes(B, 5)
        assert shared == stream_chunk_shared_bytes(B, rows) <= SHARED_LIMIT, B
        most = (SHARED_LIMIT - 16 - 12 * B) // (8 * (B + 1)) // 4 * 4  # the most rows that fit
        n = -(-B // rows)
        assert rows <= most and (n - 1) * most < B and rows - 4 < -(-B // n), B
        chunks = tss.stream_chunks(B, rows)
        assert chunks[0][0] == 0 and chunks[-1][1] == tss.stream_tile_floats(B), B
        assert all(t0 == f1 for (_, t0), (f1, _) in zip(chunks, chunks[1:])), B
        assert all(f % 4 == 0 and t % 4 == 0 and 0 < t - f <= rows * (B + 1)
                   for f, t in chunks), B


@pytest.mark.parametrize("B", (176, 203))
def test_strict_verify_clean_on_a_levelled_plan(B):
    """Strict verification, ``kc.scratch.shape`` with the CTA rule among its
    rules, is clean on a real-valued levelled plan in row chunks, both
    fused backends, forward and transpose."""
    a = tsuite.random_levelled(5 * B, 4, 3.0, seed=B)
    for kernel in ("fused", "fused_streamed"):
        for transpose in (False, True):
            plan = tsolver.build_plan(a, 1, tsolver.SolverConfig(
                block_size=B, kernel_backend=kernel), transpose=transpose)
            report = verify_plan(plan, level="strict")
            assert report.passed, [str(f) for f in report.findings]
            assert "kc.scratch.shape" in report.rules_checked
            assert tsolver.fused_vmem_bytes(plan, streamed=True) == stream_chunk_shared_bytes(B)


@pytest.mark.parametrize("B", WIDE_B)
def test_strict_verify_clean(B):
    a = to_torch_csr(_problem(B)[0])
    for kernel in ("fused", "fused_streamed"):
        report = verify_plan(tsolver.build_plan(a, 1, tsolver.SolverConfig(
            block_size=B, kernel_backend=kernel)), level="strict")
        assert report.passed, [str(f) for f in report.findings]
        assert {"kc.scratch.shape", "kc.stream.bytes"} <= set(report.rules_checked)


def test_probed_auto_resolves_at_b176():
    """Probed ``"auto"`` builds and probes the streamed candidates at B =
    176 (plain ``fused`` streams there by the port's rule, so it stands for
    both) and resolves; its solve gives the twin's exact solution."""
    from repro_torch.obs import calibration as cal

    a, b, _ = _problem(176)
    cal.set_store(cal.CalibrationStore())
    try:
        ctx = SpTRSVContext(device="cpu", options=PlanOptions(block_size=176, kernel="auto",
                                                              probe_solves=1))
        h = ctx.analyse(to_torch_csr(a))
        d = h.auto
        assert d.mode == "probed" and d.chosen == min(d.probe_us, key=d.probe_us.get)
        assert ("levelset", "zerocopy", "fused") in d.probe_us
        np.testing.assert_array_equal(ctx.solve(h, b), _exact(a, b, False).astype(np.float32))
    finally:
        cal.set_store(None)


# ---------------------------------------------------------------------------
# two ranks, comm="zerocopy": the port on forked gloo ranks, the reference on
# a two-device mesh, each in a process of its own
# ---------------------------------------------------------------------------

REFERENCE = textwrap.dedent("""
    import sys
    import numpy as np, jax
    from repro import compat
    from repro.core import DistributedSolver, SolverConfig, build_plan
    from repro.sparse.matrix import CSR
    inputs, out = sys.argv[1], sys.argv[2]
    data = np.load(inputs)
    mesh = compat.make_mesh((2,), ("x",), devices=jax.devices()[:2])
    a = CSR(n=int(data["n"]), row_ptr=data["row_ptr"], col_idx=data["col_idx"],
            val=data["val"])
    cfg = SolverConfig(block_size=int(data["B"]), comm="zerocopy", kernel_backend="fused")
    np.savez(out, x=DistributedSolver(build_plan(a, 2, cfg), mesh).solve(data["b"]))
""")

PORT = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    import repro_torch.api, repro_torch.verify
    from torch_parity import RankRecorder, fork_ranks

    def rank(r, D, inputs, out):
        import torch.distributed as dist
        from repro_torch.api import PlanOptions, SpTRSVContext
        from repro_torch.sparse.matrix import CSR

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method="file://" + os.path.join(out, "rdv"),
                                rank=r, world_size=D)
        data = np.load(inputs)
        a = CSR(n=int(data["n"]), row_ptr=data["row_ptr"], col_idx=data["col_idx"],
                val=data["val"])
        ctx = SpTRSVContext(device="cpu", group=dist.group.WORLD, options=PlanOptions(
            block_size=int(data["B"]), comm="zerocopy", kernel="fused_streamed"))
        rec = RankRecorder()
        rec.solve(ctx, ctx.analyse(a), data["b"], "x")
        rec.save(out, r)
        dist.barrier()
        dist.destroy_process_group()

    fork_ranks(rank, 2, tuple(sys.argv[1:3]))
""")


@pytest.fixture(scope="module", autouse=True)
def two_ranks(tmp_path_factory):
    """Start both sides when the module starts, so they run beside its other
    tests; the fixture's value waits for them and returns the reference's
    ``x`` and each rank's results."""
    import subprocess

    tmp = tmp_path_factory.mktemp("streamed_wide")
    a, b, _ = _problem(D2_B)
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, n=a.n, row_ptr=a.row_ptr, col_idx=a.col_idx, val=a.val, b=b, B=D2_B)
    (tmp / "port").mkdir()
    path = os.pathsep.join([SRC, HERE, os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")
    commands = {
        "reference": ([sys.executable, "-c", REFERENCE, inputs, str(tmp / "reference.npz")],
                      {"JAX_PLATFORMS": "cpu",
                       "XLA_FLAGS": "--xla_force_host_platform_device_count=2"}),
        "port": ([sys.executable, "-c", PORT, inputs, str(tmp / "port")], {})}
    procs = {name: subprocess.Popen(argv, env=dict(env, **extra), stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, (argv, extra) in commands.items()}

    @functools.lru_cache(maxsize=None)
    def results():
        for name, p in procs.items():
            log, _ = p.communicate(timeout=RANK_TIMEOUT)
            assert p.returncode == 0, f"{name} run failed:\n{log[-3000:]}"
        return np.load(tmp / "reference.npz")["x"], rank_results(str(tmp / "port"), 2)

    yield results
    for p in procs.values():
        p.kill()
        p.wait()


def test_two_ranks_zerocopy_fused_streamed_bit_identical_to_the_reference(two_ranks):
    """Each rank's ``x`` is the reference's two-device ``fused`` solve bit
    for bit, with the split launches and exchanges ``dispatch_stats`` says,
    every one in the streamed form, and a strict-clean plan."""
    want, ranks = two_ranks()
    a, b, _ = _problem(D2_B)
    np.testing.assert_array_equal(want, _exact(a, b, False).astype(np.float32))
    for r, (xs, report) in enumerate(ranks):
        np.testing.assert_array_equal(xs["x"], want, err_msg=f"rank {r}")
        c = report["x"]
        assert c["verified"] and c["whole"] == 0, c
        assert c["split"] == c["streamed"] == c["want_launches"] > 0, c
        assert c["exchanges"] == c["want_exchanges"] > 0, c
