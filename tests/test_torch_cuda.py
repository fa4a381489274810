"""The port on the card: each CUDA kernel against its plain version, and the
executor's solves against the same solves on the CPU.

Every test here needs a CUDA device and skips without one; on the GPU
machine run ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
This file imports neither jax nor the reference package (the GPU machine has
no jax): the CPU tests prove the port's CPU solves bit-identical to the
reference on the dyadic suites, so bit-identity to the CPU here carries over.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import PlanOptions, SpTRSVContext
from repro_torch.core.solver import ENV_STREAM_LIMIT
from repro_torch.kernels import ops, ref
from repro_torch.krylov import solve_ic0_pcg, spd_lower_from_triangular
from repro_torch.sparse import suite
from repro_torch.sparse.matrix import CSR, reference_solve

pytestmark = pytest.mark.cuda

TOL = dict(rtol=2e-5, atol=2e-5)  # float32, different summation orders
PER_OP_KERNELS = ("block_trsv", "block_trsm", "block_gemv", "block_gemm")
MEGAKERNELS = ("superstep", "superstep_streamed")


@pytest.fixture(autouse=True)
def _resident_fused(monkeypatch):
    """``kernel_backend="fused"`` in this file means the resident megakernel.
    The port's rule (``core.solver.fused_streaming``) streams a plan whose
    resident store exceeds the stream limit, measured to be 0 on the card;
    the limit is raised above every plan here, so "fused" stays resident
    (the tests of the rule itself unset it)."""
    monkeypatch.setenv(ENV_STREAM_LIMIT, str(2**62))


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs; skips on a machine without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m cuda "
                    "tests/test_torch_cuda.py` on the GPU machine")
    return torch.device("cuda")


def _dyadic(a: CSR, seed: int = 0) -> CSR:
    """Same sparsity, unit diagonal, ±2^-k off-diagonals: every intermediate
    of a shallow forward substitution is exact in float32."""
    rows = np.repeat(np.arange(a.n), np.diff(a.row_ptr))
    signs = np.random.default_rng(seed).choice(
        np.array([-0.5, -0.25, 0.25, 0.5], np.float32), size=a.val.shape)
    return CSR(n=a.n, row_ptr=a.row_ptr, col_idx=a.col_idx,
               val=np.where(a.col_idx == rows, 1.0, signs).astype(np.float32))


@pytest.mark.parametrize("name,B,k,R", [
    ("block_trsv", 32, 17, 1), ("block_trsm", 16, 17, 8),
    ("block_gemv", 128, 17, 1), ("block_gemm", 32, 17, 8),
    ("block_trsv_panel", 32, 17, 1), ("block_gemv_grouped", 32, 17, 1),
])
def test_kernel_matches_plain_version(cuda_device, name, B, k, R):
    rng = np.random.default_rng(k)
    solve = name.startswith("block_tr")
    mat = rng.uniform(-1, 1, (k, B, B))
    if solve:
        mat = np.tril(mat, -1) / B + 2 * np.eye(B)
    vec = rng.uniform(-1, 1, (k, B) if R == 1 else (k, B, R))
    m = torch.from_numpy(mat.astype(np.float32)).to(cuda_device)
    v = torch.from_numpy(vec.astype(np.float32)).to(cuda_device)
    fn = ops.KERNELS[name]
    before = fn.launches
    plain = {"block_trsv_panel": ref.block_trsv_panel_ref,
             "block_gemv_grouped": ref.block_gemv_ref}.get(
                 name, ref.block_trsv_ref if solve else ref.block_gemv_ref)
    torch.testing.assert_close(fn(m, v), plain(m, v), **TOL)
    assert fn.launches == before + 1


def _uniform(rng, shape, device):
    return torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).to(device)


@pytest.mark.parametrize("B", [8, 32, 128])
@pytest.mark.parametrize("m,group", [(16, 8), (70, 40)] + [
    (m, group) for m in (13, 64, 1003) for group in (1, 4, 8, 40)])
def test_grouped_gemv_bit_equal_to_gemv(cuda_device, m, group, B):
    """Grouped or not, each tile's product has the same bits; a short last
    group reads nothing past m."""
    rng = np.random.default_rng(m)
    T, x = _uniform(rng, (m, B, B), cuda_device), _uniform(rng, (m, B), cuda_device)
    grouped = ops.KERNELS["block_gemv_grouped"](T, x, group)
    assert torch.equal(grouped, ops.KERNELS["block_gemv"](T, x))


@pytest.mark.parametrize("B,R", [(8, 3), (32, 8), (32, 1), (128, 5), (32, 16), (32, 4),
                                 (32, 12), (64, 8)])
def test_gemm_column_bit_equal_to_gemv(cuda_device, B, R):
    """Column c of a GEMM is summed as the GEMV sums X[..., c] alone, in
    both GEMM kernels (gemm_kernel's tile in registers for B <= 32, with
    scalar and float4 column accesses and a part-filled 8-column block;
    gemm_wide_kernel's 4-column passes and 1-column rest above)."""
    rng = np.random.default_rng(B * R)
    m = 17
    T, X = _uniform(rng, (m, B, B), cuda_device), _uniform(rng, (m, B, R), cuda_device)
    Y = ops.KERNELS["block_gemm"](T, X)
    for c in range(R):
        assert torch.equal(Y[..., c], ops.KERNELS["block_gemv"](T, X[..., c].contiguous())), c


@pytest.mark.parametrize("B,R", [(16, 8), (32, 3), (33, 4), (128, 2)])
def test_gemm_bit_identical_to_plain_version_on_dyadic(cuda_device, B, R):
    """Integer tiles and columns: every partial sum is exact, so the kernel
    and its plain version agree bit for bit whatever their orders."""
    rng = np.random.default_rng(B + R)
    T = torch.from_numpy(rng.integers(-1, 2, (29, B, B)).astype(np.float32)).to(cuda_device)
    X = torch.from_numpy(rng.integers(-3, 4, (29, B, R)).astype(np.float32)).to(cuda_device)
    assert torch.equal(ops.KERNELS["block_gemm"](T, X), ref.block_gemv_ref(T, X))


def _lower(rng, k, B, device):
    """Well-conditioned lower-triangular tiles: a dominant diagonal."""
    mat = np.tril(rng.uniform(-1, 1, (k, B, B)), -1) / B + 2 * np.eye(B)
    return torch.from_numpy(mat.astype(np.float32)).to(device)


@pytest.mark.parametrize("B,R", [(7, 3), (32, 8), (32, 17), (33, 4), (64, 8)])
def test_trsm_column_bit_equal_to_trsv(cuda_device, B, R):
    """Column c of a TRSM is swept as the TRSV sweeps r[..., c] alone, in
    both TRSM kernels (trsm_kernel's registers for B <= 32, with more
    columns than warps at R = 17; trsm_wide_kernel's shared memory above)."""
    rng = np.random.default_rng(B * R)
    L, r = _lower(rng, 29, B, cuda_device), _uniform(rng, (29, B, R), cuda_device)
    x = ops.KERNELS["block_trsm"](L, r)
    for c in range(R):
        assert torch.equal(x[..., c], ops.KERNELS["block_trsv"](L, r[..., c].contiguous())), c


# the bit oracles (ref.gemv_bits_ref, ref.rowsweep_bits_ref) on the host:
# each kernel's summation order emulated one float32 operation at a time
ORACLE_B = (7, 8, 16, 32)
ORACLE_R = (1, 2, 3, 8, 16, 17)


@pytest.mark.parametrize("B", ORACLE_B)
def test_gemv_and_grouped_bit_equal_to_oracle(cuda_device, B):
    rng = np.random.default_rng(B)
    T, x = _uniform(rng, (1003, B, B), cuda_device), _uniform(rng, (1003, B), cuda_device)
    want = ref.gemv_bits_ref(T.cpu(), x.cpu())
    assert torch.equal(ops.KERNELS["block_gemv"](T, x).cpu(), want)
    for group in (1, 4, 8, 40):
        assert torch.equal(ops.KERNELS["block_gemv_grouped"](T, x, group).cpu(), want), group


@pytest.mark.parametrize("B", ORACLE_B)
@pytest.mark.parametrize("R", ORACLE_R)
def test_gemm_columns_bit_equal_to_oracle(cuda_device, B, R):
    rng = np.random.default_rng(B * R)
    T, X = _uniform(rng, (61, B, B), cuda_device), _uniform(rng, (61, B, R), cuda_device)
    assert torch.equal(ops.KERNELS["block_gemm"](T, X).cpu(), ref.gemv_bits_ref(T.cpu(), X.cpu()))


@pytest.mark.parametrize("B", ORACLE_B)
def test_trsv_bit_equal_to_oracle(cuda_device, B):
    rng = np.random.default_rng(B)
    L, r = _lower(rng, 1003, B, cuda_device), _uniform(rng, (1003, B), cuda_device)
    assert torch.equal(ops.KERNELS["block_trsv"](L, r).cpu(),
                       ref.rowsweep_bits_ref(L.cpu(), r.cpu()))


@pytest.mark.parametrize("B", [7, 32])
@pytest.mark.parametrize("k", [1, 32, 4096])
def test_trsv_bit_equal_to_oracle_at_every_batch_size(cuda_device, B, k):
    """trsv_kernel one warp per tile: a batch of one tile, the main path's
    widest level and a wide batch."""
    rng = np.random.default_rng(B * k)
    L, r = _lower(rng, k, B, cuda_device), _uniform(rng, (k, B), cuda_device)
    assert torch.equal(ops.KERNELS["block_trsv"](L, r).cpu(),
                       ref.rowsweep_bits_ref(L.cpu(), r.cpu()))


# ref.panel_bits_ref: (B, P) pairs, P = 3, 6 not powers of two
PANEL_BP = [(8, 4), (16, 8), (24, 3), (24, 6), (32, 1), (32, 8), (32, 32)]


@pytest.mark.parametrize("B,P", PANEL_BP)
@pytest.mark.parametrize("k", [1, 17, 1003])
def test_panel_trsv_bit_equal_to_oracle(cuda_device, B, P, k):
    rng = np.random.default_rng(B * P + k)
    L, r = _lower(rng, k, B, cuda_device), _uniform(rng, (k, B), cuda_device)
    got = ops.KERNELS["block_trsv_panel"](L, r, P)
    assert torch.equal(got.cpu(), ref.panel_bits_ref(L.cpu(), r.cpu(), P))


@pytest.mark.parametrize("B,P", [(64, 8), (64, 16), (48, 3)])
def test_wide_panel_trsv_within_tolerance_of_plain_version(cuda_device, B, P):
    """B > 32 takes trsv_panel_kernel, held to the plain version only."""
    rng = np.random.default_rng(B + P)
    L, r = _lower(rng, 61, B, cuda_device), _uniform(rng, (61, B), cuda_device)
    torch.testing.assert_close(ops.KERNELS["block_trsv_panel"](L, r, P),
                               ref.block_trsv_panel_ref(L, r, P), **TOL)


@pytest.mark.parametrize("B", ORACLE_B)
@pytest.mark.parametrize("R", ORACLE_R)
def test_trsm_columns_bit_equal_to_oracle(cuda_device, B, R):
    rng = np.random.default_rng(B * R)
    L, r = _lower(rng, 61, B, cuda_device), _uniform(rng, (61, B, R), cuda_device)
    assert torch.equal(ops.KERNELS["block_trsm"](L, r).cpu(),
                       ref.rowsweep_bits_ref(L.cpu(), r.cpu()))


def test_kernels_share_pytorch_cuda_runtime(cuda_device):
    """The kernel libraries load no second CUDA runtime beside PyTorch's."""
    from pathlib import Path

    from repro_torch.kernels import extension

    for name in extension.SOURCES:
        extension.library(name)
    mapped = {line.split()[-1] for line in Path("/proc/self/maps").read_text().splitlines()
              if "libcudart" in line}
    assert len(mapped) <= 1, mapped


def test_refused_launch_raises_and_is_not_counted(cuda_device):
    # a 64-row tile with 1024 columns needs 256 KiB of shared memory: over the limit
    L = torch.eye(64, device=cuda_device).expand(2, 64, 64).contiguous()
    r = torch.ones(2, 64, 1024, device=cuda_device)
    before = ops.KERNELS["block_trsm"].launches
    with pytest.raises(RuntimeError, match="launch failed"):
        ops.KERNELS["block_trsm"](L, r)
    assert ops.KERNELS["block_trsm"].launches == before
    # the refusal was cleared: the next launch, and PyTorch's own, succeed
    small = r[:, :, :8].contiguous()
    torch.testing.assert_close(ops.KERNELS["block_trsm"](L, small), small)
    torch.cuda.synchronize()


@pytest.mark.parametrize("B", [8, 16])
@pytest.mark.parametrize("sched", ["levelset", "dagpart"])
def test_dyadic_solves_bit_identical_to_cpu(cuda_device, B, sched):
    a = _dyadic(suite.random_levelled(400, 8, 4.0, seed=6))
    rng = np.random.default_rng(1)
    b = rng.integers(-4, 5, a.n).astype(np.float32)
    panel = rng.integers(-4, 5, (a.n, 3)).astype(np.float32)
    opts = PlanOptions(block_size=B, sched=sched)
    card, cpu = SpTRSVContext(options=opts), SpTRSVContext(device="cpu", options=opts)
    hc, hp = card.analyse(a), cpu.analyse(a)
    ops.reset_launch_counts()
    for rhs, transpose in ((b, False), (b, True), (panel, False)):
        np.testing.assert_array_equal(card.solve(hc, rhs, transpose=transpose),
                                      cpu.solve(hp, rhs, transpose=transpose))
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in PER_OP_KERNELS), counts
    assert all(counts[k] == 0 for k in MEGAKERNELS), counts


def test_ic0_pcg_on_the_card_matches_cpu(cuda_device):
    a = spd_lower_from_triangular(suite.grid2d_factor(24, seed=3))
    b = np.random.default_rng(2).uniform(-1, 1, a.n)
    opts = PlanOptions(block_size=16)
    on_card = solve_ic0_pcg(a, b, config=opts, tol=1e-8)
    on_cpu = solve_ic0_pcg(a, b, device="cpu", config=opts, tol=1e-8)
    assert on_card.converged and on_card.n_iters == on_cpu.n_iters
    np.testing.assert_allclose(on_card.history, on_cpu.history, rtol=1e-4, atol=1e-12)
    assert on_card.info["context"].device.type == "cuda"


# ---------------------------------------------------------------------------
# the superstep megakernel (kernel_backend="fused")
# ---------------------------------------------------------------------------


def _fused_tables(plan, device):
    """The reference's tables of a one-device plan as int32 tensors."""
    from repro_torch.core.solver import level_widths, step_offsets

    host = ([0, plan.n_supersteps], plan.lvl_off, level_widths(plan), plan.solve_rows[0],
            plan.upd_tiles[0], plan.tile_row[0], plan.tile_col[0])
    dev = [torch.from_numpy(np.ascontiguousarray(t, dtype=np.int32)).to(device) for t in host]
    stp = torch.from_numpy(np.ascontiguousarray(step_offsets(plan), dtype=np.int32))
    return dev, stp.to(device)


@pytest.mark.parametrize("B,sched,R", [(8, "levelset", 1), (16, "dagpart", 3),
                                       (32, "levelset", 2), (48, "levelset", 1)])
def test_megakernel_bit_identical_to_plain_version_on_dyadic(cuda_device, B, sched, R):
    from repro_torch.core.solver import SolverConfig, build_plan
    from repro_torch.kernels import superstep

    a = _dyadic(suite.random_levelled(400, 8, 4.0, seed=6))
    plan = build_plan(a, 1, SolverConfig(block_size=B, sched=sched, kernel_backend="fused"))
    rng = np.random.default_rng(B)
    shape = (plan.bs.nb + 1, B) if R == 1 else (plan.bs.nb + 1, B, R)
    b_pad = rng.integers(-4, 5, shape).astype(np.float32)
    b_pad[-1] = 0
    outs = {}
    for dev in ("cpu", cuda_device):
        tables, stp = _fused_tables(plan, dev)
        zeros = torch.zeros(shape, device=dev)
        acc, x = superstep.superstep_call(
            *tables, torch.from_numpy(plan.diag).to(dev),
            torch.from_numpy(np.ascontiguousarray(plan.tiles[0])).to(dev),
            torch.from_numpy(b_pad).to(dev), zeros, zeros, stp=stp,
            flags=superstep.ReadyFlags(shape[0], dev))
        outs[str(dev)] = (acc.cpu().numpy(), x.cpu().numpy())
    np.testing.assert_array_equal(outs["cuda"][1], outs["cpu"][1])
    np.testing.assert_array_equal(outs["cuda"][0], outs["cpu"][0])


def test_fused_solves_are_deterministic_and_one_launch_each(cuda_device):
    a = suite.grid2d_factor(64, seed=6)
    b = np.random.default_rng(4).uniform(-1, 1, a.n)
    panel = np.random.default_rng(5).uniform(-1, 1, (a.n, 4))
    ctx = SpTRSVContext(options=PlanOptions(block_size=32, kernel="fused"))
    h = ctx.analyse(a)
    for rhs, transpose in ((b, False), (b, True), (panel, False)):
        ops.reset_launch_counts()
        x1 = ctx.solve(h, rhs, transpose=transpose)
        counts = ops.launch_counts()
        assert counts["superstep"] == 1 and sum(counts.values()) == 1, counts
        x2 = ctx.solve(h, rhs, transpose=transpose)
        np.testing.assert_array_equal(x1, x2)  # no atomics: the same bits every run
    cpu = SpTRSVContext(device="cpu", options=PlanOptions(block_size=32))
    np.testing.assert_allclose(x1, cpu.solve(cpu.analyse(a), panel), rtol=2e-4, atol=2e-4)


def test_refused_cooperative_launch_raises_and_next_launch_is_clean(cuda_device):
    from repro_torch.kernels import superstep

    a = suite.grid2d_factor(32, seed=6)
    ctx = SpTRSVContext(options=PlanOptions(block_size=32, kernel="fused"))
    h = ctx.analyse(a)
    b = np.random.default_rng(6).uniform(-1, 1, a.n)
    x = ctx.solve(h, b)
    solver = ctx.executor(h)
    fused = solver._fused
    b_pad = torch.zeros(solver.plan.bs.nb + 1, 32, device=cuda_device)
    too_many = 10**6  # CTAs: more than any card holds at once
    before = superstep.superstep_call.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        superstep.superstep_call(*fused.tables, solver._diag, solver._tiles, b_pad, b_pad,
                                 b_pad, stp=fused.stp, table=fused.table, grid=too_many,
                                 flags=fused.flags)
    assert superstep.superstep_call.launches == before
    np.testing.assert_array_equal(ctx.solve(h, b), x)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the streamed megakernel (kernel_backend="fused_streamed")
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sched,B", [("levelset", 32), ("dagpart", 32), ("levelset", 48)])
def test_streamed_bit_identical_to_resident_one_launch_each(cuda_device, sched, B):
    """Same arithmetic in the same order: the streamed kernel gives the
    resident kernel's bits on real values (forward, transpose, an (n, 3)
    panel), one streamed launch per solve, within 2e-4 of the CPU. At
    B = 48 the resident form sweeps the diagonal tile in row chunks of 21
    and the streamed form in blocks of 32, which must not change a bit."""
    a = suite.grid2d_factor(64, seed=6)
    rng = np.random.default_rng(4)
    b, panel = rng.uniform(-1, 1, a.n), rng.uniform(-1, 1, (a.n, 3))
    ctx = {k: SpTRSVContext(options=PlanOptions(block_size=B, sched=sched, kernel=k))
           for k in ("fused", "fused_streamed")}
    h = {k: c.analyse(a) for k, c in ctx.items()}
    cpu = SpTRSVContext(device="cpu", options=PlanOptions(block_size=B, sched=sched))
    hc = cpu.analyse(a)
    for rhs, transpose in ((b, False), (b, True), (panel, False)):
        ops.reset_launch_counts()
        x = ctx["fused_streamed"].solve(h["fused_streamed"], rhs, transpose=transpose)
        counts = ops.launch_counts()
        assert counts["superstep_streamed"] == 1 and sum(counts.values()) == 1, counts
        np.testing.assert_array_equal(
            x, ctx["fused"].solve(h["fused"], rhs, transpose=transpose))
        np.testing.assert_array_equal(
            x, ctx["fused_streamed"].solve(h["fused_streamed"], rhs, transpose=transpose))
        np.testing.assert_allclose(x, cpu.solve(hc, rhs, transpose=transpose),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("B,R", [(5, 1), (7, 3), (15, 2), (16, 3)])
def test_streamed_kernel_bit_identical_to_plain_version_odd_and_even_B(cuda_device, B, R):
    from repro_torch.core.solver import SolverConfig, build_plan, fused_layouts
    from repro_torch.kernels import superstep

    a = _dyadic(suite.random_levelled(400, 8, 4.0, seed=6))
    plan = build_plan(a, 1, SolverConfig(block_size=B, kernel_backend="fused_streamed"))
    rng = np.random.default_rng(B)
    shape = (plan.bs.nb + 1, B) if R == 1 else (plan.bs.nb + 1, B, R)
    b_pad = rng.integers(-4, 5, shape).astype(np.float32)
    b_pad[-1] = 0
    outs = {}
    for dev in ("cpu", cuda_device):
        tables, stp = _fused_tables(plan, dev)
        layout = fused_layouts(plan)[0].to(dev)
        values = superstep.streamed_values(
            layout, torch.from_numpy(plan.diag).to(dev),
            torch.from_numpy(np.ascontiguousarray(plan.tiles[0])).to(dev))
        zeros = torch.zeros(shape, device=dev)
        acc, x = superstep.superstep_streamed_call(
            *tables, values, torch.from_numpy(b_pad).to(dev), zeros, zeros, stp=stp,
            layout=layout, flags=superstep.ReadyFlags(shape[0], dev))
        outs[str(dev)] = (acc.cpu().numpy(), x.cpu().numpy())
    np.testing.assert_array_equal(outs["cuda"][1], outs["cpu"][1])
    np.testing.assert_array_equal(outs["cuda"][0], outs["cpu"][0])


def test_streamed_refresh_on_the_card(cuda_device):
    from repro_torch.core import solver as tsolver

    a = suite.grid2d_factor(48, seed=6)
    a2 = CSR(n=a.n, row_ptr=a.row_ptr, col_idx=a.col_idx,
             val=(a.val * (1.0 + 0.25 * np.sin(np.arange(a.nnz)))).astype(np.float32))
    cfg = tsolver.SolverConfig(block_size=32, kernel_backend="fused_streamed")
    solver = tsolver.Solver(tsolver.build_plan(a, 1, cfg))
    b = np.random.default_rng(7).uniform(-1, 1, a.n)
    before = solver.solve(b)
    solver.refresh(tsolver.refresh_plan(solver.plan, a2))
    fresh = tsolver.Solver(tsolver.build_plan(a2, 1, cfg))
    after = solver.solve(b)
    np.testing.assert_array_equal(after, fresh.solve(b))
    assert not np.array_equal(after, before)


@pytest.mark.parametrize("B", [32, 176])
def test_refused_streamed_launch_raises_and_next_launch_is_clean(cuda_device, B):
    """A refused launch (too many CTAs) raises, is not counted and leaves the
    next launch clean; at B = 176 the kernel streams row chunks."""
    from repro_torch.kernels import superstep

    a = suite.grid2d_factor(32, seed=6)
    ctx = SpTRSVContext(options=PlanOptions(block_size=B, kernel="fused_streamed"))
    h = ctx.analyse(a)
    b = np.random.default_rng(6).uniform(-1, 1, a.n)
    x = ctx.solve(h, b)
    solver = ctx.executor(h)
    fused = solver._fused
    assert (superstep.streamed_shape(B, fused.layout.max_item_tiles)[2] < B) == (B > 169)
    b_pad = torch.zeros(solver.plan.bs.nb + 1, B, device=cuda_device)
    before = superstep.superstep_streamed_call.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        superstep.superstep_streamed_call(*fused.tables, fused.values, b_pad, b_pad, b_pad,
                                          stp=fused.stp, layout=fused.layout, grid=10**6,
                                          flags=fused.flags)
    assert superstep.superstep_streamed_call.launches == before
    np.testing.assert_array_equal(ctx.solve(h, b), x)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the streamed megakernel at B >= 170: each tile in row chunks
# ---------------------------------------------------------------------------

# 88, 88, 88, 104, 88 and 24 rows a chunk; 6, 6, 6, 7, 8 and 8 warps a CTA
CHUNKED_B = (170, 171, 176, 203, 256, 1055)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("B", CHUNKED_B)
def test_chunked_streamed_kernel_bit_identical_to_plain_version(cuda_device, B, R, split):
    """The streamed kernel where two stages of one whole tile do not fit:
    a launch over the whole schedule (unsplit) or over its first two
    supersteps with non-zero carries (split: copy rows and orphans), each
    bit-identical to its plain version on a dyadic problem and to the
    resident kernel on the same inputs."""
    from repro_torch.core.solver import SolverConfig, build_plan
    from repro_torch.kernels import superstep

    a = _dyadic(suite.random_levelled(4 * B, 6, 4.0, seed=6))
    plan = build_plan(a, 1, SolverConfig(block_size=B, kernel_backend="fused_streamed"))
    (seg, *rest), stp = _fused_tables(plan, "cpu")
    if split:
        seg = torch.tensor([0, 2], dtype=torch.int32)
    tables = [seg, *rest]
    rng = np.random.default_rng(B)
    shape = (plan.bs.nb + 1, B) if R == 1 else (plan.bs.nb + 1, B, R)
    vecs = [rng.integers(-3, 4, shape).astype(np.float32) for _ in range(4 if split else 1)]
    for v in vecs:
        v[-1] = 0
    if not split:
        vecs += [np.zeros(shape, np.float32)] * 3
    layout = superstep.streamed_layout(*[t.numpy() for t in tables], n_rows=shape[0],
                                       stp=stp.numpy())
    warps, cap, rows = superstep.streamed_shape(B, layout.max_item_tiles)
    assert (warps, cap) == (superstep.chunk_warps(B), 1) and rows < B and rows % 4 == 0
    assert not split or layout.table.n_orphans > 0
    outs = {}
    for dev in ("cpu", cuda_device):
        t = [v.to(dev) for v in tables]
        b_pad, acc, delta, x = (torch.from_numpy(v.copy()).to(dev) for v in vecs)
        diag = torch.from_numpy(plan.diag).to(dev)
        tiles = torch.from_numpy(np.ascontiguousarray(plan.tiles[0])).to(dev)
        lay = layout.to(dev)
        values = superstep.streamed_values(lay, diag, tiles)
        flags = superstep.ReadyFlags(shape[0], dev)
        carries = dict(delta=delta) if split else {}
        ops.reset_launch_counts()
        got = superstep.superstep_streamed_call(*t, values, b_pad, acc, x, stp=stp.to(dev),
                                                layout=lay, flags=flags, **carries)
        name = "superstep_streamed_split" if split else "superstep_streamed"
        assert ops.launch_counts()[name] == (0 if dev == "cpu" else 1)
        outs[str(dev)] = [g.cpu().numpy() for g in got]
        if dev != "cpu":
            resident = superstep.superstep_call(*t, diag, tiles, b_pad, acc, x, stp=stp.to(dev),
                                                flags=flags, **carries)
            for g, r in zip(got, resident):
                np.testing.assert_array_equal(g.cpu().numpy(), r.cpu().numpy())
    for got, want in zip(outs["cuda"], outs["cpu"]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sched", ["levelset", "dagpart"])
@pytest.mark.parametrize("B", CHUNKED_B)
def test_chunked_streamed_bit_identical_to_resident_on_real_values(cuda_device, B, sched):
    """The chunked streamed kernel runs the resident kernel's FMAs and
    divisions in the same order (row chunks of other lengths): forward,
    transpose and an (n, 3) panel of a real-valued factor give the
    resident kernel's bits, one streamed launch a solve, within 2e-4 of the
    CPU."""
    a = suite.grid2d_factor(48, seed=6)
    rng = np.random.default_rng(B)
    b, panel = rng.uniform(-1, 1, a.n), rng.uniform(-1, 1, (a.n, 3))
    ctx = {k: SpTRSVContext(options=PlanOptions(block_size=B, sched=sched, kernel=k))
           for k in ("fused", "fused_streamed")}
    h = {k: c.analyse(a) for k, c in ctx.items()}
    cpu = SpTRSVContext(device="cpu", options=PlanOptions(block_size=B, sched=sched))
    hc = cpu.analyse(a)
    for rhs, transpose in ((b, False), (b, True), (panel, False)):
        ops.reset_launch_counts()
        x = ctx["fused_streamed"].solve(h["fused_streamed"], rhs, transpose=transpose)
        counts = ops.launch_counts()
        assert counts["superstep_streamed"] == 1 and sum(counts.values()) == 1, counts
        np.testing.assert_array_equal(
            x, ctx["fused"].solve(h["fused"], rhs, transpose=transpose))
        np.testing.assert_allclose(x, cpu.solve(hc, rhs, transpose=transpose),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("B", CHUNKED_B)
def test_chunked_launch_is_one_cta_of_w_warps_an_item(cuda_device, B):
    """In row chunks a launch runs one CTA of W = min(8, ceil(B / 32))
    warps per work item: the launch's own grid rule (csrc/superstep.cu)
    takes one CTA for each item (and column) of the widest level, at most
    the CTAs that fit at once, and the launch refuses any other number of
    warps."""
    from repro_torch.kernels import extension, superstep

    warps, cap, rows = superstep.streamed_shape(B, 3)
    assert warps == min(8, -(-B // 32)) and rows <= 32 * warps

    def grid(w, items, R=1):
        return extension.query("superstep", "repro_superstep_streamed_grid", w, cap, rows, B,
                               R, items)

    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert grid(warps, 5) == 5 and grid(warps, 5, R=3) == 15
    assert 0 < grid(warps, 10**6) <= 2 * sms  # one or two CTAs an SM fit
    for other in (1, warps - 1, warps + 1):
        if other != warps:
            assert grid(other, 5) < 0, other


# ---------------------------------------------------------------------------
# per-row ready flags (both megakernels)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["fused", "fused_streamed"])
def test_consecutive_solves_match_a_fresh_solver(cuda_device, kernel):
    """Five solves on one Solver, each with its own right-hand side: each
    within 2e-4 of scipy and bit-equal to a fresh Solver's solve, so no flag
    left by an earlier launch lets a row read a stale x."""
    from repro_torch.core import solver as tsolver
    from repro_torch.sparse.matrix import reference_solve

    a = suite.grid2d_factor(64, seed=6)
    cfg = tsolver.SolverConfig(block_size=32, kernel_backend=kernel)
    plan = tsolver.build_plan(a, 1, cfg)
    kept = tsolver.Solver(plan)
    rng = np.random.default_rng(11)
    for _ in range(5):
        b = rng.uniform(-1, 1, a.n)
        x = kept.solve(b)
        want = reference_solve(a, b)
        assert np.abs(x - want).max() <= 2e-4 * np.abs(want).max()
        np.testing.assert_array_equal(x, tsolver.Solver(plan).solve(b))
    assert kept._fused.flags.epoch == 5


@pytest.mark.parametrize("kernel", ["fused", "fused_streamed"])
def test_epoch_wrap_rezeros_the_flags(cuda_device, kernel):
    """At the wrap point the flags are zeroed and the count restarts at 1: a
    stale flag that already holds 1 must not let a row through early."""
    from repro_torch.core import solver as tsolver
    from repro_torch.kernels import superstep

    a = suite.grid2d_factor(64, seed=6)
    cfg = tsolver.SolverConfig(block_size=32, kernel_backend=kernel)
    plan = tsolver.build_plan(a, 1, cfg)
    solver = tsolver.Solver(plan)
    b = np.random.default_rng(12).uniform(-1, 1, a.n)
    want = tsolver.Solver(plan).solve(b)
    ready = solver._fused.flags
    ready.flags(1).fill_(1)  # as if every row were solved by a launch of epoch 1
    ready.epoch = superstep.EPOCH_LIMIT
    np.testing.assert_array_equal(solver.solve(b), want)
    assert ready.epoch == 1
    assert set(ready.flags(1).unique().tolist()) <= {0, 1}
    np.testing.assert_array_equal(solver.solve(b), want)
    assert ready.epoch == 2


@pytest.mark.parametrize("kernel", ["fused", "fused_streamed"])
@pytest.mark.parametrize("early_pads", [False, True])
def test_partial_launch_with_carries_bit_identical_to_plain_version(cuda_device, kernel,
                                                                    early_pads):
    """A launch over supersteps 2..5 with non-zero carries: copy rows, orphans
    and (with level 0's rows made pads, as if an earlier launch had solved
    them) pulls that must not wait, all bit-identical to the plain version
    on a dyadic problem."""
    from repro_torch.core.solver import SolverConfig, build_plan
    from repro_torch.kernels import superstep

    a = _dyadic(suite.random_levelled(400, 8, 4.0, seed=6))
    plan = build_plan(a, 1, SolverConfig(block_size=8, kernel_backend=kernel))
    (seg, off, wid, sr, ut, trow, tcol), stp = _fused_tables(plan, "cpu")
    seg = torch.tensor([0, plan.n_supersteps] if early_pads else [2, 4], dtype=torch.int32)
    if early_pads:
        sr = sr.clone()
        sr[int(off[0, 0]):int(off[0, 0] + wid[0, 0])] = -1
    tables = [seg, off, wid, sr, ut, trow, tcol]
    rng = np.random.default_rng(8)
    shape = (plan.bs.nb + 1, 8)
    b_pad, acc, x = (rng.integers(-3, 4, shape).astype(np.float32) for _ in range(3))
    for v in (b_pad, acc, x):
        v[-1] = 0
    host = [t.numpy() for t in tables]
    layout = superstep.streamed_layout(*host, n_rows=shape[0], stp=stp.numpy())
    assert layout.table.n_copy > 0
    assert (not layout.table.pull_wait.all()) if early_pads else layout.table.n_orphans > 0
    outs = {}
    for dev in ("cpu", cuda_device):
        t = [v.to(dev) for v in tables]
        vecs = [torch.from_numpy(v).to(dev) for v in (b_pad, acc, x)]
        diag = torch.from_numpy(plan.diag).to(dev)
        tiles = torch.from_numpy(np.ascontiguousarray(plan.tiles[0])).to(dev)
        if kernel == "fused":
            got = superstep.superstep_call(*t, diag, tiles, *vecs, stp=stp.to(dev),
                                           flags=superstep.ReadyFlags(shape[0], dev))
        else:
            lay = layout.to(dev)
            values = superstep.streamed_values(lay, diag, tiles)
            got = superstep.superstep_streamed_call(*t, values, *vecs, stp=stp.to(dev),
                                                    layout=lay,
                                                    flags=superstep.ReadyFlags(shape[0], dev))
        outs[str(dev)] = [g.cpu().numpy() for g in got]
    np.testing.assert_array_equal(outs["cuda"][1], outs["cpu"][1])
    np.testing.assert_array_equal(outs["cuda"][0], outs["cpu"][0])


# ---------------------------------------------------------------------------
# the megakernel's split form (multi-device comm="unified") and the exchange
# ---------------------------------------------------------------------------


def _split_segment(B: int, real: bool):
    """Device 1's tables of a 4-device unified dagpart plan, the segmented
    layout of its solve, and its widest merged superstep (several levels,
    so delta is not zero at the later ones)."""
    from repro_torch.core.solver import SolverConfig, build_plan, level_widths, step_offsets
    from repro_torch.kernels import superstep

    a = suite.random_levelled(1600, 12, 4.0, seed=6)
    if not real:
        a = _dyadic(a)
    plan = build_plan(a, 4, SolverConfig(block_size=B, comm="unified", sched="dagpart"))
    so = step_offsets(plan)
    s = int(np.argmax(np.diff(so)))
    assert so[s + 1] - so[s] > 1, "no merged superstep"
    host = [torch.tensor([s, 1], dtype=torch.int32)] + [
        torch.from_numpy(np.ascontiguousarray(t, dtype=np.int32))
        for t in (plan.lvl_off, level_widths(plan), plan.solve_rows[1], plan.upd_tiles[1],
                  plan.tile_row[1], plan.tile_col[1])]
    stp = torch.from_numpy(np.ascontiguousarray(so, dtype=np.int32))
    layout = superstep.segmented_layout(*[t.numpy() for t in host[1:]], n_rows=plan.bs.nb + 1,
                                        stp=so, bounds=np.arange(len(so)))
    return plan, host, stp, layout, s


@pytest.mark.parametrize("values", ["dyadic", "real"])
@pytest.mark.parametrize("form", ["resident", "streamed"])
@pytest.mark.parametrize("B", [7, 16, 32])
def test_split_kernel_matches_plain_version(cuda_device, B, form, values):
    """One launch of the split form over a merged superstep of device 1's
    tables, with non-zero incoming ``acc``, ``delta`` and ``x``, through
    the in-place launcher the unified executor uses (its segmented tables):
    bit-equal to the plain version on dyadic values (whose float32 result
    is the float64 one: nothing rounds), within 2e-4 on real ones; ``acc``
    untouched, one launch counted."""
    from repro_torch.kernels import superstep

    real = values == "real"
    plan, host, stp, layout, s = _split_segment(B, real)
    rng = np.random.default_rng(B)
    shape = (plan.bs.nb + 1, B)
    vecs = [(rng.uniform(-1, 1, shape) if real else rng.integers(-3, 4, shape))
            .astype(np.float32) for _ in range(4)]
    for v in vecs:
        v[-1] = 0
    outs = {}
    for dev in ("cpu", cuda_device):
        t = [v.to(dev) for v in host]
        b_pad, acc, delta, x = (torch.from_numpy(v.copy()).to(dev) for v in vecs)
        diag = torch.from_numpy(plan.diag).to(dev)
        tiles = torch.from_numpy(np.ascontiguousarray(plan.tiles[1])).to(dev)
        lay = layout.to(dev)
        flags = superstep.ReadyFlags(shape[0], dev)
        ops.reset_launch_counts()
        if form == "resident":
            superstep.superstep_split_(*t, diag, tiles, b_pad, acc, delta, x, stp.to(dev),
                                       table=lay.segments[s], flags=flags)
        else:
            values_ = superstep.streamed_values(lay, diag, tiles)
            superstep.superstep_streamed_split_(*t, values_, b_pad, acc, delta, x, stp.to(dev),
                                                layout=lay, table=lay.segments[s], flags=flags)
        name = "superstep_split" if form == "resident" else "superstep_streamed_split"
        assert ops.launch_counts()[name] == (1 if dev != "cpu" else 0)
        outs[str(dev)] = [v.cpu().numpy() for v in (acc, delta, x)]
    np.testing.assert_array_equal(outs["cuda"][0], vecs[1])  # acc is only read
    if real:
        for got, want in zip(outs["cuda"], outs["cpu"]):
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
        return
    t64 = [v.double() if v.is_floating_point() else v for v in host]
    exact = ref.superstep_ref(*t64[:7], torch.from_numpy(plan.diag).double(),
                              torch.from_numpy(plan.tiles[1]).double(),
                              *(torch.from_numpy(v).double() for v in vecs[:2]),
                              torch.from_numpy(vecs[3]).double(), stp,
                              delta=torch.from_numpy(vecs[2]).double())
    for got, want, e in zip(outs["cuda"], outs["cpu"], exact):
        np.testing.assert_array_equal(want, e.numpy().astype(np.float32))
        np.testing.assert_array_equal(got, want)


def test_gloo_group_of_one_on_the_card(cuda_device, tmp_path):
    """A one-rank gloo group on the card: ``all_reduce`` takes CUDA tensors
    (gloo stages them through host memory), and a session on the group
    gathers ``x`` through it, bit-equal to the session without a group."""
    import torch.distributed as dist

    from repro_torch.core import comm

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            rank=0, world_size=1)
    try:
        t = torch.arange(6, dtype=torch.float32, device=cuda_device)
        before = comm.all_reduce_sum_.calls
        assert comm.all_reduce_sum_(t, dist.group.WORLD) is t
        assert t.device.type == "cuda" and t.tolist() == list(range(6))
        a = _dyadic(suite.random_levelled(400, 8, 4.0, seed=6))
        b = np.random.default_rng(3).integers(-4, 5, a.n).astype(np.float32)
        opts = PlanOptions(block_size=16, comm="unified", kernel="fused")
        ctx = SpTRSVContext(options=opts, group=dist.group.WORLD)
        x = ctx.solve(ctx.analyse(a), b)
        assert comm.all_reduce_sum_.calls == before + 2  # the test's, then the gather
        alone = SpTRSVContext(options=opts)
        np.testing.assert_array_equal(x, alone.solve(alone.analyse(a), b))
    finally:
        dist.destroy_process_group()


def test_krylov_auto_and_store_on_a_gloo_group_of_one_on_the_card(cuda_device, tmp_path):
    """A one-rank gloo group on the card: ``SpMV(group=)`` (one
    ``all_reduce`` a matvec, three GEMV launches) and ``solve_ic0_pcg(group=)``
    bit-equal to the group-free runs; ``"auto"`` options and a plan store on
    the group: a cold session saves, a warm one hits, the same bits. The
    matvec's scatters (``index_add_``) add atomically on the card unless
    PyTorch's deterministic algorithms are on, so they are on here: with
    them, real-valued runs repeat bit for bit."""
    import torch.distributed as dist

    from repro_torch.core import comm
    from repro_torch.core.solver import SolverConfig, build_plan
    from repro_torch.krylov import SpMV
    from repro_torch.service import PlanStore

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            rank=0, world_size=1)
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        g = dist.group.WORLD
        a = spd_lower_from_triangular(suite.grid2d_factor(24, seed=3))
        plan = build_plan(_dyadic(a), 1, SolverConfig(block_size=16))
        v = np.random.default_rng(3).integers(-4, 5, a.n).astype(np.float32)
        spmv, alone = SpMV(plan, cuda_device, g), SpMV(plan, cuda_device)
        ops.reset_launch_counts()
        before = comm.all_reduce_sum_.calls
        y = spmv.matvec(v)
        assert comm.all_reduce_sum_.calls == before + 1 and spmv.exchanges == 1
        assert ops.launch_counts()["block_gemv"] == 3
        np.testing.assert_array_equal(y, alone.matvec(v))
        b = np.random.default_rng(4).uniform(-1, 1, a.n)
        opts = PlanOptions(block_size=16, kernel="fused")
        res = solve_ic0_pcg(a, b, config=opts, tol=1e-6, group=g)
        want = solve_ic0_pcg(a, b, config=opts, tol=1e-6)
        assert res.converged and res.n_iters == want.n_iters
        assert res.history == want.history
        np.testing.assert_array_equal(res.x, want.x)
        auto = PlanOptions(block_size=16, sched="auto", comm="auto", kernel="auto")
        xs = []
        for _ in range(2):
            ctx = SpTRSVContext(options=auto, group=g,
                                plan_store=PlanStore(str(tmp_path / "store")))
            xs.append(ctx.solve(ctx.analyse(a), b))
        assert ctx.stats()["plan_store_hits"] == 1 and not ctx.stats().get("analyses")
        np.testing.assert_array_equal(xs[0], xs[1])
    finally:
        torch.use_deterministic_algorithms(deterministic)
        dist.destroy_process_group()


def _zerocopy_segment(B: int, real: bool):
    """Device 1's tables of a 4-device zerocopy levelset plan, the segmented
    layout of its solve cut at the exchange segments (``fused_segments``,
    as the executor cuts it), and the segment with the most levels."""
    from repro_torch.core.solver import SolverConfig, build_plan, fused_segments, level_widths
    from repro_torch.kernels import superstep

    a = suite.random_levelled(1600, 12, 4.0, seed=6)
    if not real:
        a = _dyadic(a)
    plan = build_plan(a, 4, SolverConfig(block_size=B, comm="zerocopy"))
    segs = fused_segments(plan)
    assert len(segs) > 2, "one exchange segment: nothing split"
    s = int(np.argmax(segs[:, 1] - segs[:, 0]))
    host = [torch.tensor([segs[s, 0], segs[s, 1] - segs[s, 0]], dtype=torch.int32)] + [
        torch.from_numpy(np.ascontiguousarray(t, dtype=np.int32))
        for t in (plan.lvl_off, level_widths(plan), plan.solve_rows[1], plan.upd_tiles[1],
                  plan.tile_row[1], plan.tile_col[1])]
    layout = superstep.segmented_layout(*[t.numpy() for t in host[1:]], n_rows=plan.bs.nb + 1,
                                        bounds=np.concatenate([segs[:, 0], [plan.n_levels]]))
    return plan, host, layout, s


@pytest.mark.parametrize("values", ["dyadic", "real"])
@pytest.mark.parametrize("form", ["resident", "streamed"])
@pytest.mark.parametrize("B", [7, 16, 32])
def test_zerocopy_split_launch_with_zero_acc_matches_plain_version(cuda_device, B, form,
                                                                    values):
    """The zerocopy fused executor's launch: the split form over one
    exchange segment of device 1's tables, ``acc`` zero and the
    accumulator (non-zero, as after earlier segments and an exchange) in
    ``delta``: bit-equal to the plain version on dyadic values and to the
    float64 result, within 2e-4 on real ones; ``acc`` stays zero."""
    from repro_torch.kernels import superstep

    real = values == "real"
    plan, host, layout, s = _zerocopy_segment(B, real)
    rng = np.random.default_rng(B)
    shape = (plan.bs.nb + 1, B)
    vecs = [(rng.uniform(-1, 1, shape) if real else rng.integers(-3, 4, shape))
            .astype(np.float32) for _ in range(3)]  # b, delta, x
    for v in vecs:
        v[-1] = 0
    outs = {}
    for dev in ("cpu", cuda_device):
        t = [v.to(dev) for v in host]
        b_pad, delta, x = (torch.from_numpy(v.copy()).to(dev) for v in vecs)
        acc = torch.zeros_like(b_pad)
        diag = torch.from_numpy(plan.diag).to(dev)
        tiles = torch.from_numpy(np.ascontiguousarray(plan.tiles[1])).to(dev)
        lay = layout.to(dev)
        flags = superstep.ReadyFlags(shape[0], dev)
        ops.reset_launch_counts()
        if form == "resident":
            superstep.superstep_split_(*t, diag, tiles, b_pad, acc, delta, x,
                                       table=lay.segments[s], flags=flags)
        else:
            values_ = superstep.streamed_values(lay, diag, tiles)
            superstep.superstep_streamed_split_(*t, values_, b_pad, acc, delta, x,
                                                layout=lay, table=lay.segments[s], flags=flags)
        name = "superstep_split" if form == "resident" else "superstep_streamed_split"
        assert ops.launch_counts()[name] == (1 if dev != "cpu" else 0)
        outs[str(dev)] = [v.cpu().numpy() for v in (acc, delta, x)]
    assert not outs["cuda"][0].any()  # acc is only read
    if real:
        for got, want in zip(outs["cuda"], outs["cpu"]):
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
        return
    t64 = [v.double() if v.is_floating_point() else v for v in host]
    zero = torch.zeros(shape, dtype=torch.float64)
    exact = ref.superstep_ref(*t64[:7], torch.from_numpy(plan.diag).double(),
                              torch.from_numpy(plan.tiles[1]).double(),
                              torch.from_numpy(vecs[0]).double(), zero,
                              torch.from_numpy(vecs[2]).double(),
                              delta=torch.from_numpy(vecs[1]).double())
    for got, want, e in zip(outs["cuda"], outs["cpu"], exact):
        np.testing.assert_array_equal(want, e.numpy().astype(np.float32))
        np.testing.assert_array_equal(got, want)


class _ThreadGroup:
    """``D`` ranks as threads of this process, for tests: ``all_reduce``
    sums the ranks' tensors in rank order behind a barrier."""

    def __init__(self, D: int):
        import threading

        self.D, self.local = D, threading.local()
        self.barrier = threading.Barrier(D, timeout=120)
        self.slots = [None] * D

    def all_reduce_sum_(self, t, group):
        return self._reduce(t, torch.Tensor.add_)

    def all_reduce_max_(self, t, group):
        return self._reduce(t, lambda acc, o: torch.maximum(acc, o, out=acc))

    def _reduce(self, t, op):
        self.slots[self.local.rank] = t.clone()
        self.barrier.wait()
        total = self.slots[0].clone()
        for other in self.slots[1:]:
            op(total, other)
        self.barrier.wait()
        return t.copy_(total)

    def run(self, fn) -> list:
        """``fn(rank)`` on each rank's thread; its results in rank order."""
        import threading

        out, errors = [None] * self.D, []

        def body(r):
            self.local.rank = r
            try:
                out[r] = fn(r)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,)) for r in range(self.D)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out


@pytest.mark.parametrize("opts", [
    dict(comm="zerocopy", kernel="fused"), dict(comm="zerocopy", kernel="fused_streamed"),
    dict(comm="zerocopy", kernel="cuda"), dict(comm="zerocopy", sched="dagpart", kernel="fused"),
    dict(comm="zerocopy", sched="syncfree", kernel="cuda"),
    dict(comm="zerocopy", sched="syncfree", kernel="fused"),
    dict(comm="unified", sched="syncfree", kernel="fused"),
], ids=lambda o: "-".join(o.values()))
@pytest.mark.parametrize("values", ["dyadic", "real"])
def test_multi_rank_executors_on_the_card(cuda_device, monkeypatch, opts, values):
    """Two ranks (threads sharing the card, ``all_reduce`` summed behind a
    barrier) run the zerocopy and multi-rank syncfree executors: every
    rank's ``x`` equals the one-device plain solve on the CPU bit for bit
    on dyadic values, within 2e-4 of scipy on real ones; exchanges and
    split launches as ``dispatch_stats`` says (syncfree: ``n_levels``
    sweeps, one exchange each); no plain block op."""
    from repro_torch.core import comm
    from repro_torch.core.solver import Solver, SolverConfig, build_plan, dispatch_stats
    from repro_torch.kernels import superstep

    group = _ThreadGroup(2)
    monkeypatch.setattr(comm, "all_reduce_sum_", group.all_reduce_sum_)
    monkeypatch.setattr(comm, "rank", lambda g: g.local.rank)
    monkeypatch.setattr(comm, "size", lambda g: g.D)
    a = suite.random_levelled(1600, 12, 4.0, seed=6)
    if values == "dyadic":
        a = _dyadic(a)
    cfg = dict(opts)
    cfg["kernel_backend"] = cfg.pop("kernel")
    plan = build_plan(a, 2, SolverConfig(block_size=16, **cfg))
    assert plan.n_boundary_rows > 0
    b = np.random.default_rng(3).integers(-4, 5, a.n).astype(np.float32)
    one = build_plan(a, 1, SolverConfig(block_size=16, kernel_backend="reference"))
    want = Solver(one, "cpu").solve(b)
    _refuse_plain_block_ops(monkeypatch)
    stats = dispatch_stats(plan)
    before = superstep.superstep_split_.launches + superstep.superstep_streamed_split_.launches

    def rank(r):
        solver = Solver(plan, cuda_device, group)
        x = solver.solve(b)
        torch.cuda.synchronize()
        return x, solver.exchanges, solver._syncfree and solver._syncfree.sweeps

    results = group.run(rank)
    split = (superstep.superstep_split_.launches + superstep.superstep_streamed_split_.launches
             - before)
    for x, exchanges, sweeps in results:
        if values == "dyadic":
            np.testing.assert_array_equal(x, want)
        else:
            np.testing.assert_allclose(x, reference_solve(a, b), rtol=2e-4, atol=2e-4)
        if opts.get("sched") == "syncfree":
            assert sweeps == exchanges == plan.n_levels
        else:
            assert exchanges == stats["exchanges"] > 0
    if opts["kernel"].startswith("fused") and opts.get("sched") != "syncfree":
        assert split == 2 * stats["fused_launches"] == 2 * (stats["exchanges"] + 1)


@pytest.mark.parametrize("kernel", ["fused", "cuda"])
def test_multi_rank_spmv_and_pcg_on_the_card(cuda_device, monkeypatch, kernel):
    """Two ranks (threads sharing the card): the two-device SpMV of an
    (n, 2) panel equals the one-device plain SpMV on the CPU bit for bit on
    dyadic values; IC(0)-PCG (zerocopy) converges on both
    ranks to the same bits and iterations, within one iteration of the
    one-device PCG on the card, no plain block op."""
    from repro_torch.core import comm
    from repro_torch.core.solver import SolverConfig, build_plan
    from repro_torch.krylov import SpMV

    group = _ThreadGroup(2)
    monkeypatch.setattr(comm, "all_reduce_sum_", group.all_reduce_sum_)
    monkeypatch.setattr(comm, "all_reduce_max_", group.all_reduce_max_)
    monkeypatch.setattr(comm, "rank", lambda g: g.local.rank)
    monkeypatch.setattr(comm, "size", lambda g: g.D)
    a = spd_lower_from_triangular(suite.grid2d_factor(24, seed=3))
    a_dy = _dyadic(a)
    v = np.random.default_rng(3).integers(-4, 5, (a.n, 2)).astype(np.float32)
    want_y = SpMV(build_plan(a_dy, 1, SolverConfig(block_size=16)), "cpu").matvec(v)
    plan = build_plan(a_dy, 2, SolverConfig(block_size=16))
    b = np.random.default_rng(4).uniform(-1, 1, a.n)
    opts = PlanOptions(block_size=16, kernel=kernel)
    one = solve_ic0_pcg(a, b, config=opts, tol=1e-6)
    _refuse_plain_block_ops(monkeypatch)

    def rank(r):
        y = SpMV(plan, cuda_device, group).matvec(v)
        res = solve_ic0_pcg(a, b, config=opts, tol=1e-6, group=group)
        return y, res

    (y0, r0), (y1, r1) = group.run(rank)
    np.testing.assert_array_equal(y0, want_y)
    np.testing.assert_array_equal(y1, want_y)
    assert r0.converged and r0.n_iters == r1.n_iters and abs(r0.n_iters - one.n_iters) <= 1
    np.testing.assert_array_equal(r0.x, r1.x)
    np.testing.assert_allclose(r0.x, one.x, rtol=1e-4, atol=1e-4)
    assert r0.info["spmv"].n_matvecs == r0.info["spmv"].exchanges


# ---------------------------------------------------------------------------
# the syncfree executor (dense scan under "cuda", frontier form under "fused")
# and ILU(0)-BiCGStab
# ---------------------------------------------------------------------------


def _refuse_plain_block_ops(monkeypatch) -> None:
    """Make the block ops' plain versions raise: a solve that takes them on
    the card fails instead of falling back."""
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    for name in ("block_trsv_ref", "block_gemv_ref", "block_trsv_panel_ref"):
        monkeypatch.setattr(ref, name, refuse)


@pytest.fixture
def no_plain_block_ops(monkeypatch):
    """:func:`_refuse_plain_block_ops` for the whole test."""
    _refuse_plain_block_ops(monkeypatch)


@pytest.mark.parametrize("kernel", ["cuda", "fused"])
@pytest.mark.parametrize("B", [8, 16])
def test_syncfree_dyadic_bit_equal_to_megakernel(cuda_device, kernel, B, no_plain_block_ops):
    """Both syncfree forms on the card give the levelset megakernel's bits
    on a dyadic problem (every intermediate exact), forward, transpose and
    panel; each forward solve takes one block TRSV per level."""
    a = _dyadic(suite.random_levelled(400, 8, 4.0, seed=6))
    rng = np.random.default_rng(3)
    b = rng.integers(-4, 5, a.n).astype(np.float32)
    panel = rng.integers(-4, 5, (a.n, 3)).astype(np.float32)
    sync = SpTRSVContext(options=PlanOptions(block_size=B, sched="syncfree", kernel=kernel))
    mega = SpTRSVContext(options=PlanOptions(block_size=B, kernel="fused"))
    hs, hm = sync.analyse(a), mega.analyse(a)
    for rhs, transpose in ((b, False), (b, True), (panel, False)):
        ops.reset_launch_counts()
        x = sync.solve(hs, rhs, transpose=transpose)
        counts = ops.launch_counts()
        assert all(counts[k] == 0 for k in MEGAKERNELS), counts
        if rhs is b and not transpose:
            assert counts["block_trsv"] == sync.plan(hs).n_levels, counts
        np.testing.assert_array_equal(x, mega.solve(hm, rhs, transpose=transpose))


@pytest.mark.parametrize("kernel", ["cuda", "fused"])
def test_syncfree_real_values_within_tolerance_of_reference_backend(cuda_device, kernel):
    a = suite.grid2d_factor(64, seed=6)
    rng = np.random.default_rng(9)
    b, panel = rng.uniform(-1, 1, a.n), rng.uniform(-1, 1, (a.n, 4))
    want_ctx = SpTRSVContext(options=PlanOptions(kernel="reference"))
    want = {(transpose, r.ndim): want_ctx.solve(want_ctx.analyse(a), r, transpose=transpose)
            for r, transpose in ((b, False), (b, True), (panel, False))}
    ctx = SpTRSVContext(options=PlanOptions(sched="syncfree", kernel=kernel))
    h = ctx.analyse(a)
    for (transpose, ndim), w in want.items():
        x = ctx.solve(h, panel if ndim == 2 else b, transpose=transpose)
        np.testing.assert_allclose(x, w, rtol=2e-4, atol=2e-4)


def test_syncfree_frontier_launch_counts(cuda_device, no_plain_block_ops):
    """The frontier form launches the block TRSV (TRSM for a panel) once per
    level and the GEMV (GEMM) once per level that sources tiles."""
    from repro_torch.core.solver import level_widths

    a = suite.grid2d_factor(64, seed=6)
    ctx = SpTRSVContext(options=PlanOptions(sched="syncfree", kernel="fused"))
    h = ctx.analyse(a)
    plan = ctx.plan(h)
    with_tiles = int((level_widths(plan)[:, 1] > 0).sum())
    for rhs, solve_k, upd_k in ((np.ones(a.n), "block_trsv", "block_gemv"),
                                (np.ones((a.n, 2)), "block_trsm", "block_gemm")):
        ops.reset_launch_counts()
        ctx.solve(h, rhs)
        want = {**dict.fromkeys(ops.KERNELS, 0), solve_k: plan.n_levels, upd_k: with_tiles}
        assert ops.launch_counts() == want
    solver = ctx.executor(h)
    assert solver._syncfree.sweeps == solver._syncfree.host_reads == plan.n_levels


@pytest.mark.parametrize("kernel", ["cuda", "fused"])
def test_ilu0_bicgstab_on_the_card_matches_cpu(cuda_device, kernel):
    from repro_torch.krylov import solve_ilu0_bicgstab

    a = spd_lower_from_triangular(suite.grid2d_factor(24, seed=3))
    b = np.random.default_rng(2).uniform(-1, 1, a.n)
    opts = PlanOptions(block_size=16, kernel=kernel)
    ops.reset_launch_counts()
    on_card = solve_ilu0_bicgstab(a, b, config=opts, tol=1e-8)
    counts = ops.launch_counts()
    on_cpu = solve_ilu0_bicgstab(a, b, device="cpu", config=opts, tol=1e-8)
    assert on_card.converged and on_card.n_iters == on_cpu.n_iters
    np.testing.assert_allclose(on_card.history, on_cpu.history, rtol=1e-4, atol=1e-12)
    n = on_card.n_iters
    assert on_card.info["forward"].n_solves == on_card.info["backward"].n_solves == 2 * n
    if kernel == "fused":
        assert counts["superstep"] == 4 * n and counts["block_trsv"] == 0, counts
    else:
        assert counts["block_trsv"] > 0 and counts["superstep"] == 0, counts
    assert counts["block_gemv"] > 0, counts


# ---------------------------------------------------------------------------
# calibration and auto-tuning on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B", [16, 32])
def test_measured_weights_are_well_formed(cuda_device, B):
    """The card's weights come from timed kernels: finite, w_solve = 1,
    tile weights >= 0, each per-tile time positive; never the CPU's
    analytic counts."""
    from repro_torch.core import costmodel

    ms = costmodel.measured_tile_ms(B, "cuda", cuda_device)
    assert set(ms) == {"trsv", "gemv", "gemm"}
    assert all(np.isfinite(t) and t > 0 for t in ms.values()), ms
    w = costmodel.calibrate_weights(B, "fused", device=cuda_device, feedback=False)
    assert w == costmodel.measured_weights(B, "cuda", cuda_device)  # fused times "cuda"
    assert w[0] == 1.0 and all(np.isfinite(v) and v >= 0 for v in w), w
    assert w != costmodel.analytic_weights(B)


def test_probed_tune_records_cuda_samples(cuda_device):
    from repro_torch.api import autotune
    from repro_torch.obs import calibration as cal

    store = cal.CalibrationStore()
    cal.set_store(store)
    try:
        a = _dyadic(suite.random_levelled(600, 8, 4.0, seed=3))
        opts = PlanOptions(block_size=16, sched="auto", kernel="auto", probe_solves=2)
        _, plan, d, solver = autotune.tune(a, opts, cuda_device)
    finally:
        cal.set_store(None)
    assert d.mode == "probed" and d.chosen == min(d.probe_us, key=d.probe_us.get)
    assert all(us > 0 for us in d.probe_us.values()) and solver.plan is plan
    groups = store.sample_groups()
    assert groups and all(k.startswith("cuda:") for k in groups)
    assert sum(len(v) for v in groups.values()) == len(d.probe_us)
    # fused resident (the fixture's limit) beside fused_streamed: paired samples
    assert cal.calibrated_stream_limit(store) is not None


def test_plain_fused_above_the_limit_launches_the_streamed_kernel(cuda_device, monkeypatch):
    monkeypatch.delenv(ENV_STREAM_LIMIT)  # the measured default: every plan streams
    a = _dyadic(suite.random_levelled(600, 8, 4.0, seed=3))
    ctx = SpTRSVContext(options=PlanOptions(block_size=16, kernel="fused"))
    h = ctx.analyse(a)
    assert ctx.dispatch_stats(h)["streamed"]
    b = np.random.default_rng(2).integers(-4, 5, a.n).astype(np.float32)
    x = ctx.solve(h, b)  # builds the executor
    ops.reset_launch_counts()
    np.testing.assert_array_equal(ctx.solve(h, b), x)
    counts = ops.launch_counts()
    assert counts["superstep_streamed"] == 1 and sum(counts.values()) == 1, counts
    monkeypatch.setenv(ENV_STREAM_LIMIT, str(2**62))
    resident = SpTRSVContext(options=PlanOptions(block_size=16, kernel="fused"))
    np.testing.assert_array_equal(resident.solve(resident.analyse(a), b), x)



# ---------------------------------------------------------------------------
# the verifier, the plan store and the solve service on the card
# ---------------------------------------------------------------------------


def _exact_requests(mats, n_requests, seed=5):
    """(matrix, b, x) triples: b = L x for a small-integer x, so every
    partial sum of the solve is exact and any correct order gives x."""
    from repro_torch.sparse.matrix import to_scipy

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_requests):
        a = mats[0] if i % 3 or len(mats) == 1 else mats[1 + (i // 3) % (len(mats) - 1)]
        x = rng.integers(-4, 5, a.n).astype(np.float64)
        out.append((a, (to_scipy(a) @ x).astype(np.float32), x.astype(np.float32)))
    return out


def _service_mats():
    return [_dyadic(suite.random_levelled(n, lv, 4.0, seed=s), seed=s)
            for n, lv, s in ((700, 9, 3), (300, 6, 4), (200, 5, 5))]


@pytest.mark.parametrize("kernel", ["cuda", "fused", "fused_streamed"])
def test_engine_coalesced_bit_equal_to_solo(cuda_device, kernel, no_plain_block_ops):
    from repro_torch.api import pattern_key
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import trace_to
    from repro_torch.service import SolveEngine

    eng = SolveEngine(options=PlanOptions(block_size=16, kernel=kernel), max_batch=8,
                      registry=MetricsRegistry())
    reqs = _exact_requests(_service_mats(), 20)
    ops.reset_launch_counts()
    with trace_to() as tracer:
        tickets = [eng.submit(f"t{i % 4}", a, b) for i, (a, b, _) in enumerate(reqs)]
        assert eng.drain() == len(reqs)
        batches = [r["attrs"] for r in tracer.export()
                   if r.get("type") == "span" and r["name"] == "service.batch"]
    counts = ops.launch_counts()
    assert eng.stats()["batches"] == len(batches) < len(reqs)
    plans = {pattern_key(a): eng.ctx.plan(eng.ctx.analyse(a)) for a, _, _ in reqs}
    want = dict.fromkeys(counts, 0)
    for bt in batches:
        p = plans[bt["pattern"]]
        if kernel == "cuda":
            lv = tsolver_level_work(p)
            panel = bt["padded_width"] > 1
            want["block_trsm" if panel else "block_trsv"] += lv[0]
            want["block_gemm" if panel else "block_gemv"] += lv[1]
        else:
            want["superstep" if kernel == "fused" else "superstep_streamed"] += 1
    assert counts == want
    for t, (a, b, x) in zip(tickets, reqs):
        got = t.result(0)
        np.testing.assert_array_equal(got, x)
        np.testing.assert_array_equal(got, eng.ctx.solve(eng.ctx.analyse(a), b))


def tsolver_level_work(plan):
    """(levels with rows, levels with tiles): the switch executor's launches
    of the solve and the update kernel per solve."""
    from repro_torch.core.solver import level_widths

    w = level_widths(plan)
    return int((w[:, 0] > 0).sum()), int((w[:, 1] > 0).sum())


@pytest.mark.parametrize("kernel", ["cuda", "fused"])
def test_plan_store_round_trip_on_the_card(cuda_device, kernel, tmp_path):
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.service import PlanStore

    (a, b, x), = _exact_requests(_service_mats()[:1], 1)
    panel = np.stack([b, 2 * b, -b], axis=1)
    opts = PlanOptions(block_size=16, kernel=kernel)

    def session():
        store = PlanStore(str(tmp_path), registry=MetricsRegistry())
        return SpTRSVContext(options=opts, plan_store=store, registry=MetricsRegistry())

    cold = session()
    h = cold.analyse(a)
    got = [cold.solve(h, b), cold.solve(h, b, transpose=True), cold.solve(h, panel)]
    np.testing.assert_array_equal(got[0], x)
    warm = session()
    h2 = warm.analyse(a)
    for g, w in zip([warm.solve(h2, b), warm.solve(h2, b, transpose=True),
                     warm.solve(h2, panel)], got):
        np.testing.assert_array_equal(g, w)
    s = warm.stats()
    assert s.get("analyses", 0) == 0 and s["plan_store_hits"] == 2
    assert warm.plan_store.stats.get("rejected", 0) == 0
    assert warm.executor(h2).device.type == "cuda"


def test_background_engine_launches_on_its_one_stream(cuda_device, monkeypatch):
    from repro_torch.kernels import extension
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.service import SolveEngine

    side = torch.cuda.Stream()
    eng = SolveEngine(options=PlanOptions(block_size=16, kernel="fused"), max_batch=4,
                      max_wait_s=0.005, registry=MetricsRegistry(), stream=side)
    assert eng.stream is side
    streams, real = [], extension.launch

    def recording(name, fn, device, *args):
        streams.append(torch.cuda.current_stream(device))
        return real(name, fn, device, *args)

    monkeypatch.setattr(extension, "launch", recording)
    reqs = _exact_requests(_service_mats(), 12, seed=7)
    results = {}

    def tenant(i):
        a, b, _ = reqs[i]
        results[i] = eng.submit(f"t{i % 3}", a, b).result(timeout=120)

    import threading

    with eng:
        threads = [threading.Thread(target=tenant, args=(i,)) for i in range(len(reqs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    assert len(results) == len(reqs) and streams
    assert all(s == side for s in streams), {str(s) for s in streams}
    for i, (_, _, x) in enumerate(reqs):
        np.testing.assert_array_equal(results[i], x)
    # the same bits from a synchronous engine on the default stream
    sync = SolveEngine(options=PlanOptions(block_size=16, kernel="fused"),
                       registry=MetricsRegistry())
    tickets = [sync.submit("t", a, b) for a, b, _ in reqs]
    sync.drain()
    for i, t in enumerate(tickets):
        np.testing.assert_array_equal(t.result(0), results[i])


@pytest.mark.parametrize("B", [8, 16, 32, 64, 176, 256])
def test_scratch_shape_rule_is_the_launchs(cuda_device, B):
    """The verifier's kc.scratch.shape holds the host's copy of the shared
    memory rule; the launch code's own (csrc/superstep.cu) agrees."""
    from repro_torch.core import solver as tsolver
    from repro_torch.kernels import extension, superstep
    from repro_torch.verify import verify_plan

    a = _dyadic(suite.random_levelled(800, 8, 4.0, seed=B))
    for kernel in ("fused", "fused_streamed"):
        plan = tsolver.build_plan(a, 1, tsolver.SolverConfig(block_size=B, kernel_backend=kernel))
        report = verify_plan(plan, level="strict")
        assert report.passed and "kc.scratch.shape" in report.rules_checked
        layout = tsolver.fused_layouts(plan)[0]
        shape = superstep.streamed_shape(B, layout.max_item_tiles)
        launch = extension.query("superstep", "repro_superstep_shared_bytes", 1, *shape, B)
        assert tsolver.fused_vmem_bytes(plan, streamed=True) == launch
        assert tsolver.fused_vmem_bytes(plan) == extension.query(
            "superstep", "repro_superstep_shared_bytes", 0, 0, 0, 0, B)
        # and the launch runs with that much: a solve of the plan's own executor
        ctx = SpTRSVContext(options=PlanOptions(block_size=B, kernel=kernel))
        b = np.ones(a.n, np.float32)
        np.testing.assert_allclose(ctx.solve(ctx.analyse(a), b), reference_solve(a, b),
                                   rtol=2e-4, atol=2e-4)
