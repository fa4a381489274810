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
from repro_torch.kernels import ops, ref
from repro_torch.krylov import solve_ic0_pcg, spd_lower_from_triangular
from repro_torch.sparse import suite
from repro_torch.sparse.matrix import CSR

pytestmark = pytest.mark.cuda

TOL = dict(rtol=2e-5, atol=2e-5)  # float32, different summation orders


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
    plain = ref.block_trsv_ref if solve else ref.block_gemv_ref
    torch.testing.assert_close(fn(m, v), plain(m, v), **TOL)
    assert fn.launches == before + 1


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
    assert all(counts[k] > 0 for k in ops.KERNELS), counts


def test_ic0_pcg_on_the_card_matches_cpu(cuda_device):
    a = spd_lower_from_triangular(suite.grid2d_factor(24, seed=3))
    b = np.random.default_rng(2).uniform(-1, 1, a.n)
    opts = PlanOptions(block_size=16)
    on_card = solve_ic0_pcg(a, b, config=opts, tol=1e-8)
    on_cpu = solve_ic0_pcg(a, b, device="cpu", config=opts, tol=1e-8)
    assert on_card.converged and on_card.n_iters == on_cpu.n_iters
    np.testing.assert_allclose(on_card.history, on_cpu.history, rtol=1e-4, atol=1e-12)
    assert on_card.info["context"].device.type == "cuda"
