"""Port kernel layer: each wrapper's plain version against the reference's
oracles and Pallas kernels (interpret mode), the rank dispatch and the
wrapper contract. The CUDA kernels themselves are tested on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.block_spmv import (
    block_gemm as jgemm, block_gemv as jgemv, block_gemv_grouped as jgemv_grouped,
)
from repro.kernels.block_trsv import block_trsm as jtrsm, block_trsv as jtrsv
from repro_torch.kernels import ops, ref
from repro_torch.kernels.block_spmv import block_gemm, block_gemv, block_gemv_grouped
from repro_torch.kernels.block_trsv import block_trsm, block_trsv, block_trsv_panel

TOL = dict(rtol=2e-5, atol=2e-5)  # float32, different summation orders


def _tri(k, B, seed=0):
    rng = np.random.default_rng(seed)
    L = np.tril(rng.uniform(-1, 1, (k, B, B))).astype(np.float32)
    L[:, np.arange(B), np.arange(B)] = 2.0 + rng.uniform(0, 1, (k, B))
    r = rng.uniform(-1, 1, (k, B)).astype(np.float32)
    return L, r


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("B", [8, 16, 32, 64])
@pytest.mark.parametrize("k", [1, 3, 17])
def test_trsv_plain_matches_reference_and_pallas(B, k):
    L, r = _tri(k, B, seed=B * 100 + k)
    out = block_trsv(_t(L), _t(r)).numpy()
    np.testing.assert_allclose(out, jref.block_trsv_ref(jnp.asarray(L), jnp.asarray(r)), **TOL)
    np.testing.assert_allclose(
        out, jtrsv(jnp.asarray(L), jnp.asarray(r), algorithm="rowsweep", interpret=True),
        **TOL)


@pytest.mark.parametrize("B,k,R", [(8, 1, 2), (16, 3, 4), (32, 5, 8)])
def test_trsm_plain_matches_reference_and_pallas(B, k, R):
    L, _ = _tri(k, B, seed=B + R)
    r = np.random.default_rng(R).uniform(-1, 1, (k, B, R)).astype(np.float32)
    out = block_trsm(_t(L), _t(r)).numpy()
    np.testing.assert_allclose(out, jref.block_trsv_ref(jnp.asarray(L), jnp.asarray(r)), **TOL)
    np.testing.assert_allclose(out, jtrsm(jnp.asarray(L), jnp.asarray(r), interpret=True),
                               **TOL)


def test_trsm_columns_equal_independent_trsv():
    """A panel solve is exactly R stacked single-RHS solves."""
    k, B, R = 4, 16, 3
    L, _ = _tri(k, B, seed=9)
    r = np.random.default_rng(9).uniform(-1, 1, (k, B, R)).astype(np.float32)
    panel = block_trsm(_t(L), _t(r))
    for j in range(R):
        single = block_trsv(_t(L), _t(r[..., j]))
        torch.testing.assert_close(panel[..., j], single, **TOL)


@pytest.mark.parametrize("B", [8, 32, 128])
@pytest.mark.parametrize("m", [1, 5, 13])
def test_gemv_plain_matches_reference_and_pallas(B, m):
    rng = np.random.default_rng(B + m)
    T = rng.uniform(-1, 1, (m, B, B)).astype(np.float32)
    x = rng.uniform(-1, 1, (m, B)).astype(np.float32)
    out = block_gemv(_t(T), _t(x)).numpy()
    np.testing.assert_allclose(out, jref.block_gemv_ref(jnp.asarray(T), jnp.asarray(x)), **TOL)
    np.testing.assert_allclose(out, jgemv(jnp.asarray(T), jnp.asarray(x), interpret=True),
                               **TOL)


@pytest.mark.parametrize("B,m,R", [(8, 1, 2), (16, 7, 4), (32, 4, 5)])
def test_gemm_plain_matches_reference_and_pallas(B, m, R):
    rng = np.random.default_rng(B + m + R)
    T = rng.uniform(-1, 1, (m, B, B)).astype(np.float32)
    x = rng.uniform(-1, 1, (m, B, R)).astype(np.float32)
    out = block_gemm(_t(T), _t(x)).numpy()
    np.testing.assert_allclose(out, jref.block_gemv_ref(jnp.asarray(T), jnp.asarray(x)), **TOL)
    np.testing.assert_allclose(out, jgemm(jnp.asarray(T), jnp.asarray(x), interpret=True),
                               **TOL)


@pytest.mark.parametrize("backend", ["reference", "cuda", None])
def test_ops_dispatch_by_rhs_rank(backend):
    """(k,B) and (k,B,R) route to the right op; on CPU tensors the "cuda"
    backend runs the wrappers' plain versions."""
    L, r = _tri(3, 16, seed=2)
    rp = np.random.default_rng(2).uniform(-1, 1, (3, 16, 4)).astype(np.float32)
    L, r, rp = _t(L), _t(r), _t(rp)
    out1 = ops.batched_block_trsv(L, r, backend=backend)
    out2 = ops.batched_block_trsv(L, rp, backend=backend)
    assert out1.shape == (3, 16) and out2.shape == (3, 16, 4)
    torch.testing.assert_close(out1, ref.block_trsv_ref(L, r), **TOL)
    torch.testing.assert_close(out2, ref.block_trsv_ref(L, rp), **TOL)
    torch.testing.assert_close(ops.batched_block_gemv(L, r, backend=backend),
                               ref.block_gemv_ref(L, r), **TOL)
    torch.testing.assert_close(ops.batched_block_gemv(L, rp, backend=backend),
                               ref.block_gemv_ref(L, rp), **TOL)


def test_backend_resolution():
    assert ops.executor_backend(None, torch.device("cpu")) == "reference"
    assert ops.executor_backend(None, torch.device("cuda")) == "cuda"
    assert ops.executor_backend("cuda", torch.device("cpu")) == "cuda"
    with pytest.raises(ValueError, match="cuda"):
        ops.executor_backend("pallas", torch.device("cpu"))


@pytest.mark.parametrize("op,backend", [
    ("batched_block_trsv", "fused_streamed"), ("batched_block_gemv", "fused"),
    ("batched_block_trsv", "fused"), ("batched_block_gemv", "fused_streamed"),
])
def test_unported_variants_raise(op, backend):
    """Per-op calls under a fused backend no longer raise: like the
    reference's ``op_backend``, the port degrades them to the device's
    default (``reference`` on the CPU) and returns the reference's result
    on the same inputs, vectors and panels, bit for bit on a dyadic batch
    (``2 I`` against ``[8, 12, 0, -12]`` gives ``[4, 6, 0, -6]``)."""
    assert ops.op_backend(backend, torch.device("cpu")) == "reference"
    L, r = _tri(2, 8)
    rp = np.random.default_rng(3).uniform(-1, 1, (2, 8, 3)).astype(np.float32)
    for rhs in (r, rp):
        got = getattr(ops, op)(_t(L), _t(rhs), backend=backend).numpy()
        want = getattr(jops, op)(jnp.asarray(L), jnp.asarray(rhs), backend=backend)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    two = 2 * np.eye(4, dtype=np.float32)[None]
    b = np.array([[8.0, 12.0, 0.0, -12.0]], np.float32)
    got = getattr(ops, op)(_t(two), _t(b), backend=backend).numpy()
    want = np.asarray(getattr(jops, op)(jnp.asarray(two), jnp.asarray(b), backend=backend))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        want, [[4.0, 6.0, 0.0, -6.0]] if op == "batched_block_trsv" else [[16.0, 24.0, 0.0, -24.0]])


@pytest.mark.parametrize("variant", ["panel", "group"])
def test_panel_and_grouped_variants_run_and_match_reference(variant):
    """``algorithm="panel"`` and ``group > 1`` on the ``cuda`` backend (CPU
    tensors: the wrappers' plain versions) match the reference's Pallas
    kernels in interpret mode."""
    L, r = _tri(5, 16, seed=7)
    if variant == "panel":
        got = ops.batched_block_trsv(_t(L), _t(r), backend="cuda", algorithm="panel")
        want = jtrsv(jnp.asarray(L), jnp.asarray(r), algorithm="panel", interpret=True)
    else:
        got = ops.batched_block_gemv(_t(L), _t(r), backend="cuda", group=4)
        want = jgemv_grouped(jnp.asarray(L), jnp.asarray(r), group=4, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _exact_tri(k, B, seed=0):
    """Unit lower-triangular integer tiles with a sparse {-1, 1} lower part
    and r = L @ x for small integer x: every partial sum of a forward
    substitution, in any order, is a small integer, so exact in float32."""
    rng = np.random.default_rng(seed)
    L = np.tril(rng.choice([-1.0, 0.0, 0.0, 0.0, 1.0], (k, B, B)), -1) + np.eye(B)
    x = rng.integers(-3, 4, (k, B)).astype(np.float64)
    return L.astype(np.float32), np.einsum("kij,kj->ki", L, x).astype(np.float32)


@pytest.mark.parametrize("B,panel", [(8, 8), (16, 8), (32, 8), (64, 16)])
@pytest.mark.parametrize("k", [1, 7])
def test_trsv_panel_plain_matches_reference_and_pallas(B, panel, k):
    L, r = _tri(k, B, seed=B + k)
    out = block_trsv_panel(_t(L), _t(r), panel).numpy()
    want = jtrsv(jnp.asarray(L), jnp.asarray(r), algorithm="panel", panel=panel, interpret=True)
    np.testing.assert_allclose(out, np.asarray(want), **TOL)
    np.testing.assert_allclose(out, jref.block_trsv_ref(jnp.asarray(L), jnp.asarray(r)), **TOL)
    Le, re = _exact_tri(k, B, seed=B * k)
    exact = jtrsv(jnp.asarray(Le), jnp.asarray(re), algorithm="panel", panel=panel,
                  interpret=True)
    np.testing.assert_array_equal(block_trsv_panel(_t(Le), _t(re), panel).numpy(),
                                  np.asarray(exact))


@pytest.mark.parametrize("m,group", [(8, 4), (13, 4), (5, 8), (3, 1)])
def test_gemv_grouped_plain_matches_reference_and_pallas(m, group):
    """A multiple of ``group`` tiles and a short last group alike; the result
    is ``block_gemv``'s, bit for bit."""
    rng = np.random.default_rng(m * group)
    T = rng.uniform(-1, 1, (m, 32, 32)).astype(np.float32)
    x = rng.uniform(-1, 1, (m, 32)).astype(np.float32)
    out = block_gemv_grouped(_t(T), _t(x), group)
    want = jgemv_grouped(jnp.asarray(T), jnp.asarray(x), group=group, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    torch.testing.assert_close(out, block_gemv(_t(T), _t(x)), rtol=0, atol=0)
    Ti = rng.integers(-2, 3, (m, 32, 32)).astype(np.float32)
    xi = rng.integers(-2, 3, (m, 32)).astype(np.float32)
    exact = jgemv_grouped(jnp.asarray(Ti), jnp.asarray(xi), group=group, interpret=True)
    np.testing.assert_array_equal(block_gemv_grouped(_t(Ti), _t(xi), group).numpy(),
                                  np.asarray(exact))


def test_trsv_panel_on_panels_takes_the_trsm_and_unknown_algorithms_raise():
    """As in the reference, a (k,B,R) right-hand side goes to the TRSM
    whatever the algorithm."""
    L, _ = _tri(3, 16, seed=5)
    rp = np.random.default_rng(5).uniform(-1, 1, (3, 16, 2)).astype(np.float32)
    ops.reset_launch_counts()
    torch.testing.assert_close(
        ops.batched_block_trsv(_t(L), _t(rp), backend="cuda", algorithm="panel"),
        block_trsm(_t(L), _t(rp)), rtol=0, atol=0)
    with pytest.raises(ValueError, match="algorithm"):
        ops.batched_block_trsv(_t(L), _t(rp[..., 0]), backend="cuda", algorithm="blocked")


def test_reference_backend_ignores_group_like_the_reference():
    L, r = _tri(3, 8, seed=4)
    torch.testing.assert_close(
        ops.batched_block_gemv(_t(L), _t(r), backend="reference", group=4),
        ref.block_gemv_ref(_t(L), _t(r)))


@pytest.mark.parametrize("fn,mat,vec,err", [
    (block_trsv, (2, 8, 8), (2, 8), None),
    (block_trsv, (2, 8, 8), (2, 8, 3), ValueError),  # rank
    (block_trsm, (2, 8, 8), (2, 8), ValueError),
    (block_gemv, (2, 8, 8), (3, 8), ValueError),  # batch mismatch
    (block_gemm, (2, 8, 4), (2, 8, 2), ValueError),  # non-square tiles
    (block_trsv_panel, (2, 16, 16), (2, 16), None),
    (block_trsv_panel, (2, 12, 12), (2, 12), ValueError),  # B not a multiple of 8
    (block_gemv_grouped, (5, 8, 8), (5, 8), None),
    (block_gemv_grouped, (5, 8, 8), (5, 8, 2), ValueError),  # vectors only
])
def test_wrapper_shape_contract(fn, mat, vec, err):
    m, v = torch.ones(mat), torch.ones(vec)
    if err is None:
        assert fn(m, v).shape == v.shape
    else:
        with pytest.raises(err):
            fn(m, v)


def test_wrapper_dtype_and_layout_contract():
    L, r = _t(_tri(2, 8)[0]), _t(_tri(2, 8)[1])
    with pytest.raises(TypeError, match="float32"):
        block_trsv(L.double(), r.double())
    with pytest.raises(ValueError, match="contiguous"):
        block_gemv(L.transpose(1, 2), r)


def test_cpu_and_empty_calls_launch_nothing():
    ops.reset_launch_counts()
    L, r = _tri(3, 8)
    block_trsv(_t(L), _t(r))
    block_gemm(torch.zeros(0, 8, 8), torch.zeros(0, 8, 2))
    block_trsv_panel(_t(L), _t(r))
    block_gemv_grouped(torch.zeros(0, 8, 8), torch.zeros(0, 8), 4)
    assert block_trsv(torch.zeros(0, 8, 8), torch.zeros(0, 8)).shape == (0, 8)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_chip_smoke_times_global_functions_of_the_sources():
    """Each name ``chip_smoke.py`` reads device times by is a ``__global__``
    function of ``csrc/*.cu``, and its pattern matches that function's
    mangled name: a renamed kernel would otherwise leave a silent null in
    the kernels line."""
    import importlib.util
    import re
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sources = "".join(p.read_text()
                      for p in (root / "src/repro_torch/kernels/csrc").glob("*.cu"))
    defined = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                             sources))
    assert set(smoke.DEVICE_SYMBOL) == set(smoke.PER_OP) | {"block_trsv_panel",
                                                            "block_gemv_grouped"}
    for name, symbol in smoke.DEVICE_SYMBOL.items():
        assert symbol in defined, (name, symbol, sorted(defined))
        mangled = f"_ZN12_GLOBAL__N_1{len(symbol)}{symbol}EPKfS1_Pfii"
        assert re.search(smoke.DEVICE_KERNEL[name], mangled), (name, mangled)
        assert re.search(smoke.DEVICE_KERNEL[name], f"(anonymous namespace)::{symbol}(float)")
