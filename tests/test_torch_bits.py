"""The bit oracles of the port's kernels (``ref.gemv_bits_ref``,
``ref.rowsweep_bits_ref``, ``ref.panel_bits_ref``) against the JAX
reference: within the reference's kernel tolerance on the tiles of
``tests/strategies.py`` draws and on the Pallas kernels, bit-equal on
dyadic batches, and equal to a lane-by-lane emulation of the kernels'
order; the panel oracle's exact ``fmaf`` against rounding by brute force.
The card tests (``tests/test_torch_cuda.py``) and ``chip_smoke.py`` hold the
CUDA kernels to these oracles bit for bit."""
import math
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")  # property draws are optional (requirements-dev.txt)
from hypothesis import HealthCheck, assume, given, settings

import strategies
from repro.core.blocking import build_blocks, pad_rhs
from repro.kernels import ref as jref
from repro.kernels.block_spmv import block_gemm as jgemm, block_gemv as jgemv
from repro.kernels.block_trsv import block_trsm as jtrsm, block_trsv as jtrsv
from repro_torch.kernels import ref

TOL = dict(rtol=2e-5, atol=2e-5)  # the reference's kernel tolerance: other summation orders
SETTINGS = dict(deadline=None, derandomize=True, max_examples=6,
                suppress_health_check=[HealthCheck.too_slow, HealthCheck.filter_too_much,
                                       HealthCheck.data_too_large])
ORACLE_B = (7, 8, 16, 32)
ORACLE_R = (1, 2, 3, 8, 16, 17)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _tiles(a, b, B, R, seed):
    """A draw's blocked tiles: diagonal tiles (k,B,B) with the blocked b as
    their right-hand sides, off-diagonal tiles (m,B,B) with the blocked b at
    their columns, and an R-column panel of each from the draw's seed."""
    bs = build_blocks(a, B)
    rb = pad_rhs(np.asarray(b, np.float32), bs)
    rng = np.random.default_rng(seed)
    return (bs.diag, rb, rng.uniform(-1, 1, rb.shape + (R,)),
            bs.off_tiles, rb[bs.off_cols], rng.uniform(-1, 1, (len(bs.off_cols), B, R)))


@pytest.mark.parametrize("B", ORACLE_B)
@settings(**SETTINGS)
@given(problem=strategies.triangular_problems())
def test_oracles_within_reference_tolerance_on_draws(problem, B):
    a, b = problem
    L, r, rp, T, x, X = _tiles(a, b, B, 3, seed=a.n)
    np.testing.assert_allclose(ref.rowsweep_bits_ref(_t(L), _t(r)),
                               jref.block_trsv_ref(jnp.asarray(L), jnp.asarray(r)), **TOL)
    np.testing.assert_allclose(ref.rowsweep_bits_ref(_t(L), _t(rp)),
                               jref.block_trsv_ref(jnp.asarray(L), jnp.asarray(rp)), **TOL)
    assume(len(T) > 0)
    np.testing.assert_allclose(ref.gemv_bits_ref(_t(T), _t(x)),
                               jref.block_gemv_ref(jnp.asarray(T), jnp.asarray(x)), **TOL)
    np.testing.assert_allclose(ref.gemv_bits_ref(_t(T), _t(X)),
                               jref.block_gemv_ref(jnp.asarray(T), jnp.asarray(X)), **TOL)


@pytest.mark.parametrize("B", ORACLE_B)
@settings(**SETTINGS)
@given(problem=strategies.dyadic_problems())
def test_oracles_bit_equal_to_reference_on_dyadic_draws(problem, B):
    """Dyadic tiles and small-integer right-hand sides: every partial sum
    is exact whenever the float64 solve is float32-representable, so any
    order gives the same bits."""
    a, b = problem
    L, r, _, T, x, _ = _tiles(a, b, B, 1, seed=0)
    want = np.linalg.solve(L.astype(np.float64), r[..., None].astype(np.float64))[..., 0]
    assume(np.array_equal(want.astype(np.float32).astype(np.float64), want))
    np.testing.assert_array_equal(ref.rowsweep_bits_ref(_t(L), _t(r)).numpy(),
                                  np.asarray(jref.block_trsv_ref(jnp.asarray(L), jnp.asarray(r))))
    np.testing.assert_array_equal(ref.rowsweep_bits_ref(_t(L), _t(r)).numpy(), want)
    np.testing.assert_array_equal(ref.gemv_bits_ref(_t(T), _t(x)).numpy(),
                                  np.asarray(jref.block_gemv_ref(jnp.asarray(T), jnp.asarray(x))))


def _exact_batch(k, B, R, seed):
    """Unit lower-triangular tiles with a sparse {-1, 1} lower part, integer
    panels X and r = L @ X, and integer tiles T: every partial sum of a
    forward substitution or a product is a small integer, exact in float32."""
    rng = np.random.default_rng(seed)
    L = np.tril(rng.choice([-1.0, 0.0, 0.0, 0.0, 1.0], (k, B, B)), -1) + np.eye(B)
    X = rng.integers(-3, 4, (k, B, R)).astype(np.float64)
    T = rng.integers(-2, 3, (k, B, B)).astype(np.float32)
    return L.astype(np.float32), np.einsum("kij,kjr->kir", L, X).astype(np.float32), T, X


@pytest.mark.parametrize("B", ORACLE_B)
@pytest.mark.parametrize("R", ORACLE_R)
def test_oracles_bit_equal_on_exact_batches(B, R):
    L, r, T, X = _exact_batch(5, B, R, seed=B * R)
    np.testing.assert_array_equal(ref.rowsweep_bits_ref(_t(L), _t(r)).numpy(), X)
    np.testing.assert_array_equal(ref.rowsweep_bits_ref(_t(L), _t(r[..., 0])).numpy(), X[..., 0])
    np.testing.assert_array_equal(
        ref.gemv_bits_ref(_t(T), _t(X)).numpy(),
        np.asarray(jref.block_gemv_ref(jnp.asarray(T), jnp.asarray(X, jnp.float32))))
    if R in (1, 3):  # the reference's Pallas kernels too (interpret mode: one compile per shape)
        Lj, rj, Tj, Xj = (jnp.asarray(v, jnp.float32) for v in (L, r, T, X))
        np.testing.assert_array_equal(ref.rowsweep_bits_ref(_t(L), _t(r)).numpy(),
                                      np.asarray(jtrsm(Lj, rj, interpret=True)))
        np.testing.assert_array_equal(
            ref.rowsweep_bits_ref(_t(L), _t(r[..., 0])).numpy(),
            np.asarray(jtrsv(Lj, rj[..., 0], algorithm="rowsweep", interpret=True)))
        np.testing.assert_array_equal(ref.gemv_bits_ref(_t(T), _t(X)).numpy(),
                                      np.asarray(jgemm(Tj, Xj, interpret=True)))
        np.testing.assert_array_equal(ref.gemv_bits_ref(_t(T), _t(X[..., 0])).numpy(),
                                      np.asarray(jgemv(Tj, Xj[..., 0], interpret=True)))


@pytest.mark.parametrize("B", ORACLE_B)
@pytest.mark.parametrize("R", [1, 3])
def test_oracles_within_reference_tolerance_on_pallas_kernels(B, R):
    """Real values against the reference's Pallas kernels (interpret mode),
    which sum each row in XLA's order: equal within the tolerance only."""
    rng = np.random.default_rng(B + R)
    L = np.tril(rng.uniform(-1, 1, (3, B, B)), -1) / B + 2 * np.eye(B)
    r, T = rng.uniform(-1, 1, (3, B, R)), rng.uniform(-1, 1, (3, B, B))
    Lj, rj, Tj = (jnp.asarray(v, jnp.float32) for v in (L, r, T))
    np.testing.assert_allclose(ref.rowsweep_bits_ref(_t(L), _t(r)),
                               jtrsm(Lj, rj, interpret=True), **TOL)
    np.testing.assert_allclose(ref.gemv_bits_ref(_t(T), _t(r)),
                               jgemm(Tj, rj, interpret=True), **TOL)


def _lanes_sum(products):
    """The warp's sum of one row, lane by lane in numpy float32 scalars:
    lane l holds fmaf(a, b, 0.f), lanes past the row hold +0, then the xor
    butterfly adds each lane's partner at offsets 16, 8, 4, 2, 1."""
    v = [np.float32(p) + np.float32(0.0) for p in products]
    v += [np.float32(0.0)] * (32 - len(v))
    for o in (16, 8, 4, 2, 1):
        v = [v[lane] + v[lane ^ o] for lane in range(32)]
    assert all(w.tobytes() == v[0].tobytes() for w in v)  # every lane ends with the same bits
    return v[0]


@pytest.mark.parametrize("B", ORACLE_B)
def test_oracles_equal_lane_by_lane_emulation(B):
    """The vectorised oracles against the kernels' order written out one
    lane and one row at a time."""
    rng = np.random.default_rng(B)
    T = rng.uniform(-1, 1, (2, B, B)).astype(np.float32)
    x = rng.uniform(-1, 1, (2, B)).astype(np.float32)
    L = (np.tril(rng.uniform(-1, 1, (2, B, B)), -1) + 2 * np.eye(B)).astype(np.float32)
    y = np.array([[_lanes_sum(T[t, i] * x[t]) for i in range(B)] for t in range(2)])
    sol = np.zeros((2, B), np.float32)
    for t in range(2):
        for i in range(B):
            s = _lanes_sum(L[t, i, :i] * sol[t, :i])
            sol[t, i] = (x[t, i] - s) / L[t, i, i]
    assert ref.gemv_bits_ref(_t(T), _t(x)).numpy().tobytes() == y.tobytes()
    assert ref.rowsweep_bits_ref(_t(L), _t(x)).numpy().tobytes() == sol.tobytes()


def test_oracles_take_blocks_of_at_most_one_warp():
    with pytest.raises(ValueError, match="at most 32"):
        ref.gemv_bits_ref(torch.ones(2, 33, 33), torch.ones(2, 33))
    with pytest.raises(ValueError, match="at most 32"):
        ref.rowsweep_bits_ref(torch.eye(33).expand(2, 33, 33), torch.ones(2, 33))


# the panel oracle (ref.panel_bits_ref): (B, P) pairs, P = 3, 6 not powers of two
PANEL_BP = [(8, 4), (16, 8), (24, 3), (24, 6), (32, 1), (32, 8), (32, 32)]
FMA_KINDS = ["random", "cancel", "gap", "tiny", "midpoint"]


def _round_f32(q: Fraction, negative_zero: bool = False) -> np.float32:
    """The float32 nearest the rational q, ties to even, by brute force:
    q = n * 2^e with 2^23 <= |n| < 2^24 (e >= -149, the subnormal step)."""
    if q == 0:
        return np.float32(-0.0 if negative_zero else 0.0)
    mag = abs(q)
    top = mag.numerator.bit_length() - mag.denominator.bit_length()
    if mag < Fraction(2) ** top:
        top -= 1  # now 2^top <= |q| < 2^(top + 1)
    e = max(top - 23, -149)
    n = round(mag / Fraction(2) ** e)  # Fraction rounds ties to even
    return np.float32(math.copysign(n * 2.0 ** e, q))


def _fma_exact(a, b, c) -> np.float32:
    """fmaf(a, b, c) of three float32 scalars, exactly: the exact a*b + c
    rounded once (an exact zero is -0 only when a*b and c are both -0)."""
    a, b, c = float(a), float(b), float(c)
    prod = Fraction(a) * Fraction(b)
    negative = [math.copysign(1.0, v) < 0 for v in (a, b, c)]
    both_negative_zeros = prod == 0 and negative[0] != negative[1] and c == 0 and negative[2]
    return _round_f32(prod + Fraction(c), negative_zero=both_negative_zeros)


def _fma_draws(kind: str, n: int = 300):
    """float32 triples (a, b, c) for fmaf: random magnitudes, sums that
    cancel to a few bits, large exponent gaps between a*b and c, subnormal
    or zero products, and sums 2^-70 from a midpoint between two float32
    values (where rounding the float64 sum to float32 rounds twice)."""
    rng = np.random.default_rng(FMA_KINDS.index(kind))

    def f32(mant, exp):
        return (mant * np.exp2(exp)).astype(np.float32)

    a = f32(rng.uniform(-2, 2, n), rng.integers(-20, 20, n))
    b = f32(rng.uniform(-2, 2, n), rng.integers(-20, 20, n))
    if kind == "random":
        c = f32(rng.uniform(-2, 2, n), rng.integers(-40, 40, n))
    elif kind == "cancel":  # c = -(a*b) rounded, nudged by a few float32 steps
        c = -(a * b)
        c = np.nextafter(c, np.where(rng.random(n) < 0.5, np.inf, -np.inf).astype(np.float32))
        c[::3] = -(a * b)[::3]
    elif kind == "gap":  # c 2^30 to 2^60 times larger or smaller than a*b
        gap = rng.integers(30, 60, n) * np.where(rng.random(n) < 0.5, 1, -1)
        c = f32(rng.uniform(-2, 2, n), np.log2(np.abs(a * b).astype(np.float64) + 1e-30)
                .astype(int) + gap)
    elif kind == "midpoint":  # c odd; a*b = +-(half c's step)(1 - m^2 2^-46)
        m = rng.integers(1, 1024, n)
        e = rng.integers(-20, 20, n)
        c = (np.where(rng.random(n) < 0.5, 1.0, -1.0) * np.exp2(e)
             * (1 + (2 * rng.integers(0, 2 ** 21, n) + 1) * 2.0 ** -23)).astype(np.float32)
        a = (np.where(rng.random(n) < 0.5, 1.0, -1.0) * np.exp2(e - 24)
             * (1 + m * 2.0 ** -23)).astype(np.float32)
        b = (1 - m * 2.0 ** -23).astype(np.float32)
    else:  # products near or below the float32 subnormal range, signed zeros
        a = f32(rng.uniform(-2, 2, n), rng.integers(-80, -60, n))
        b = f32(rng.uniform(-2, 2, n), rng.integers(-80, -60, n))
        c = f32(rng.uniform(-2, 2, n), rng.integers(-150, -125, n))
        a[::5], c[1::5] = np.float32(-0.0), np.float32(-0.0)
    return a, b, c


@pytest.mark.parametrize("kind", FMA_KINDS)
def test_fmaf_equals_rounding_by_brute_force(kind):
    a, b, c = _fma_draws(kind)
    got = ref.fmaf(_t(a), _t(b), _t(c)).numpy()
    want = np.array([_fma_exact(*v) for v in zip(a, b, c)], np.float32)
    assert got.tobytes() == want.tobytes()
    if kind == "random":  # not the product rounded first, then the sum
        assert got.tobytes() != ((a * b) + c).tobytes()
    if kind == "midpoint":  # not the float64 sum rounded to float32 either
        twice = (a.astype(np.float64) * b + c).astype(np.float32)
        assert got.tobytes() != twice.tobytes()


def _panel_by_lanes(L, r, P):
    """The panel kernels' order written out one row and one lane at a time
    in numpy float32 scalars: the in-panel products on lanes 0 .. i - base
    - 1 summed by the butterfly (``_lanes_sum``), the division, then each
    lower row's update chain with an exact fmaf (``_fma_exact``)."""
    B = len(r)
    r, x = r.copy(), np.zeros(B, np.float32)
    for base in range(0, B, P):
        for i in range(base, base + P):
            s = _lanes_sum(L[i, base:i] * x[base:i])
            x[i] = (r[i] - s) / L[i, i]
        for i in range(base + P, B):
            u = np.float32(0.0)
            for j in range(base, base + P):
                u = _fma_exact(L[i, j], x[j], u)
            r[i] = r[i] - u
    return x


def _real_lower(rng, k, B):
    return (np.tril(rng.uniform(-1, 1, (k, B, B)), -1) / B + 2 * np.eye(B)).astype(np.float32)


@pytest.mark.parametrize("B,P", PANEL_BP)
def test_panel_oracle_equals_lane_by_lane_emulation(B, P):
    rng = np.random.default_rng(B * P)
    L, r = _real_lower(rng, 2, B), rng.uniform(-1, 1, (2, B)).astype(np.float32)
    want = np.array([_panel_by_lanes(L[t], r[t], P) for t in range(2)])
    assert ref.panel_bits_ref(_t(L), _t(r), P).numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("B,P", PANEL_BP)
def test_panel_oracle_within_reference_tolerance_on_pallas_kernel(B, P):
    """Real values against the reference's panel kernel (interpret mode),
    which sums in XLA's order: equal within the tolerance only."""
    rng = np.random.default_rng(B + P)
    L, r = _real_lower(rng, 3, B), rng.uniform(-1, 1, (3, B)).astype(np.float32)
    want = jtrsv(jnp.asarray(L), jnp.asarray(r), algorithm="panel", panel=P, interpret=True)
    np.testing.assert_allclose(ref.panel_bits_ref(_t(L), _t(r), P), want, **TOL)


@pytest.mark.parametrize("B,P", PANEL_BP)
def test_panel_oracle_bit_equal_to_reference_on_dyadic_batches(B, P):
    L, r, _, X = _exact_batch(3, B, 1, seed=B + P)
    got = ref.panel_bits_ref(_t(L), _t(r[..., 0]), P).numpy()
    np.testing.assert_array_equal(got, X[..., 0])
    want = jtrsv(jnp.asarray(L), jnp.asarray(r[..., 0]), algorithm="panel", panel=P,
                 interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_panel_oracle_takes_blocks_of_at_most_one_warp_and_whole_panels():
    with pytest.raises(ValueError, match="at most 32"):
        ref.panel_bits_ref(torch.eye(64).expand(2, 64, 64), torch.ones(2, 64), 8)
    with pytest.raises(ValueError, match="not a multiple of panel 5"):
        ref.panel_bits_ref(torch.eye(8).expand(2, 8, 8), torch.ones(2, 8), 5)
