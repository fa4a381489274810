"""Port executor and session: solves bit-identical to the reference's switch
executor on the dyadic suites, within 2e-4 of scipy on the real-valued
suites, the plan_from_arrays round trip, degenerate inputs, and the session
counters as ``tests/test_api.py`` pins them for the reference."""
import functools

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import strategies
from torch_parity import assert_dispatch_stats_match, flatten_plan, port_config, to_torch_csr
from repro.core import DistributedSolver, SolverConfig, build_plan
from repro.sparse.matrix import reference_solve, to_scipy
from repro_torch.api import PlanOptions, SpTRSVContext, pattern_key
from repro_torch.core import solver as tsolver
from repro_torch.core.blocking import pad_rhs, unpad_x
from repro_torch.sparse import suite as tsuite
from repro_torch.sparse.matrix import CSR

TOL = dict(rtol=2e-4, atol=2e-4)  # float32 solves, as the reference's own tests


def _rhs(n, form, seed=1):
    b = strategies.dyadic_rhs(n, seed=seed)
    if form == "panel":
        return np.stack([b, strategies.dyadic_rhs(n, seed=seed + 1),
                         strategies.dyadic_rhs(n, seed=seed + 2)], axis=1)
    return b


@functools.lru_cache(maxsize=None)
def _reference_solve(matrix: str, B: int, form: str) -> np.ndarray:
    """The reference switch executor's answer (XLA block ops), cached per case."""
    a = strategies.EXACT_MATRICES[matrix]()
    plan = build_plan(a, 1, SolverConfig(block_size=B, kernel_backend="reference"),
                      transpose=form == "transpose")
    return np.asarray(DistributedSolver(plan, strategies.mesh1()).solve(_rhs(a.n, form)))


def _port_solver(a, B, sched="levelset", transpose=False, kernel=None):
    cfg = tsolver.SolverConfig(block_size=B, sched=sched, kernel_backend=kernel)
    return tsolver.Solver(tsolver.build_plan(to_torch_csr(a), 1, cfg, transpose=transpose),
                          device="cpu")


@pytest.mark.parametrize("matrix", sorted(strategies.EXACT_MATRICES))
@pytest.mark.parametrize("B", [8, 16])
@pytest.mark.parametrize("form", ["forward", "transpose", "panel"])
@pytest.mark.parametrize("sched,kernel", [("levelset", None), ("dagpart", None),
                                          ("levelset", "cuda")])
def test_bit_identical_to_reference_on_dyadic(matrix, B, form, sched, kernel):
    """Every intermediate is exact in float32, so any correct execution gives
    the reference's bits; ``kernel="cuda"`` routes through the kernel
    wrappers, which run their plain versions on CPU tensors."""
    a = strategies.EXACT_MATRICES[matrix]()
    b = _rhs(a.n, form)
    if form == "forward":
        assert strategies.exactness_holds(a, b)
    x = _port_solver(a, B, sched, form == "transpose", kernel).solve(b)
    np.testing.assert_array_equal(x, _reference_solve(matrix, B, form))


@pytest.mark.parametrize("name", sorted(strategies.SOLVER_MATRICES))
def test_matches_scipy_on_solver_matrices(name):
    a = strategies.SOLVER_MATRICES[name]()
    rng = np.random.default_rng(3)
    b, panel = rng.uniform(-1, 1, a.n), rng.uniform(-1, 1, (a.n, 3))
    np.testing.assert_allclose(_port_solver(a, 16).solve(b), reference_solve(a, b), **TOL)
    np.testing.assert_allclose(_port_solver(a, 16).solve(panel), reference_solve(a, panel),
                               **TOL)
    xt = _port_solver(a, 16, transpose=True).solve(b)
    np.testing.assert_allclose(
        xt, spla.spsolve_triangular(to_scipy(a).T.tocsr(), b, lower=False), **TOL)


def test_plan_from_arrays_solves_like_the_reference():
    """The port's executor on the reference's own plan gives the bits of the
    reference executor and of the port's plan builder."""
    a = strategies.EXACT_MATRICES["skewed"]()
    for form in ("forward", "transpose", "panel"):
        plan = build_plan(a, 1, SolverConfig(block_size=8, kernel_backend="reference"),
                          transpose=form == "transpose")
        x = tsolver.Solver(tsolver.plan_from_arrays(flatten_plan(plan)), "cpu").solve(
            _rhs(a.n, form))
        np.testing.assert_array_equal(x, _reference_solve("skewed", 8, form))


@pytest.mark.parametrize("build,b,expect", [
    (strategies.empty_matrix, np.zeros(0), np.zeros(0)),
    (strategies.diagonal_matrix, np.arange(1.0, 25.0), np.arange(1.0, 25.0) / 2.0),
    (strategies.single_entry_matrix, np.array([6.0]), np.array([2.0])),
])
def test_degenerate_matrices_solve(build, b, expect):
    a = to_torch_csr(build())
    for kernel in (None, "cuda"):
        solver = _port_solver(a, 8, kernel=kernel)
        np.testing.assert_array_equal(solver.solve(b), expect.astype(np.float32))
    x = _port_solver(a, 8).solve(np.zeros((a.n, 3)))
    assert x.shape == (a.n, 3)


def test_single_row_block():
    a = strategies.random_triangular(n=5, seed=0, m=8)
    b = np.arange(1.0, 6.0)
    solver = _port_solver(a, 8)
    assert solver.plan.bs.nb == 1 and solver.plan.n_levels == 1
    np.testing.assert_allclose(solver.solve(b), reference_solve(a, b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw,n_devices", [({"sched": "syncfree"}, 1),
                                          ({"kernel_backend": "fused_streamed"}, 2),
                                          ({}, 2)])
def test_unported_executors_raise(kw, n_devices):
    """Executors once refused now run. The one-device syncfree plan gives
    the reference's bits. Multi-device plans (``comm="zerocopy"`` here)
    run on a group of ``n_devices`` ranks (``tests/test_torch_zerocopy.py``);
    without one they raise ``ValueError`` asking for it."""
    a = to_torch_csr(strategies.EXACT_MATRICES["skewed"]())
    plan = tsolver.build_plan(a, n_devices, tsolver.SolverConfig(block_size=8, **kw))
    if n_devices == 1:
        for form in ("forward", "panel"):
            np.testing.assert_array_equal(tsolver.Solver(plan, "cpu").solve(_rhs(a.n, form)),
                                          _reference_solve("skewed", 8, form))
        return
    with pytest.raises(ValueError, match="group of 2 ranks"):
        tsolver.Solver(plan, "cpu")


@pytest.mark.parametrize("form", ["forward", "panel"])
def test_fused_streamed_executor_runs_and_matches_reference(form):
    """The streamed megakernel executor (plain version on the CPU) gives the
    reference switch executor's bits on a dyadic problem."""
    a = strategies.EXACT_MATRICES["skewed"]()
    solver = _port_solver(a, 8, kernel="fused_streamed")
    assert solver.backend == "fused_streamed"
    np.testing.assert_array_equal(solver.solve(_rhs(a.n, form)),
                                  _reference_solve("skewed", 8, form))


def test_solver_refresh_and_structural_check():
    a = strategies.SOLVER_MATRICES["levelled"]()
    a2 = CSR(n=a.n, row_ptr=a.row_ptr, col_idx=a.col_idx,
             val=a.val * (1.0 + 0.25 * np.sin(np.arange(a.nnz))))
    cfg = tsolver.SolverConfig(block_size=16)
    solver = tsolver.Solver(tsolver.build_plan(to_torch_csr(a), 1, cfg), "cpu")
    b = np.random.default_rng(7).uniform(-1, 1, a.n)
    solver.solve(b)
    solver.refresh(tsolver.refresh_plan(solver.plan, to_torch_csr(a2)))
    fresh = tsolver.Solver(tsolver.build_plan(to_torch_csr(a2), 1, cfg), "cpu")
    np.testing.assert_array_equal(solver.solve(b), fresh.solve(b))
    assert solver.n_solves == 2
    other = tsolver.build_plan(tsuite.random_levelled(400, 24, 4.0, seed=9), 1, cfg)
    with pytest.raises(ValueError, match="identical symbolic schedule"):
        solver.refresh(other)


def test_solve_local_matches_solver():
    a = to_torch_csr(strategies.EXACT_MATRICES["banded"]())
    plan = tsolver.build_plan(a, 1, tsolver.SolverConfig(block_size=8))
    b = _rhs(a.n, "forward")
    xb = tsolver.solve_local(plan, torch.from_numpy(pad_rhs(b, plan.bs)))
    np.testing.assert_array_equal(unpad_x(xb.numpy(), plan.bs),
                                  tsolver.Solver(plan, "cpu").solve(b))


# ---------------------------------------------------------------------------
# session: the counters tests/test_api.py pins for the reference
# ---------------------------------------------------------------------------


def _matrix(seed=0, n=400, levels=16):
    return tsuite.random_levelled(n, levels, 4.0, seed=seed)


def _revalued(a: CSR, scale=None) -> CSR:
    if scale is None:
        scale = 1.0 + 0.25 * np.sin(np.arange(a.nnz))
    return CSR(n=a.n, row_ptr=a.row_ptr, col_idx=a.col_idx, val=a.val * scale)


def _ctx(**kw):
    return SpTRSVContext(device="cpu", options=PlanOptions(block_size=16), **kw)


def test_analyse_once_solve_many():
    a = _matrix()
    b = np.random.default_rng(1).uniform(-1, 1, a.n)
    ctx = _ctx()
    h = ctx.analyse(a)
    np.testing.assert_allclose(ctx.solve(h, b), reference_solve(a, b), rtol=0, atol=1e-5)
    for _ in range(3):
        ctx.solve(h, b)
    assert ctx.analyse(a) is h
    st = ctx.stats()
    assert (st["analyses"], st["solves"], st["solve_cache_hits"], st["analysis_hits"]) == \
        (1, 4, 3, 1)
    assert 0 < st["cache_hit_rate"] < 1


def test_transpose_shares_analysis():
    a = _matrix()
    b = np.random.default_rng(2).uniform(-1, 1, a.n)
    ctx = _ctx()
    xt = ctx.solve(ctx.analyse(a), b, transpose=True)
    expect = spla.spsolve_triangular(to_scipy(a).T.tocsr(), b, lower=False)
    np.testing.assert_allclose(xt, expect, rtol=0, atol=1e-4)
    assert ctx.stats()["analyses"] == 1
    assert ctx.stats()["transpose_extensions"] == 1


def test_solve_accepts_matrix_directly_and_counts_shapes():
    a = _matrix()
    rng = np.random.default_rng(4)
    ctx = _ctx()
    b = rng.uniform(-1, 1, a.n)
    np.testing.assert_allclose(ctx.solve(a, b), reference_solve(a, b), rtol=0, atol=1e-5)
    h = ctx.analyse(a)
    ctx.solve(h, rng.uniform(-1, 1, (a.n, 4)))  # new shape: miss
    ctx.solve(h, rng.uniform(-1, 1, (a.n, 4)))  # same shape: hit
    st = ctx.stats()
    assert st["solve_cache_misses"] == 2 and st["solve_cache_hits"] == 1


def test_tagged_handles_do_not_alias_values():
    a = _matrix()
    a2 = _revalued(a)
    b = np.random.default_rng(5).uniform(-1, 1, a.n)
    ctx = _ctx()
    h1 = ctx.analyse(a)
    h2 = ctx.factorize(a2, tag="factor")
    assert h1 is not h2 and h1.symbolic is h2.symbolic
    assert ctx.stats()["analyses"] == 1 and ctx.stats()["symbolic_hits"] == 1
    np.testing.assert_allclose(ctx.solve(h1, b), reference_solve(a, b), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ctx.solve(h2, b), reference_solve(a2, b), rtol=0, atol=1e-5)


def test_analyse_refreshes_stale_values_on_pattern_hit():
    a = _matrix()
    b = np.random.default_rng(6).uniform(-1, 1, a.n)
    ctx = _ctx()
    ctx.solve(ctx.analyse(a), b)
    a2 = _revalued(a)
    np.testing.assert_allclose(ctx.solve(ctx.analyse(a2), b), reference_solve(a2, b),
                               rtol=0, atol=1e-5)
    assert ctx.stats()["analyses"] == 1 and ctx.stats()["factorizes"] == 1


@pytest.mark.parametrize("sched", ["levelset", "dagpart"])
def test_factorize_bit_identical_to_fresh_build(sched):
    a = _matrix()
    a2 = _revalued(a)
    opts = PlanOptions(block_size=16, sched=sched)
    b = np.random.default_rng(7).uniform(-1, 1, a.n)
    ctx = SpTRSVContext(device="cpu", options=opts)
    h = ctx.analyse(a)
    ctx.solve(h, b)
    ctx.solve(h, b, transpose=True)
    ctx.factorize(a2, h)
    for transpose in (False, True):
        fresh = tsolver.Solver(tsolver.build_plan(a2, 1, opts.to_config(),
                                                  transpose=transpose), "cpu")
        np.testing.assert_array_equal(ctx.solve(h, b, transpose=transpose), fresh.solve(b))


def test_factorize_rejects_different_pattern_and_conflicts():
    a, other = _matrix(seed=0), _matrix(seed=3)
    assert pattern_key(a) != pattern_key(other)
    ctx = _ctx()
    h = ctx.analyse(a)
    with pytest.raises(ValueError, match="pattern"):
        ctx.factorize(other, h)
    with pytest.raises(ValueError, match="tag"):
        ctx.factorize(a, h, tag="other")
    with pytest.raises(ValueError, match="options"):
        ctx.factorize(a, h, options=PlanOptions(block_size=8))


def test_cache_capacity_evicts_lru_with_counter():
    mats = [strategies.dyadic(tsuite.random_levelled(96, 6, 3.0, seed=s)) for s in (1, 2, 3)]
    ctx = _ctx(cache_capacity=2)
    b = [strategies.dyadic_rhs(m.n) for m in mats]
    h0 = ctx.analyse(mats[0])
    ctx.solve(h0, b[0])
    ctx.solve(ctx.analyse(mats[1]), b[1])
    ctx.solve(h0, b[0])  # touch pattern 0: pattern 1 becomes the LRU entry
    ctx.solve(ctx.analyse(mats[2]), b[2])  # evicts pattern 1
    assert ctx.stats()["evictions"] == 1 and len(ctx._entries) == 2
    analyses = ctx.stats()["analyses"]
    ctx.solve(ctx.analyse(mats[1]), b[1])  # re-enters through the symbolic cache
    s = ctx.stats()
    assert s["analyses"] == analyses and s["symbolic_hits"] >= 1 and s["evictions"] == 2
    with pytest.raises(ValueError, match="cache_capacity"):
        _ctx(cache_capacity=0)


def test_dispatch_stats_match_reference():
    from repro.api import PlanOptions as JPlanOptions, SpTRSVContext as JContext

    a = _matrix()
    ref = JContext(mesh=strategies.mesh1(), options=JPlanOptions(block_size=16))
    h = ref.analyse(a)
    stats = ref.dispatch_stats(h)
    assert stats["plan_store_hit"] is False
    ctx = _ctx()
    assert_dispatch_stats_match(stats, ref.plan(h), ctx.dispatch_stats(ctx.analyse(a)))


@pytest.mark.parametrize("field,value,expect", [
    ("comm", "bogus", "zerocopy"),
    ("sched", "wavefront", "levelset"),
    ("partition", "metis", "taskpool"),
    ("kernel", "pallas", "cuda"),
])
def test_plan_options_invalid_choice_raises_eagerly(field, value, expect):
    with pytest.raises(ValueError, match=expect):
        PlanOptions(**{field: value})
    cfg_field = "kernel_backend" if field == "kernel" else field
    with pytest.raises(ValueError, match=expect):
        tsolver.SolverConfig(**{cfg_field: value})


@pytest.mark.parametrize("field", ["sched", "comm", "kernel"])
def test_auto_is_not_ported(field):
    """``"auto"`` was refused until the auto-tuner was ported: it is now
    accepted for ``sched``, ``comm`` and ``kernel`` (resolved at analyse
    time, ``tests/test_torch_autotune.py``), and still refused for the
    partition, which is the analysis itself."""
    opts = PlanOptions(**{field: "auto"})
    assert opts.is_auto and getattr(opts, field).value == "auto"
    with pytest.raises(ValueError, match="auto options must be resolved"):
        opts.to_config()
    with pytest.raises(ValueError, match="partition"):
        PlanOptions(partition="auto")


def test_options_config_round_trip():
    cfg = tsolver.SolverConfig(block_size=16, comm="unified", sched="dagpart",
                               partition="malleable", kernel_backend="cuda",
                               tasks_per_device=4, rhs_hint=8)
    from repro_torch.api import as_options

    assert as_options(cfg).to_config() == cfg
    assert PlanOptions().to_config().kernel_backend is None
    assert port_config(SolverConfig(block_size=16)) == tsolver.SolverConfig(block_size=16)
    with pytest.raises(ValueError, match="block_size"):
        PlanOptions(block_size=0)
