"""The port's superstep megakernel on the CPU: its plain version against the
reference's Pallas kernel (interpret mode), the kernel's pull table against
the reference's push order, and the ``kernel_backend="fused"`` executor
through ``Solver``, ``SpTRSVContext`` and IC(0)-PCG.

Dyadic problems (``tests/strategies.py``) are compared bit for bit; real
values within rtol = atol = 2e-4 (float32 solves, as the reference's own
tests), PCG residual histories within rtol 1e-4 (as ``test_torch_krylov``).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import strategies
from torch_parity import flatten_plan, to_torch_csr
from repro import krylov as jkrylov
from repro.core import DistributedSolver, SolverConfig, build_plan, solve_local
from repro.core.blocking import pad_rhs
from repro.core.solver import level_widths, step_offsets
from repro.kernels.superstep import superstep_call as jax_superstep_call
from repro.sparse.matrix import reference_solve, to_scipy
from repro_torch.api import PlanOptions, SpTRSVContext
from repro_torch.core import solver as tsolver
from repro_torch.kernels import ops
from repro_torch.kernels import superstep as tss
from repro_torch.krylov import solve_ic0_pcg

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _resident_fused(monkeypatch):
    """``kernel_backend="fused"`` in this file means the resident megakernel.
    The port's rule (``core.solver.fused_streaming``) streams a plan whose
    resident store exceeds the stream limit, measured to be 0 on the card;
    the limit is raised above every plan here, so "fused" stays resident."""
    monkeypatch.setenv(tsolver.ENV_STREAM_LIMIT, str(2**62))


@functools.lru_cache(maxsize=None)
def _ref_plan(matrix: str, B: int, sched: str, transpose: bool):
    a = strategies.EXACT_MATRICES[matrix]()
    return build_plan(a, 1, SolverConfig(block_size=B, sched=sched, kernel_backend="fused"),
                      transpose=transpose)


def _rhs(n: int, R: int, seed: int = 1) -> np.ndarray:
    cols = [strategies.dyadic_rhs(n, seed=seed + k) for k in range(R)]
    return cols[0] if R == 1 else np.stack(cols, axis=1)


def _tables(plan, seg=None) -> dict:
    """The reference's eight tables and two stores of a one-device plan."""
    return dict(
        seg=np.array([0, plan.n_supersteps] if seg is None else seg, np.int32),
        off=np.asarray(plan.lvl_off, np.int32), wid=level_widths(plan).astype(np.int32),
        sr=plan.solve_rows[0], ut=plan.upd_tiles[0], trow=plan.tile_row[0],
        tcol=plan.tile_col[0], diag=plan.diag, tiles=plan.tiles[0],
        stp=step_offsets(plan))


def _jax_kernel(tab, b_pad, acc, x):
    """The reference's resident kernel, in interpret mode."""
    j = {k: jnp.asarray(v) for k, v in tab.items()}
    acc, x = jax_superstep_call(
        j["seg"], j["off"], j["wid"], j["sr"], j["ut"], j["trow"], j["tcol"], j["diag"],
        j["tiles"], jnp.asarray(b_pad), jnp.asarray(acc), jnp.asarray(x), stp=j["stp"],
        grid=max(1, int(tab["seg"][1])), interpret=True)
    return np.asarray(acc), np.asarray(x)


def _port_kernel(tab, b_pad, acc, x):
    """The port's wrapper on CPU tensors (its plain version)."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tab.items()}
    acc, x = tss.superstep_call(
        t["seg"], t["off"], t["wid"], t["sr"], t["ut"], t["trow"], t["tcol"], t["diag"],
        t["tiles"], torch.from_numpy(b_pad), torch.from_numpy(acc), torch.from_numpy(x),
        stp=t["stp"], flags=tss.ReadyFlags(tab["diag"].shape[0], "cpu"))
    return acc.numpy(), x.numpy()


def _table(tab):
    return tss.superstep_table(tab["seg"], tab["off"], tab["wid"], tab["sr"], tab["ut"],
                               tab["trow"], tab["tcol"], n_rows=tab["diag"].shape[0],
                               stp=tab["stp"])


def _tile_product(tile, xv):
    """One tile product, the same float32 arithmetic in both emulations."""
    return (tile.astype(np.float32) @ xv.astype(np.float32)).astype(np.float32)


def _solve_tile(L, rhs):
    return np.linalg.solve(L.astype(np.float64), rhs.astype(np.float64)).astype(np.float32)


def _push_emulation(tab, b_pad, acc, x):
    """The reference kernel's order, line for line, in numpy float32."""
    acc, x = acc.copy(), x.copy()
    stp, off, wid = tab["stp"], tab["off"], tab["wid"]
    s0, n = tab["seg"]
    for t in range(stp[s0], stp[s0 + n]):
        for r in tab["sr"][off[t, 0]:off[t, 0] + wid[t, 0]]:
            if r >= 0:
                x[r] = _solve_tile(tab["diag"][r], b_pad[r] - acc[r])
        for tid in tab["ut"][off[t, 1]:off[t, 1] + wid[t, 1]]:
            rd = tab["trow"][tid]
            if rd != acc.shape[0] - 1:  # the kernel leaves the pad row out
                acc[rd] = acc[rd] + _tile_product(tab["tiles"][tid], x[tab["tcol"][tid]])
    return acc, x


def _pull_emulation(tab, table, b_pad, acc_in, x_in):
    """What the CUDA kernel does with the pull table, in numpy float32."""
    acc, x = acc_in.copy(), x_in.copy()
    S = table.n_solve_slots

    def pull(target, row):
        s = acc_in[row].copy()
        for p in range(table.pull_ptr[target], table.pull_ptr[target + 1]):
            tid = table.pull_tile[p]
            assert table.pull_col[p] == tab["tcol"][tid]
            s = s + _tile_product(tab["tiles"][tid], x[table.pull_col[p]])
        acc[row] = s
        return s

    t_lo, t_hi = table.levels
    off, wid = tab["off"], tab["wid"]
    for t in range(t_lo, t_hi):
        for k in range(off[t, 0], off[t, 0] + wid[t, 0]):
            r = tab["sr"][k]
            if r >= 0:
                x[r] = _solve_tile(tab["diag"][r], b_pad[r] - pull(k, r))
    for q, r in enumerate(table.orphan_row):
        pull(S + q, r)
    return acc, x


# ---------------------------------------------------------------------------
# the plain version against the reference's kernel
# ---------------------------------------------------------------------------

CASES = [("skewed", 8, sched, transpose, R)
         for sched in ("levelset", "dagpart") for transpose in (False, True) for R in (1, 3)]
CASES += [("banded", 16, "levelset", False, 1), ("banded", 16, "dagpart", True, 3)]


@pytest.mark.parametrize("matrix,B,sched,transpose,R", CASES)
def test_plain_version_bit_identical_to_reference_kernel(matrix, B, sched, transpose, R):
    plan = _ref_plan(matrix, B, sched, transpose)
    tab = _tables(plan)
    rhs = _rhs(plan.bs.n, R)
    if transpose:
        rhs = rhs[::-1].copy()
    b_blocks = pad_rhs(rhs, plan.bs)
    b_pad = np.concatenate([b_blocks, np.zeros((1,) + b_blocks.shape[1:], np.float32)])
    zeros = np.zeros_like(b_pad)
    want_acc, want_x = _jax_kernel(tab, b_pad, zeros, zeros)
    acc, x = _port_kernel(tab, b_pad, zeros, zeros)
    np.testing.assert_array_equal(x, want_x)
    np.testing.assert_array_equal(acc, want_acc)
    # the kernel's pull order gives the same bits on these exact problems
    p_acc, p_x = _pull_emulation(tab, _table(tab), b_pad, zeros, zeros)
    np.testing.assert_array_equal(p_x, want_x)
    np.testing.assert_array_equal(p_acc, want_acc)


def test_partial_segment_with_carries_matches_reference_kernel():
    """A launch over supersteps 2..5 of the plan with non-zero carries:
    orphan rows and rows copied through behave as the reference's."""
    plan = _ref_plan("skewed", 8, "levelset", False)
    tab = _tables(plan, seg=(2, 4))
    rng = np.random.default_rng(5)
    shape = (plan.bs.nb + 1, plan.bs.B)
    b_pad, acc, x = (rng.integers(-3, 4, shape).astype(np.float32) for _ in range(3))
    want_acc, want_x = _jax_kernel(tab, b_pad, acc, x)
    got_acc, got_x = _port_kernel(tab, b_pad, acc, x)
    np.testing.assert_array_equal(got_x, want_x)
    np.testing.assert_array_equal(got_acc, want_acc)
    table = _table(tab)
    assert table.n_orphans > 0 and table.n_copy > 1
    p_acc, p_x = _pull_emulation(tab, table, b_pad, acc, x)
    np.testing.assert_array_equal(p_x[:-1], want_x[:-1])
    np.testing.assert_array_equal(p_acc[:-1], want_acc[:-1])


@pytest.mark.parametrize("sched,seg", [("levelset", None), ("dagpart", None),
                                       ("dagpart", (1, 2))])
def test_pull_order_is_the_reference_push_order_on_real_values(sched, seg):
    """With each tile product computed the same way, summing in the pull
    table's order gives the reference's push order bit for bit on real
    values: the order, not only the set, of contributions is the same."""
    a = strategies.SOLVER_MATRICES["levelled"]()
    plan = build_plan(a, 1, SolverConfig(block_size=16, sched=sched))
    tab = _tables(plan, seg)
    rng = np.random.default_rng(11)
    shape = (plan.bs.nb + 1, plan.bs.B)
    b_pad = rng.uniform(-1, 1, shape).astype(np.float32)
    acc, x = (rng.uniform(-1, 1, shape).astype(np.float32) for _ in range(2))
    acc[-1] = x[-1] = 0.0
    want_acc, want_x = _push_emulation(tab, b_pad, acc, x)
    got_acc, got_x = _pull_emulation(tab, _table(tab), b_pad, acc, x)
    np.testing.assert_array_equal(got_x, want_x)
    np.testing.assert_array_equal(got_acc, want_acc)


def test_table_rejects_schedules_the_pull_order_cannot_run():
    plan = _ref_plan("skewed", 8, "levelset", False)
    tab = _tables(plan)
    n_rows = tab["diag"].shape[0]
    args = [tab[k] for k in ("seg", "off", "wid", "sr", "ut", "trow", "tcol")]
    with pytest.raises(ValueError, match="outside"):
        tss.superstep_table(np.array([0, plan.n_supersteps + 1]), *args[1:], n_rows=n_rows)
    twice = tab["sr"].copy()
    twice[tab["off"][1, 0]] = twice[tab["off"][0, 0]]
    with pytest.raises(ValueError, match="solved twice"):
        tss.superstep_table(*args[:3], twice, *args[4:], n_rows=n_rows)
    late = tab["tcol"].copy()  # a level-0 tile reading the row solved last
    late[tab["ut"][0]] = tab["sr"][tab["off"][-1, 0]]
    with pytest.raises(ValueError, match="later level"):
        tss.superstep_table(*args[:6], late, n_rows=n_rows)
    early = tab["trow"].copy()  # a level-0 tile updating a level-0 row
    early[tab["ut"][0]] = tab["sr"][0]
    with pytest.raises(ValueError, match="at or after"):
        tss.superstep_table(*args[:5], early, args[6], n_rows=n_rows)


@pytest.mark.parametrize("sched,seg", [("levelset", (2, 4)), ("dagpart", (1, 2)),
                                       ("levelset", None)])
def test_pull_wait_marks_the_rows_the_launch_solves(sched, seg):
    """A pull waits for its source row's flag exactly when the launch solves
    that row, also for a launch that starts mid-plan."""
    plan = build_plan(strategies.SOLVER_MATRICES["levelled"](), 1,
                      SolverConfig(block_size=16, sched=sched))
    tab = _tables(plan, seg)
    table = _table(tab)
    t_lo, t_hi = table.levels
    solved = np.concatenate([tab["sr"][tab["off"][t, 0]:tab["off"][t, 0] + tab["wid"][t, 0]]
                             for t in range(t_lo, t_hi)])
    want = np.isin(table.pull_col, solved[solved >= 0]).astype(np.int32)
    assert table.pull_wait.dtype == np.int32 and table.pull_wait.shape == table.pull_col.shape
    np.testing.assert_array_equal(table.pull_wait, want)


def test_pulls_from_rows_solved_by_an_earlier_launch_never_wait():
    """Rows solved before the launch (here level 0's, made pads) are copy
    rows: every pull from one is marked not to wait, the others to wait."""
    plan = _ref_plan("skewed", 8, "levelset", False)
    tab = _tables(plan)
    first = slice(tab["off"][0, 0], tab["off"][0, 0] + tab["wid"][0, 0])
    earlier = tab["sr"][first][tab["sr"][first] >= 0]
    sr = tab["sr"].copy()
    sr[first] = -1
    table = _table({**tab, "sr": sr})
    from_earlier = np.isin(table.pull_col, earlier)
    assert from_earlier.any() and not from_earlier.all()
    np.testing.assert_array_equal(table.pull_wait, (~from_earlier).astype(np.int32))
    assert set(earlier) <= set(table.copy_row.tolist())


def test_resident_shared_memory_rule():
    """Per warp: three prefetch stages of 33 * 32 floats and three columns
    of B floats; every B the resident form takes (up to 1055) fits."""
    for B in (1, 7, 16, 32, 64, 1055):
        assert tss.shared_bytes(B) == 4 * 8 * (3 * 1056 + 3 * B) <= tss.SHARED_LIMIT
    plan = tsolver.plan_from_arrays(flatten_plan(_ref_plan("skewed", 8, "levelset", False)))
    assert (tsolver.fused_vmem_bytes(plan) == tsolver.dispatch_stats(plan)["fused_vmem_bytes"]
            == tss.shared_bytes(8) == 4 * 8 * (3 * 1056 + 24))


def test_ready_flags_shape_epoch_and_wrap():
    """One int32 flag per (block row, column) for each R, zeroed at first
    use; each launch a fresh epoch; past the limit every array is zeroed and
    the count starts again at 1."""
    solver = _port_solver("skewed", 8, "levelset", False, "fused")
    ready = solver._fused.flags
    n_rows = solver.plan.bs.nb + 1
    assert ready.n_rows == n_rows and ready.device.type == "cpu" and ready.epoch == 0
    for R in (1, 3):
        f = ready.flags(R)
        assert f.shape == (n_rows * R,) and f.dtype == torch.int32 and not f.any()
    flags, epoch = ready.next(3)
    assert flags is ready.flags(3) and epoch == 1
    assert ready.next(1) == (ready.flags(1), 2)
    for f in (ready.flags(1), ready.flags(3)):
        f.fill_(7)
    ready.epoch = tss.EPOCH_LIMIT - 1
    assert ready.next(1)[1] == tss.EPOCH_LIMIT and ready.flags(3).eq(7).all()
    assert ready.next(1)[1] == 1
    assert not ready.flags(1).any() and not ready.flags(3).any()


def test_wrapper_checks_the_flags():
    plan = _ref_plan("skewed", 8, "levelset", False)
    tab = _tables(plan)
    rng = np.random.default_rng(3)
    shape = (plan.bs.nb + 1, plan.bs.B)
    b_pad = rng.integers(-3, 4, shape).astype(np.float32)
    zeros = np.zeros(shape, np.float32)
    want = _port_kernel(tab, b_pad, zeros, zeros)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tab.items()}

    def call(flags):
        return tss.superstep_call(
            t["seg"], t["off"], t["wid"], t["sr"], t["ut"], t["trow"], t["tcol"], t["diag"],
            t["tiles"], torch.from_numpy(b_pad), torch.zeros(shape), torch.zeros(shape),
            stp=t["stp"], flags=flags)

    with pytest.raises(TypeError, match="ReadyFlags"):
        call(torch.zeros(shape[0], dtype=torch.int32))
    with pytest.raises(TypeError, match="ReadyFlags"):
        call(None)  # every caller keeps its own flags
    with pytest.raises(ValueError, match="rows"):
        call(tss.ReadyFlags(shape[0] - 1, "cpu"))
    with pytest.raises(ValueError, match="rows"):
        call(tss.ReadyFlags(shape[0], "meta"))
    got = call(tss.ReadyFlags(shape[0], "cpu"))
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[0].numpy(), want[0])


# ---------------------------------------------------------------------------
# the fused executor
# ---------------------------------------------------------------------------


def _port_solver(matrix, B, sched, transpose, kernel):
    """The port's Solver on the reference's plan, with ``kernel`` as its
    backend."""
    fields = flatten_plan(_ref_plan(matrix, B, sched, transpose))
    fields["config.kernel_backend"] = kernel
    return tsolver.Solver(tsolver.plan_from_arrays(fields), "cpu")


@pytest.mark.parametrize("matrix", sorted(strategies.EXACT_MATRICES))
@pytest.mark.parametrize("B", [8, 16])
@pytest.mark.parametrize("sched", ["levelset", "dagpart"])
@pytest.mark.parametrize("form", ["forward", "transpose", "panel"])
def test_fused_solver_bit_identical_to_switch_executor_and_oracle(matrix, B, sched, form):
    """The fused Solver, on the reference's own plan (``plan_from_arrays``),
    gives the port's switch executor's bits and the exact float64 answer."""
    transpose = form == "transpose"
    fused = _port_solver(matrix, B, sched, transpose, "fused")
    switch = _port_solver(matrix, B, sched, transpose, None)
    assert fused.backend == "fused" and fused.plan.config.kernel_backend == "fused"
    a = strategies.EXACT_MATRICES[matrix]()
    b = _rhs(a.n, 3 if form == "panel" else 1)
    x = fused.solve(b)
    np.testing.assert_array_equal(x, switch.solve(b))
    oracle = (spla.spsolve_triangular(to_scipy(a).T.tocsr(), b, lower=False) if transpose
              else reference_solve(a, b))
    np.testing.assert_array_equal(x, oracle.astype(np.float32))


@pytest.mark.parametrize("sched", ["levelset", "dagpart"])
def test_fused_solve_local_bit_identical_to_reference_fused_branch(sched):
    plan = _ref_plan("banded", 8, sched, False)
    b = strategies.dyadic_rhs(plan.bs.n)
    b_blocks = pad_rhs(b, plan.bs)
    want = np.asarray(solve_local(plan, jnp.asarray(b_blocks)))
    port_plan = tsolver.plan_from_arrays(flatten_plan(plan))
    got = tsolver.solve_local(port_plan, torch.from_numpy(b_blocks))
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_session_real_values_within_tolerance_of_scipy():
    a = to_torch_csr(strategies.SOLVER_MATRICES["levelled"]())
    rng = np.random.default_rng(3)
    b, panel = rng.uniform(-1, 1, a.n), rng.uniform(-1, 1, (a.n, 3))
    for sched in ("levelset", "dagpart"):
        ctx = SpTRSVContext(device="cpu",
                            options=PlanOptions(block_size=16, sched=sched, kernel="fused"))
        h = ctx.analyse(a)
        np.testing.assert_allclose(ctx.solve(h, b), reference_solve(a, b), **TOL)
        np.testing.assert_allclose(ctx.solve(h, panel), reference_solve(a, panel), **TOL)
        np.testing.assert_allclose(
            ctx.solve(h, b, transpose=True),
            spla.spsolve_triangular(to_scipy(a).T.tocsr(), b, lower=False), **TOL)
        assert ctx.executor(h).backend == "fused"
        assert ctx.dispatch_stats(h)["fused_launches"] == 1


@pytest.mark.parametrize("build,b,expect", [
    (strategies.empty_matrix, np.zeros(0), np.zeros(0)),
    (strategies.single_entry_matrix, np.array([6.0]), np.array([2.0])),
])
def test_fused_degenerate_plans(build, b, expect):
    a = to_torch_csr(build())
    solver = tsolver.Solver(tsolver.build_plan(
        a, 1, tsolver.SolverConfig(block_size=8, kernel_backend="fused")), "cpu")
    np.testing.assert_array_equal(solver.solve(b), expect.astype(np.float32))
    assert solver.solve(np.zeros((a.n, 2))).shape == (a.n, 2)


def test_fused_zero_level_table_has_no_work():
    plan = tsolver.build_plan(to_torch_csr(strategies.empty_matrix()), 1,
                              tsolver.SolverConfig(block_size=8, kernel_backend="fused"))
    assert plan.n_levels == 0
    table = tss.superstep_table([0, 0], plan.lvl_off, tsolver.level_widths(plan),
                                plan.solve_rows[0], plan.upd_tiles[0], plan.tile_row[0],
                                plan.tile_col[0], n_rows=plan.bs.nb + 1)
    assert table.levels == (0, 0) and table.max_items == 0 and table.n_orphans == 0


def test_fused_single_row_block():
    a = to_torch_csr(strategies.random_triangular(n=5, seed=0, m=8))
    b = np.arange(1.0, 6.0)
    solver = tsolver.Solver(tsolver.build_plan(
        a, 1, tsolver.SolverConfig(block_size=8, kernel_backend="fused")), "cpu")
    assert solver.plan.bs.nb == 1 and solver.plan.n_levels == 1
    np.testing.assert_allclose(solver.solve(b), reference_solve(a, b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw,n_devices", [
    ({"kernel_backend": "fused_streamed", "sched": "syncfree"}, 1),
    ({"kernel_backend": "fused", "sched": "syncfree"}, 1),
    ({"kernel_backend": "fused"}, 2),
    ({"kernel_backend": "fused_streamed"}, 2),
])
def test_unported_fused_forms_raise(kw, n_devices):
    """Forms once refused now run. One-device syncfree plans under a fused
    backend run the syncfree executor's frontier form and give the
    reference's (its own frontier form) bit for bit. Multi-device fused
    plans (``comm="zerocopy"``, one split launch per exchange segment) run
    on a group of ``n_devices`` ranks (``tests/test_torch_zerocopy.py``):
    without one they raise ``ValueError`` asking for it."""
    a = to_torch_csr(strategies.EXACT_MATRICES["skewed"]())
    plan = tsolver.build_plan(a, n_devices, tsolver.SolverConfig(block_size=8, **kw))
    if n_devices == 1:
        ref_plan = build_plan(strategies.EXACT_MATRICES["skewed"](), 1,
                              SolverConfig(block_size=8, **kw))
        b = _rhs(plan.bs.n, 3)
        solver = tsolver.Solver(plan, "cpu")
        assert solver._syncfree.frontier
        np.testing.assert_array_equal(
            solver.solve(b), DistributedSolver(ref_plan, strategies.mesh1()).solve(b))
        return
    with pytest.raises(ValueError, match="group of 2 ranks"):
        tsolver.Solver(plan, "cpu")


def test_fused_streamed_form_runs_and_matches_the_reference():
    """``kernel_backend="fused_streamed"`` executes (one streamed launch per
    solve) and gives the reference's fused solve bit for bit."""
    plan = _ref_plan("skewed", 8, "levelset", False)
    b_blocks = pad_rhs(strategies.dyadic_rhs(plan.bs.n), plan.bs)
    want = np.asarray(solve_local(plan, jnp.asarray(b_blocks)))
    fields = flatten_plan(plan)
    fields["config.kernel_backend"] = "fused_streamed"
    solver = tsolver.Solver(tsolver.plan_from_arrays(fields), "cpu")
    assert solver.backend == "fused_streamed" and solver._fused.layout is not None
    np.testing.assert_array_equal(solver.solve_blocks(torch.from_numpy(b_blocks)).numpy(), want)


def test_per_op_calls_under_fused_raise_and_spmv_keeps_the_gemv():
    """Per-op calls under a fused backend run the device's default backend,
    as the reference's do (the two packages agree bit for bit on a dyadic
    batch); the SpMV keeps the GEMV; the megakernels are counted."""
    from repro.kernels import ops as jops

    cpu = torch.device("cpu")
    rng = np.random.default_rng(2)
    tiles = rng.integers(-2, 3, (3, 8, 8)).astype(np.float32)
    xs = rng.integers(-4, 5, (3, 8)).astype(np.float32)
    got = ops.batched_block_gemv(torch.from_numpy(tiles), torch.from_numpy(xs), backend="fused")
    want = jops.batched_block_gemv(jnp.asarray(tiles), jnp.asarray(xs), backend="fused")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ops.op_backend("fused", cpu) == ops.op_backend("fused_streamed", cpu) == "reference"
    assert ops.op_backend("cuda", cpu) == "cuda"
    assert "superstep" in ops.launch_counts()


def test_fused_ic0_pcg_matches_reference():
    """Two fused solves per iteration; the reference runs its switch executor
    with XLA block ops (interpret mode would be slow)."""
    ja, b, full = strategies.spd_problem(side=18, seed=0)
    want = jkrylov.solve_ic0_pcg(ja, b, mesh=strategies.mesh1(), tol=1e-8,
                                 config=SolverConfig(block_size=16, kernel_backend="reference"))
    got = solve_ic0_pcg(to_torch_csr(ja), b, device="cpu",
                        config=PlanOptions(block_size=16, kernel="fused"), tol=1e-8)
    assert got.converged and got.n_iters == want.n_iters
    np.testing.assert_allclose(got.history, want.history, rtol=1e-4, atol=1e-12)
    np.testing.assert_allclose(got.x, spla.spsolve(full, b), rtol=1e-5, atol=1e-5)
    fwd, bwd = got.info["forward"], got.info["backward"]
    assert fwd.backend == bwd.backend == "fused"
    assert fwd.n_solves == bwd.n_solves == got.n_iters
