"""The port's streamed superstep megakernel on the CPU: the host-side stream
helpers byte-identical to the reference's, the streamed store's layout,
its plain version against the reference's resident Pallas kernel
(interpret mode; the reference's streamed kernel does not run on the
installed jax, and its own contract makes streamed, resident and switch
execution bit-identical), and ``kernel_backend="fused_streamed"`` through
``Solver``, refresh, ``SpTRSVContext`` and IC(0)-PCG; plus a switch solve
with ``gemv_group > 1``.

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
from torch_parity import (
    SHARED_LIMIT, flatten_plan, hopper_fused_stats, port_config, stream_chunk_bytes,
    stream_chunk_rows, stream_chunk_warps, to_torch_csr,
)
from repro import krylov as jkrylov
from repro.core import DistributedSolver, SolverConfig, build_plan
from repro.core import solver as jsolver
from repro.core.blocking import pad_rhs
from repro.kernels.superstep import superstep_call as jax_superstep_call
from repro.sparse.matrix import CSR, reference_solve, to_scipy
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
def _ref_plan(matrix: str, B: int, sched: str, transpose: bool, kernel: str = "fused"):
    a = strategies.EXACT_MATRICES[matrix]()
    return build_plan(a, 1, SolverConfig(block_size=B, sched=sched, kernel_backend=kernel),
                      transpose=transpose)


def _rhs(n: int, R: int, seed: int = 1) -> np.ndarray:
    cols = [strategies.dyadic_rhs(n, seed=seed + k) for k in range(R)]
    return cols[0] if R == 1 else np.stack(cols, axis=1)


def _tables(plan, seg=None) -> dict:
    return dict(
        seg=np.array([0, plan.n_supersteps] if seg is None else seg, np.int32),
        off=np.asarray(plan.lvl_off, np.int32),
        wid=jsolver.level_widths(plan).astype(np.int32), sr=plan.solve_rows[0],
        ut=plan.upd_tiles[0], trow=plan.tile_row[0], tcol=plan.tile_col[0],
        stp=jsolver.step_offsets(plan))


def _b_pad(plan, rhs):
    blocks = pad_rhs(np.asarray(rhs, np.float32), plan.bs)
    return np.concatenate([blocks, np.zeros((1,) + blocks.shape[1:], np.float32)])


def _jax_resident(plan, tab, b_pad, acc, x):
    """The reference's resident kernel, in interpret mode."""
    j = {k: jnp.asarray(v) for k, v in tab.items()}
    acc, x = jax_superstep_call(
        j["seg"], j["off"], j["wid"], j["sr"], j["ut"], j["trow"], j["tcol"],
        jnp.asarray(plan.diag), jnp.asarray(plan.tiles[0]), jnp.asarray(b_pad),
        jnp.asarray(acc), jnp.asarray(x), stp=j["stp"], grid=max(1, int(tab["seg"][1])),
        interpret=True)
    return np.asarray(acc), np.asarray(x)


def _layout(plan, tab):
    return tss.streamed_layout(tab["seg"], tab["off"], tab["wid"], tab["sr"], tab["ut"],
                               tab["trow"], tab["tcol"], n_rows=plan.bs.nb + 1, stp=tab["stp"])


def _port_streamed(plan, tab, b_pad, acc, x):
    """The port's streamed wrapper on CPU tensors (its plain version)."""
    layout = _layout(plan, tab)
    values = tss.streamed_values(layout, torch.from_numpy(plan.diag),
                                 torch.from_numpy(np.ascontiguousarray(plan.tiles[0])))
    t = {k: torch.from_numpy(np.ascontiguousarray(v, np.int32)) for k, v in tab.items()}
    acc, x = tss.superstep_streamed_call(
        t["seg"], t["off"], t["wid"], t["sr"], t["ut"], t["trow"], t["tcol"], values,
        torch.from_numpy(b_pad), torch.from_numpy(acc), torch.from_numpy(x), stp=t["stp"],
        layout=layout, flags=tss.ReadyFlags(b_pad.shape[0], "cpu"))
    return acc.numpy(), x.numpy()


# ---------------------------------------------------------------------------
# host-side stream helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sched", ["levelset", "dagpart"])
@pytest.mark.parametrize("B", [8, 16])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("D", [1, 2])
def test_stream_widths_and_streamed_stores_identical_to_reference(sched, B, transpose, D):
    a = strategies.SOLVER_MATRICES["levelled"]()
    cfg = SolverConfig(block_size=B, sched=sched, kernel_backend="fused_streamed")
    ref = build_plan(a, D, cfg, transpose=transpose)
    port = tsolver.build_plan(to_torch_csr(a), D, port_config(cfg), transpose=transpose)
    assert tsolver.stream_widths(port) == jsolver.stream_widths(ref)
    for got, want in zip(tsolver.streamed_stores(port), jsolver.streamed_stores(ref)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)


def test_stream_helpers_on_a_zero_level_plan():
    a = strategies.empty_matrix()
    cfg = SolverConfig(block_size=8, kernel_backend="fused_streamed")
    ref, port = build_plan(a, 1, cfg), tsolver.build_plan(to_torch_csr(a), 1, port_config(cfg))
    assert tsolver.stream_widths(port) == jsolver.stream_widths(ref) == ((0,), (0,))
    for got, want in zip(tsolver.streamed_stores(port), jsolver.streamed_stores(ref)):
        assert np.array_equal(got, want) and got.shape == want.shape
    stats = tsolver.dispatch_stats(port)
    assert {k: stats[k] for k in hopper_fused_stats(ref)} == hopper_fused_stats(ref)


@pytest.mark.parametrize("B", [5, 8, 16])
def test_layout_puts_each_item_in_one_contiguous_run(B):
    """A slot's incoming tiles (in pull order) then its diagonal tile, slot
    after slot, so a level is one contiguous run; entries are 16-byte
    multiples with zero padding; the plain version reads every tile from
    the store."""
    plan = _ref_plan("skewed", B, "levelset", False)
    tab = _tables(plan)
    layout = _layout(plan, tab)
    table = layout.table
    S = table.n_solve_slots
    diag = torch.from_numpy(plan.diag)
    tiles = torch.from_numpy(np.ascontiguousarray(plan.tiles[0]))
    values = tss.streamed_values(layout, diag, tiles)
    assert values.shape[1] == tss.stream_tile_floats(B) and values.shape[1] % 4 == 0
    assert values.shape[1] >= B * (B + 1)
    padded = values[:, :B * (B + 1)].reshape(-1, B, B + 1)
    assert torch.all(padded[:, :, B] == 0) and torch.all(values[:, B * (B + 1):] == 0)
    for k in range(S):
        first = table.pull_ptr[k] + k
        pulls = table.pull_tile[table.pull_ptr[k]:table.pull_ptr[k + 1]]
        assert np.array_equal(layout.source[first:first + len(pulls)], plan.bs.nb + 1 + pulls)
        row = tab["sr"][k]
        assert layout.diag_entry[k] == first + len(pulls)
        assert layout.source[layout.diag_entry[k]] == (row if row >= 0 else plan.bs.nb)
    for t in range(plan.n_levels):  # a level's slots: consecutive entries
        o, w = tab["off"][t, 0], tab["wid"][t, 0]
        assert layout.diag_entry[o] - (table.pull_ptr[o + 1] - table.pull_ptr[o]) == \
            table.pull_ptr[o] + o
        assert layout.diag_entry[o + w - 1] + 1 == table.pull_ptr[o + w] + o + w
    live = tab["sr"] >= 0
    assert layout.copied_entries == int(table.pull_ptr[-1] + live.sum())
    assert layout.max_item_tiles == int((np.diff(table.pull_ptr) + live).max())
    ent = torch.from_numpy(layout.tile_entry)
    used = ent >= 0
    torch.testing.assert_close(
        tss.ref.stream_tiles(values, ent[used], B),
        tiles[torch.from_numpy(tab["ut"].astype(np.int64))[used]], rtol=0, atol=0)


def test_streamed_shape_fits_the_shared_memory():
    """Whole items while 8, 4, 2 or 1 warps of them fit; else one warp in
    chunks of whole tiles; where two stages of one tile do not fit (B >=
    170), one CTA of W warps an item in chunks of tile rows; the CTA fits at
    every B < 1056, and a call at B = 1056 is refused."""
    assert tss.streamed_shape(32, 3) == (8, 3, 32)
    assert tss.streamed_shape(32, 6) == (4, 6, 32)
    assert tss.streamed_shape(32, 100) == (1, 27, 32)
    assert tss.streamed_shape(169, 4) == (1, 1, 169)
    assert tss.streamed_shape(200, 4) == (7, 1, stream_chunk_rows(200)) == (7, 1, 100)
    for B, item in ((32, 3), (7, 2), (64, 5), (160, 1), (200, 1), (1055, 9)):
        assert tss.streamed_shared_bytes(B, item) <= tss.SHARED_LIMIT
    a = strategies.diagonal_matrix(1056)
    plan = build_plan(a, 1, SolverConfig(block_size=1056, kernel_backend="fused_streamed"))
    tab = _tables(plan)
    layout = _layout(plan, tab)
    zeros = torch.zeros(plan.bs.nb + 1, 1056)
    t = {k: torch.from_numpy(np.ascontiguousarray(v, np.int32)) for k, v in tab.items()}
    with pytest.raises(ValueError, match="block size B=1056"):
        tss.superstep_streamed_call(
            t["seg"], t["off"], t["wid"], t["sr"], t["ut"], t["trow"], t["tcol"],
            torch.zeros(layout.source.shape[0], tss.stream_tile_floats(1056)), zeros, zeros,
            zeros, stp=t["stp"], layout=layout, flags=tss.ReadyFlags(zeros.shape[0], "cpu"))


def test_streamed_shared_memory_rule():
    """Per warp: two mbarriers, two stages of the widest item's padded
    tiles and three columns of B floats (the row's sum and two source
    columns); from B = 170 one such set of two stages of ``rows`` padded
    tile rows (as few chunks a tile as fit, evened out) for the CTA, whose W
    warps share it; the widest
    block whose two whole tiles fit stays 169. Each chunk of an entry
    starts and ends on a 16-byte boundary, fits a stage, and the chunks
    cover the entry once (the mirror in ``tests/torch_parity.py``)."""
    for B, item in ((32, 3), (7, 2), (169, 1), (170, 1), (203, 5), (256, 2), (1055, 1)):
        warps, cap, rows = tss.streamed_shape(B, item)
        stage = cap * tss.stream_tile_floats(B) if rows == B else rows * (B + 1)
        assert tss.stage_floats(B, cap, rows) == stage
        sets = 1 if rows < B else warps  # in row chunks the CTA's warps share one set
        assert tss.streamed_shared_bytes(B, item) == sets * (16 + 2 * 4 * stage + 12 * B)
        assert (rows < B) == (B >= 170)
        chunks = [(4 * f, 4 * t) for f, t in tss.stream_chunks(B, rows)]
        if rows < B:
            assert (warps, cap, rows) == (stream_chunk_warps(B), 1, stream_chunk_rows(B))
            assert rows % 4 == 0
            assert chunks == stream_chunk_bytes(B)
        assert chunks[0][0] == 0 and chunks[-1][1] == 4 * tss.stream_tile_floats(B)
        assert all(t0 == f1 for (_, t0), (f1, _) in zip(chunks, chunks[1:]))
        assert all(f % 16 == 0 and t % 16 == 0 and 0 < t - f <= 4 * stage for f, t in chunks)
    assert tss.streamed_shared_bytes(32, 3) == 8 * (16 + 2 * 3 * 4 * 1056 + 12 * 32) == 205_952
    assert tss.streamed_shared_bytes(169, 1) == 16 + 2 * 4 * 28_732 + 12 * 169 <= SHARED_LIMIT
    assert tss.streamed_shared_bytes(170, 1) == 16 + 2 * 4 * 88 * 171 + 12 * 170 <= SHARED_LIMIT
    assert 16 + 2 * 4 * tss.stream_tile_floats(170) + 12 * 170 > SHARED_LIMIT


def test_streamed_layout_table_carries_the_wait_marks():
    plan = _ref_plan("skewed", 8, "dagpart", False)
    tab = _tables(plan)
    layout = _layout(plan, tab)
    resident = tss.superstep_table(tab["seg"], tab["off"], tab["wid"], tab["sr"], tab["ut"],
                                   tab["trow"], tab["tcol"], n_rows=plan.bs.nb + 1,
                                   stp=tab["stp"])
    np.testing.assert_array_equal(layout.table.pull_wait, resident.pull_wait)
    assert layout.table.pull_wait.all()  # the whole plan in one launch: every source solved
    on_dev = layout.to("cpu")
    assert on_dev.table.pull_wait.dtype == torch.int32


def test_streamed_wrapper_checks_the_flags():
    plan = _ref_plan("skewed", 8, "levelset", False)
    tab = _tables(plan)
    layout = _layout(plan, tab)
    values = tss.streamed_values(layout, torch.from_numpy(plan.diag),
                                 torch.from_numpy(np.ascontiguousarray(plan.tiles[0])))
    t = {k: torch.from_numpy(np.ascontiguousarray(v, np.int32)) for k, v in tab.items()}
    shape = (plan.bs.nb + 1, plan.bs.B)
    b_pad = torch.from_numpy(_b_pad(plan, _rhs(plan.bs.n, 1)))

    def call(flags):
        return tss.superstep_streamed_call(
            t["seg"], t["off"], t["wid"], t["sr"], t["ut"], t["trow"], t["tcol"], values,
            b_pad, torch.zeros(shape), torch.zeros(shape), stp=t["stp"], layout=layout,
            flags=flags)

    with pytest.raises(TypeError, match="ReadyFlags"):
        call(object())
    with pytest.raises(ValueError, match="rows"):
        call(tss.ReadyFlags(shape[0] + 1, "cpu"))
    with pytest.raises(TypeError, match="ReadyFlags"):
        call(None)  # every caller keeps its own flags
    got = call(tss.ReadyFlags(shape[0], "cpu"))
    want = _port_streamed(plan, tab, b_pad.numpy(), np.zeros(shape, np.float32),
                          np.zeros(shape, np.float32))
    assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# the plain version against the reference's kernel
# ---------------------------------------------------------------------------

CASES = [("skewed", 8, sched, transpose, R)
         for sched in ("levelset", "dagpart") for transpose in (False, True) for R in (1, 3)]
CASES += [("banded", 16, "levelset", False, 1), ("banded", 16, "dagpart", True, 3),
          ("skewed", 5, "levelset", False, 1), ("banded", 7, "dagpart", False, 3)]


@pytest.mark.parametrize("matrix,B,sched,transpose,R", CASES)
def test_streamed_plain_bit_identical_to_reference_kernel(matrix, B, sched, transpose, R):
    plan = _ref_plan(matrix, B, sched, transpose)
    tab = _tables(plan)
    rhs = _rhs(plan.bs.n, R)
    b_pad = _b_pad(plan, rhs[::-1].copy() if transpose else rhs)
    zeros = np.zeros_like(b_pad)
    want_acc, want_x = _jax_resident(plan, tab, b_pad, zeros, zeros)
    acc, x = _port_streamed(plan, tab, b_pad, zeros, zeros)
    np.testing.assert_array_equal(x, want_x)
    np.testing.assert_array_equal(acc, want_acc)


def test_streamed_partial_segment_with_carries_matches_reference_kernel():
    """Supersteps 2..5 with non-zero carries: orphans get their own store
    entries and rows copied through keep the carries."""
    plan = _ref_plan("skewed", 8, "levelset", False)
    tab = _tables(plan, seg=(2, 4))
    rng = np.random.default_rng(5)
    shape = (plan.bs.nb + 1, plan.bs.B)
    b_pad, acc, x = (rng.integers(-3, 4, shape).astype(np.float32) for _ in range(3))
    layout = _layout(plan, tab)
    assert layout.table.n_orphans > 0
    want_acc, want_x = _jax_resident(plan, tab, b_pad, acc, x)
    got_acc, got_x = _port_streamed(plan, tab, b_pad, acc, x)
    np.testing.assert_array_equal(got_x, want_x)
    np.testing.assert_array_equal(got_acc, want_acc)


def test_streamed_plain_bit_identical_to_resident_plain_on_real_values():
    """Same tensors to the same operations: the two plain versions agree bit
    for bit on real values too."""
    a = strategies.SOLVER_MATRICES["levelled"]()
    plan = build_plan(a, 1, SolverConfig(block_size=16, sched="dagpart"))
    tab = _tables(plan)
    rng = np.random.default_rng(8)
    b_pad = _b_pad(plan, rng.uniform(-1, 1, (a.n, 2)))
    zeros = np.zeros_like(b_pad)
    t = {k: torch.from_numpy(np.ascontiguousarray(v, np.int32)) for k, v in tab.items()}
    want = tss.ref.superstep_ref(t["seg"], t["off"], t["wid"], t["sr"], t["ut"], t["trow"],
                                 t["tcol"], torch.from_numpy(plan.diag),
                                 torch.from_numpy(np.ascontiguousarray(plan.tiles[0])),
                                 torch.from_numpy(b_pad), torch.from_numpy(zeros),
                                 torch.from_numpy(zeros), t["stp"])
    got = _port_streamed(plan, tab, b_pad, zeros, zeros)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())


# ---------------------------------------------------------------------------
# the fused_streamed executor
# ---------------------------------------------------------------------------


def _port_solver(matrix, B, sched, transpose, kernel):
    fields = flatten_plan(_ref_plan(matrix, B, sched, transpose))
    fields["config.kernel_backend"] = kernel
    return tsolver.Solver(tsolver.plan_from_arrays(fields), "cpu")


@pytest.mark.parametrize("matrix", sorted(strategies.EXACT_MATRICES))
@pytest.mark.parametrize("sched", ["levelset", "dagpart"])
@pytest.mark.parametrize("form", ["forward", "transpose", "panel"])
def test_streamed_solver_bit_identical_to_switch_executors(matrix, sched, form):
    """The fused_streamed Solver, on the reference's own plan, gives the
    port's resident and switch executors' bits (both bit-identical to the
    reference's, ``test_torch_superstep``/``test_torch_solve``) and the
    exact float64 answer."""
    transpose = form == "transpose"
    streamed = _port_solver(matrix, 8, sched, transpose, "fused_streamed")
    assert streamed.backend == "fused_streamed"
    a = strategies.EXACT_MATRICES[matrix]()
    b = _rhs(a.n, 3 if form == "panel" else 1)
    x = streamed.solve(b)
    for kernel in ("fused", None):
        np.testing.assert_array_equal(x, _port_solver(matrix, 8, sched, transpose,
                                                      kernel).solve(b))
    oracle = (spla.spsolve_triangular(to_scipy(a).T.tocsr(), b, lower=False) if transpose
              else reference_solve(a, b))
    np.testing.assert_array_equal(x, oracle.astype(np.float32))


@pytest.mark.parametrize("sched", ["levelset", "dagpart"])
def test_streamed_solver_bit_identical_to_resident_on_real_values(sched):
    a = to_torch_csr(strategies.SOLVER_MATRICES["levelled"]())
    rng = np.random.default_rng(3)
    b, panel = rng.uniform(-1, 1, a.n), rng.uniform(-1, 1, (a.n, 3))
    out = {}
    for kernel in ("fused", "fused_streamed"):
        ctx = SpTRSVContext(device="cpu", options=PlanOptions(block_size=16, sched=sched,
                                                              kernel=kernel))
        h = ctx.analyse(a)
        out[kernel] = (ctx.solve(h, b), ctx.solve(h, panel), ctx.solve(h, b, transpose=True))
        assert ctx.executor(h).backend == kernel
        stats = ctx.dispatch_stats(h)
        assert stats["fused_launches"] == 1 and stats["streamed"] == (kernel != "fused")
    for got, want in zip(out["fused_streamed"], out["fused"]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(out["fused_streamed"][0], reference_solve(a, b), **TOL)
    np.testing.assert_allclose(
        out["fused_streamed"][2],
        spla.spsolve_triangular(to_scipy(a).T.tocsr(), b, lower=False), **TOL)


def test_streamed_refresh_rearms_the_store():
    """A refreshed streamed solver solves with the new values (the store is
    rebuilt), as the reference's ``test_streamed_refresh_rearms_hbm_stores``
    pins."""
    a = strategies.SOLVER_MATRICES["levelled"]()
    a2 = CSR(n=a.n, row_ptr=a.row_ptr, col_idx=a.col_idx,
             val=a.val * (1.0 + 0.25 * np.sin(np.arange(a.nnz))))
    cfg = tsolver.SolverConfig(block_size=16, kernel_backend="fused_streamed")
    solver = tsolver.Solver(tsolver.build_plan(to_torch_csr(a), 1, cfg), "cpu")
    b = np.random.default_rng(7).uniform(-1, 1, a.n)
    old_values = solver._fused.values.clone()
    np.testing.assert_allclose(solver.solve(b), reference_solve(a, b), **TOL)
    solver.refresh(tsolver.refresh_plan(solver.plan, to_torch_csr(a2)))
    assert not torch.equal(solver._fused.values, old_values)
    np.testing.assert_allclose(solver.solve(b), reference_solve(a2, b), **TOL)
    fresh = tsolver.Solver(tsolver.build_plan(to_torch_csr(a2), 1, cfg), "cpu")
    np.testing.assert_array_equal(solver.solve(b), fresh.solve(b))


def test_streamed_solver_keeps_only_the_store():
    """The streamed kernel reads only its store, so a streamed ``Solver``
    keeps no device copy of ``diag``/``tiles`` beside it, before and after a
    refresh; the resident one keeps them."""
    a = to_torch_csr(strategies.SOLVER_MATRICES["levelled"]())
    b = np.random.default_rng(8).uniform(-1, 1, a.n)
    solvers = {k: tsolver.Solver(tsolver.build_plan(
        a, 1, tsolver.SolverConfig(block_size=16, kernel_backend=k)), "cpu")
        for k in ("fused", "fused_streamed")}
    streamed = solvers["fused_streamed"]
    assert streamed._diag is None and streamed._tiles is None
    assert solvers["fused"]._diag is not None and solvers["fused"]._tiles is not None
    streamed.refresh(tsolver.refresh_plan(streamed.plan, a))
    assert streamed._diag is None and streamed._tiles is None
    np.testing.assert_array_equal(streamed.solve(b), solvers["fused"].solve(b))


@pytest.mark.parametrize("B,fits", [(169, True), (170, True), (1056, False)])
def test_streamed_solver_refuses_a_block_too_wide_when_built(B, fits):
    """The streamed kernel takes every B < 1056 (from B = 170 in row
    chunks): a wider block is refused when the ``Solver`` is built, not at
    its first solve."""
    a = strategies.random_triangular(n=2 * B, seed=1, m=8 * B)
    plan = tsolver.build_plan(to_torch_csr(a), 1, tsolver.SolverConfig(
        block_size=B, kernel_backend="fused_streamed"))
    if not fits:
        with pytest.raises(ValueError, match="block size"):
            tsolver.Solver(plan, "cpu")
        return
    b = np.random.default_rng(9).uniform(-1, 1, a.n)
    np.testing.assert_allclose(tsolver.Solver(plan, "cpu").solve(b), reference_solve(a, b),
                               **TOL)


@pytest.mark.parametrize("build,b,expect", [
    (strategies.empty_matrix, np.zeros(0), np.zeros(0)),
    (strategies.diagonal_matrix, np.arange(1.0, 25.0), np.arange(1.0, 25.0) / 2.0),
    (strategies.single_entry_matrix, np.array([6.0]), np.array([2.0])),
])
def test_streamed_degenerate_plans(build, b, expect):
    a = to_torch_csr(build())
    solver = tsolver.Solver(tsolver.build_plan(
        a, 1, tsolver.SolverConfig(block_size=8, kernel_backend="fused_streamed")), "cpu")
    np.testing.assert_array_equal(solver.solve(b), expect.astype(np.float32))
    assert solver.solve(np.zeros((a.n, 2))).shape == (a.n, 2)


def test_streamed_single_row_block_and_zero_level_layout():
    a = to_torch_csr(strategies.random_triangular(n=5, seed=0, m=8))
    b = np.arange(1.0, 6.0)
    solver = tsolver.Solver(tsolver.build_plan(
        a, 1, tsolver.SolverConfig(block_size=8, kernel_backend="fused_streamed")), "cpu")
    assert solver.plan.bs.nb == 1 and solver.plan.n_levels == 1
    assert solver._fused.layout.max_item_tiles == 1
    np.testing.assert_allclose(solver.solve(b), reference_solve(a, b), rtol=1e-5, atol=1e-5)
    empty = tsolver.build_plan(to_torch_csr(strategies.empty_matrix()), 1,
                               tsolver.SolverConfig(block_size=8, kernel_backend="fused_streamed"))
    layout = tsolver.fused_layouts(empty)[0]
    assert layout.table.levels == (0, 0) and layout.copied_entries == 0
    assert tsolver.stream_dma_bytes_per_solve(empty) == 0


@pytest.mark.parametrize("D", [1, 2])
def test_streamed_dispatch_stats_follow_the_hopper_rule(D):
    a = strategies.SOLVER_MATRICES["levelled"]()
    cfg = SolverConfig(block_size=16, kernel_backend="fused_streamed", sched="dagpart")
    ref = build_plan(a, D, cfg)
    port = tsolver.build_plan(to_torch_csr(a), D, port_config(cfg))
    stats = tsolver.dispatch_stats(port)
    assert {k: stats[k] for k in hopper_fused_stats(ref)} == hopper_fused_stats(ref)
    layout = tsolver.fused_layouts(port)[0]
    if D == 1:
        assert stats["fused_vmem_bytes"] == tss.streamed_shared_bytes(16, layout.max_item_tiles)
        assert stats["stream_dma_bytes"] == layout.copied_entries * 4 * 16 * 17
    assert tsolver.stream_dma_bytes_per_solve(port, R=8) == 8 * stats["stream_dma_bytes"]


def test_streamed_ic0_pcg_matches_reference():
    ja, b, full = strategies.spd_problem(side=18, seed=0)
    want = jkrylov.solve_ic0_pcg(ja, b, mesh=strategies.mesh1(), tol=1e-8,
                                 config=SolverConfig(block_size=16, kernel_backend="reference"))
    got = solve_ic0_pcg(to_torch_csr(ja), b, device="cpu",
                        config=PlanOptions(block_size=16, kernel="fused_streamed"), tol=1e-8)
    assert got.converged and got.n_iters == want.n_iters
    np.testing.assert_allclose(got.history, want.history, rtol=1e-4, atol=1e-12)
    np.testing.assert_allclose(got.x, spla.spsolve(full, b), rtol=1e-5, atol=1e-5)
    fwd, bwd = got.info["forward"], got.info["backward"]
    assert fwd.backend == bwd.backend == "fused_streamed"
    assert fwd.n_solves == bwd.n_solves == got.n_iters


@pytest.mark.parametrize("form", ["forward", "panel"])
def test_grouped_gemv_switch_solve_matches_reference(form):
    """``gemv_group=4``: the switch executor's GEMVs go through the grouped
    wrapper (its plain version here) and give the reference's bits."""
    a = strategies.EXACT_MATRICES["banded"]()
    cfg = SolverConfig(block_size=8, gemv_group=4, kernel_backend="pallas")
    plan = build_plan(a, 1, cfg)
    b = _rhs(a.n, 3 if form == "panel" else 1)
    want = np.asarray(DistributedSolver(plan, strategies.mesh1()).solve(b))
    port = tsolver.Solver(tsolver.build_plan(to_torch_csr(a), 1,
                                             port_config(cfg, kernel_backend="cuda")), "cpu")
    assert port.plan.config.gemv_group == 4
    np.testing.assert_array_equal(port.solve(b), want)
    assert "block_gemv_grouped" in ops.launch_counts()
