"""The superstep megakernel's split form on the CPU: the port's plain
versions (``ref.superstep_ref`` / ``ref.superstep_streamed_ref`` with a
``delta`` carry) against the reference's Pallas kernel with
``split_delta=True`` in interpret mode, and the per-segment pull tables of
a unified solve (``superstep.segmented_layout``) against the reference's
push order.

Every case takes one device's tables of a 4-device ``comm="unified"`` plan
(levelset, and dagpart, which merges steps there: delta is not zero at a
merged step's later levels). Dyadic problems (``tests/strategies.py``) with
small-integer carries are compared bit for bit; real values within
rtol = atol = 2e-5 (one kernel, as the reference's own tests).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import strategies
from torch_parity import flatten_plan
from repro.core import SolverConfig, build_plan
from repro.core.solver import level_widths, step_offsets
from repro.kernels.superstep import superstep_call as jax_superstep_call
from repro.sparse.matrix import CSR
from repro_torch.core import solver as tsolver
from repro_torch.kernels import ref
from repro_torch.kernels import superstep as tss

D = 4
B = 8
KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)


def _real(a: CSR) -> CSR:
    """``a``'s pattern with real values: off-diagonals in (-1, 1), the
    diagonal in [2, 3)."""
    rows = np.repeat(np.arange(a.n), np.diff(a.row_ptr))
    rng = np.random.default_rng(3)
    val = np.where(a.col_idx == rows, rng.uniform(2, 3, a.val.shape),
                   rng.uniform(-1, 1, a.val.shape)).astype(np.float32)
    return CSR(n=a.n, row_ptr=a.row_ptr, col_idx=a.col_idx, val=val)


@functools.lru_cache(maxsize=None)
def _plan(matrix: str, sched: str, real: bool = False):
    a = strategies.EXACT_MATRICES[matrix]()
    return build_plan(_real(a) if real else a, D,
                      SolverConfig(block_size=B, comm="unified", sched=sched,
                                   kernel_backend="fused"))


def _merged_step(plan) -> int:
    """The superstep with the most levels (the first of them)."""
    return int(np.argmax(np.diff(step_offsets(plan))))


def _tables(plan, d: int, seg) -> dict:
    """Device ``d``'s eight tables and two stores of ``plan``."""
    return dict(
        seg=np.asarray(seg, np.int32), off=np.asarray(plan.lvl_off, np.int32),
        wid=level_widths(plan).astype(np.int32), sr=plan.solve_rows[d], ut=plan.upd_tiles[d],
        trow=plan.tile_row[d], tcol=plan.tile_col[d], diag=plan.diag, tiles=plan.tiles[d],
        stp=step_offsets(plan))


def _carries(plan, R: int, real: bool, seed: int):
    """``b_pad``, ``acc``, ``delta``, ``x``: small integers (dyadic) or
    uniform reals, zero in the pad row."""
    rng = np.random.default_rng(seed)
    shape = (plan.bs.nb + 1, plan.bs.B) + ((R,) if R > 1 else ())
    out = []
    for _ in range(4):
        v = (rng.uniform(-1, 1, shape) if real else rng.integers(-3, 4, shape))
        v = v.astype(np.float32)
        v[-1] = 0.0
        out.append(v)
    return out


def _jax_split(tab, b_pad, acc, delta, x):
    """The reference's resident kernel with ``split_delta=True``, in
    interpret mode."""
    j = {k: jnp.asarray(v) for k, v in tab.items()}
    out = jax_superstep_call(
        j["seg"], j["off"], j["wid"], j["sr"], j["ut"], j["trow"], j["tcol"], j["diag"],
        j["tiles"], jnp.asarray(b_pad), jnp.asarray(acc), jnp.asarray(x), jnp.asarray(delta),
        stp=j["stp"], grid=max(1, int(tab["seg"][1])), split_delta=True, interpret=True)
    return tuple(np.asarray(v) for v in out)


def _port_split(tab, b_pad, acc, delta, x):
    """The port's wrapper with ``delta=`` on CPU tensors (its plain version)."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tab.items()}
    out = tss.superstep_call(
        t["seg"], t["off"], t["wid"], t["sr"], t["ut"], t["trow"], t["tcol"], t["diag"],
        t["tiles"], torch.from_numpy(b_pad), torch.from_numpy(acc), torch.from_numpy(x),
        stp=t["stp"], flags=tss.ReadyFlags(tab["diag"].shape[0], "cpu"),
        delta=torch.from_numpy(delta))
    return tuple(v.numpy() for v in out)


def _segmented(tab) -> tss.SegmentedLayout:
    """One launch per superstep, the unified executor's tables."""
    n_steps = tab["stp"].shape[0] - 1
    return tss.segmented_layout(tab["off"], tab["wid"], tab["sr"], tab["ut"], tab["trow"],
                                tab["tcol"], n_rows=tab["diag"].shape[0], stp=tab["stp"],
                                bounds=np.arange(n_steps + 1))


def _streamed_split(tab, layout, b_pad, acc, delta, x):
    """The streamed plain version with ``delta``, on the store of ``layout``."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tab.items()}
    values = tss.streamed_values(layout, t["diag"], t["tiles"])
    out = ref.superstep_streamed_ref(
        t["seg"], t["off"], t["wid"], t["sr"], t["ut"], t["trow"], t["tcol"], values,
        torch.as_tensor(layout.diag_entry), torch.as_tensor(layout.tile_entry),
        torch.from_numpy(b_pad), torch.from_numpy(acc), torch.from_numpy(x), t["stp"],
        delta=torch.from_numpy(delta))
    return tuple(v.numpy() for v in out)


# ---------------------------------------------------------------------------
# the plain versions against the reference's kernel
# ---------------------------------------------------------------------------

SPLIT_CASES = [(m, sched, R) for m in sorted(strategies.EXACT_MATRICES)
               for sched in ("levelset", "dagpart") for R in (1, 2)]


@pytest.mark.parametrize("matrix,sched,R", SPLIT_CASES)
def test_split_plain_versions_bit_identical_to_reference_kernel(matrix, sched, R):
    """On each device's tables a launch over the widest merged superstep
    with non-zero incoming carries, and on device 0's a launch over the
    whole schedule from zero ``acc``/``delta``/``x``: the resident plain
    version, and the streamed one on both its stores (the launch's own
    layout and the unified executor's per-superstep one), give the
    reference's bits."""
    plan = _plan(matrix, sched)
    if sched == "dagpart":
        assert plan.n_supersteps < plan.n_levels  # a merged step is what this tests
    s = _merged_step(plan)
    for d in range(D):
        b_pad, acc, delta, x = _carries(plan, R, False, seed=10 * d + R)
        launches = [((s, 1), (acc, delta, x))]
        if d == 0:
            launches.append(((0, plan.n_supersteps), (np.zeros_like(b_pad),) * 3))
        for seg, carries in launches:
            tab = _tables(plan, d, seg)
            want = _jax_split(tab, b_pad, *carries)
            got = _port_split(tab, b_pad, *carries)
            for name, w, g in zip(("acc", "delta", "x"), want, got):
                np.testing.assert_array_equal(g, w, err_msg=f"device {d} seg {seg} {name}")
            np.testing.assert_array_equal(got[0], carries[0])  # acc passes through
            one = tss.streamed_layout(*[tab[k] for k in ("seg", "off", "wid", "sr", "ut",
                                                         "trow", "tcol")],
                                      n_rows=plan.bs.nb + 1, stp=tab["stp"])
            for layout in (one, _segmented(tab)):
                got = _streamed_split(tab, layout, b_pad, *carries)
                for name, w, g in zip(("acc", "delta", "x"), want, got):
                    np.testing.assert_array_equal(g, w, err_msg=f"streamed {name}")


@pytest.mark.parametrize("sched", ["levelset", "dagpart"])
def test_split_plain_version_real_values_within_tolerance(sched):
    plan = _plan("skewed", sched, real=True)
    s = _merged_step(plan)
    for d in (0, D - 1):
        tab = _tables(plan, d, (s, 1))
        b_pad, acc, delta, x = _carries(plan, 1, True, seed=d)
        want = _jax_split(tab, b_pad, acc, delta, x)
        got = _port_split(tab, b_pad, acc, delta, x)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, w, **KERNEL_TOL)


def test_split_launcher_updates_in_place_and_rejects_shared_carries():
    """``superstep_split_`` writes ``delta`` and ``x`` where they lie, reads
    ``acc``, and refuses carries that share a buffer; without ``delta`` the
    wrappers keep returning ``(acc, x)``."""
    plan = _plan("skewed", "dagpart")
    tab = _tables(plan, 1, (_merged_step(plan), 1))
    b_pad, acc, delta, x = _carries(plan, 1, False, seed=4)
    want = _jax_split(tab, b_pad, acc, delta, x)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tab.items()}
    args = [t[k] for k in ("seg", "off", "wid", "sr", "ut", "trow", "tcol", "diag", "tiles")]
    carries = [torch.from_numpy(v.copy()) for v in (acc, delta, x)]
    flags = tss.ReadyFlags(plan.bs.nb + 1, "cpu")
    out = tss.superstep_split_(*args, torch.from_numpy(b_pad), *carries, t["stp"], flags=flags)
    assert all(o is c for o, c in zip(out, carries))
    for w, g in zip(want, carries):
        np.testing.assert_array_equal(g.numpy(), w)
    shared = torch.zeros(2, *b_pad.shape)
    with pytest.raises(ValueError, match="three tensors"):
        tss.superstep_split_(*args, torch.from_numpy(b_pad), shared[0], shared[1], carries[2],
                             t["stp"], flags=flags)
    assert len(tss.superstep_call(*args, torch.from_numpy(b_pad), carries[0], carries[2],
                                  t["stp"], flags=flags)) == 2


# ---------------------------------------------------------------------------
# the per-segment tables of a unified solve
# ---------------------------------------------------------------------------

def _tile_product(tile, xv):
    return (tile.astype(np.float32) @ xv.astype(np.float32)).astype(np.float32)


def _solve_tile(L, rhs):
    return np.linalg.solve(L.astype(np.float64), rhs.astype(np.float64)).astype(np.float32)


def _push_split(tab, levels, b_pad, acc, delta, x):
    """The reference kernel's split order, line for line, in numpy float32,
    on the carries in place."""
    off, wid, pad = tab["off"], tab["wid"], b_pad.shape[0] - 1
    for t in levels:
        for r in tab["sr"][off[t, 0]:off[t, 0] + wid[t, 0]]:
            if r >= 0:
                x[r] = _solve_tile(tab["diag"][r], (b_pad[r] - acc[r]) - delta[r])
        for tid in tab["ut"][off[t, 1]:off[t, 1] + wid[t, 1]]:
            rd = tab["trow"][tid]
            if rd != pad:
                delta[rd] = delta[rd] + _tile_product(tab["tiles"][tid], x[tab["tcol"][tid]])


def _pull_split(tab, table, b_pad, acc, delta, x):
    """What the split kernel does with one segment's table, in numpy
    float32, on the carries in place."""
    ptr = table.pull_ptr[table.ptr_at:]

    def pull(target, row):
        s = delta[row].copy()
        for p in range(ptr[target], ptr[target + 1]):
            tid = table.pull_tile[p]
            assert table.pull_col[p] == tab["tcol"][tid]
            s = s + _tile_product(tab["tiles"][tid], x[table.pull_col[p]])
        delta[row] = s
        return s

    off, wid = tab["off"], tab["wid"]
    for t in range(*table.levels):
        for k in range(off[t, 0], off[t, 0] + wid[t, 0]):
            r = tab["sr"][k]
            if r >= 0:
                x[r] = _solve_tile(tab["diag"][r], (b_pad[r] - acc[r]) - pull(k, r))
    for q in range(table.n_orphans):
        pull(table.n_solve_slots + q, table.orphan_row[table.orphan_at + q])


SEG_CASES = [("skewed", "levelset", False), ("skewed", "dagpart", False),
             ("banded", "dagpart", False), ("skewed", "dagpart", True)]


@pytest.mark.parametrize("matrix,sched,real", SEG_CASES)
def test_segment_tables_are_the_reference_per_segment_push_order(matrix, sched, real):
    """Each device's per-superstep tables, built once for the whole solve:
    every segment pulls the same tiles in the same order as the one-launch
    table of that superstep alone (``superstep_table``, itself the
    reference's push order), waits on the same rows and has the same
    orphans; and a whole solve run segment after segment on carries kept in
    place, with the exchange left out, gives the reference push order's
    bits on real values."""
    plan = _plan(matrix, sched, real)
    rng = np.random.default_rng(7)
    for d in range(D):
        tab = _tables(plan, d, (0, plan.n_supersteps))
        layout = _segmented(tab)
        assert len(layout.segments) == plan.n_supersteps
        for s, seg in enumerate(layout.segments):
            one = tss.superstep_table([s, 1], *[tab[k] for k in (
                "off", "wid", "sr", "ut", "trow", "tcol")], n_rows=plan.bs.nb + 1, stp=tab["stp"])
            assert seg.levels == one.levels and seg.n_orphans == one.n_orphans, (d, s)
            np.testing.assert_array_equal(
                seg.orphan_row[seg.orphan_at:seg.orphan_at + seg.n_orphans], one.orphan_row)
            lo = int(tab["off"][seg.levels[0], 0]) if seg.levels[1] > seg.levels[0] else 0
            for k in list(range(lo, seg.n_solve_slots)) + [
                    seg.n_solve_slots + q for q in range(seg.n_orphans)]:
                k1 = k if k < seg.n_solve_slots else one.n_solve_slots + k - seg.n_solve_slots
                a0, a1 = seg.pull_ptr[seg.ptr_at + k], seg.pull_ptr[seg.ptr_at + k + 1]
                b0, b1 = one.pull_ptr[k1], one.pull_ptr[k1 + 1]
                for name in ("pull_tile", "pull_col", "pull_wait"):
                    np.testing.assert_array_equal(getattr(seg, name)[a0:a1],
                                                  getattr(one, name)[b0:b1], err_msg=name)
        shape = (plan.bs.nb + 1, plan.bs.B)
        b_pad = rng.uniform(-1, 1, shape).astype(np.float32)
        acc = rng.uniform(-1, 1, shape).astype(np.float32)
        b_pad[-1] = acc[-1] = 0.0
        push = [acc, np.zeros_like(acc), np.zeros_like(acc)]
        pull = [acc, np.zeros_like(acc), np.zeros_like(acc)]
        for s, seg in enumerate(layout.segments):
            _push_split(tab, range(*seg.levels), b_pad, *push)
            _pull_split(tab, seg, b_pad, *pull)
        for name, w, g in zip(("acc", "delta", "x"), push, pull):
            np.testing.assert_array_equal(g, w, err_msg=f"device {d} {name}")


@pytest.mark.parametrize("sched", ["levelset", "dagpart"])
def test_segmented_store_follows_the_kernel_entry_rule(sched):
    """The segmented streamed store: each launch's target ``k`` runs from
    ``pull_ptr[k] + min(k, S)``, its tiles there in pull order and, for a
    slot, its diagonal tile last; the store copies as many entries as the
    one-launch layout and its widest work item is no wider."""
    plan = _plan("skewed", sched)
    nb = plan.bs.nb
    for d in range(D):
        tab = _tables(plan, d, (0, plan.n_supersteps))
        lay = _segmented(tab)
        one = tsolver.fused_layout(tsolver.plan_from_arrays(flatten_plan(plan)), d)
        assert lay.copied_entries == one.copied_entries
        assert lay.max_item_tiles <= one.max_item_tiles
        tile_of = {}
        for seg in lay.segments:
            ptr, S = seg.pull_ptr[seg.ptr_at:], seg.n_solve_slots
            lo = int(tab["off"][seg.levels[0], 0])
            for k in list(range(lo, S)) + [S + q for q in range(seg.n_orphans)]:
                first = ptr[k] + min(k, S)
                for i, p in enumerate(range(ptr[k], ptr[k + 1])):
                    tile_of[first + i] = nb + 1 + seg.pull_tile[p]
                if k < S:
                    assert lay.diag_entry[k] == first + ptr[k + 1] - ptr[k]
                    assert lay.source[lay.diag_entry[k]] == (tab["sr"][k] if tab["sr"][k] >= 0
                                                             else nb)
        entries = np.array(sorted(tile_of))
        np.testing.assert_array_equal(lay.source[entries], [tile_of[e] for e in entries])
        pos = np.nonzero(lay.tile_entry >= 0)[0]
        np.testing.assert_array_equal(np.sort(lay.tile_entry[pos]), entries)
        np.testing.assert_array_equal(lay.source[lay.tile_entry[pos]], nb + 1 + tab["ut"][pos])


def test_segmented_layout_rejects_what_it_cannot_run():
    plan = _plan("skewed", "levelset")
    tab = _tables(plan, 0, (0, plan.n_supersteps))
    args = [tab[k] for k in ("off", "wid", "sr", "ut", "trow", "tcol")]
    n_rows = plan.bs.nb + 1
    for bounds in ([1, 3], [0, 3, 2], [0, plan.n_supersteps + 1]):
        with pytest.raises(ValueError, match="bounds"):
            tss.segmented_layout(*args, n_rows=n_rows, bounds=bounds)
    gap = tab["off"].copy()
    gap[1:, 0] += 1
    with pytest.raises(ValueError, match="end to end"):
        tss.segmented_layout(gap, *args[1:], n_rows=n_rows, bounds=[0, 2])
    twice = tab["sr"].copy()
    twice[tab["off"][1, 0]] = twice[tab["off"][0, 0]]
    with pytest.raises(ValueError, match="solved twice"):
        tss.segmented_layout(*args[:2], twice, *args[3:], n_rows=n_rows, bounds=[0, 1, 2])


def test_split_plain_version_of_an_empty_schedule():
    """With a ``delta`` carry, an empty schedule returns the three carries
    unchanged (as copies)."""
    z = torch.zeros(1, 2)
    empty = torch.zeros((0, 3), dtype=torch.int32)
    i = torch.zeros(1, dtype=torch.int32)
    out = ref.superstep_ref(torch.tensor([0, 0]), empty, empty, i, i, i, i, torch.eye(2)[None],
                            torch.zeros(1, 2, 2), z, z + 1, z + 2, delta=z + 3)
    assert [float(v[0, 0]) for v in out] == [1.0, 3.0, 2.0]
