"""The port's static plan verifier (``repro_torch.verify``) against the
reference's (``repro.verify``).

Both packages build byte-identical plans, so both verifiers see the same
schedules: clean plans pass ``strict`` in both with the same rules (the port
adds ``kc.pull.wait``), and every mutation of the reference's own mutation
tests (``tests/test_verify.py``), applied to each package's plan, fires the
same set of failing rule ids in both. The rules the port checks against its
own Hopper contract (``kc.stream.slices``, ``kc.stream.bytes``,
``kc.scratch.shape``, ``kc.carry.donation``) and its pull-table rule
(``kc.pull.wait``) each fail on a mutation made for them. Then the wiring:
``REPRO_TORCH_VERIFY``, ``build_plan(verify=)``, ``PlanOptions.verify``,
the ``sptrsv.verify`` span and the ``verify.*`` metrics.
"""
import dataclasses
import io
import inspect
from unittest import mock

import numpy as np
import pytest

import repro.core.solver as jsolver
import repro.verify as jverify
import repro_torch.core.solver as tsolver
import repro_torch.verify as tverify
import strategies
from repro.sparse import suite
from repro_torch.kernels import ref as tref
from repro_torch.kernels import superstep as tsuperstep
from repro_torch.obs import metrics as tmet
from repro_torch.obs import trace as ttrace
from repro_torch.verify import contracts as tcontracts
from torch_parity import PORT_ONLY_RULES, assert_plans_identical, port_config, to_torch_csr


def both_plans(a, D, cfg, *, transpose=False):
    """The reference's plan and the port's own, checked byte-identical."""
    ref = jsolver.build_plan(a, D, cfg, transpose=transpose)
    port = tsolver.build_plan(to_torch_csr(a), D, port_config(cfg), transpose=transpose,
                              device="cpu")
    assert_plans_identical(ref, port)
    return ref, port


def rules_of(report):
    return {f.rule for f in report.findings}


def port_rules_for(ref_rules, plan) -> list:
    """The rules the port's verifier runs where the reference's ran
    ``ref_rules``: the same, plus the pull-table rule after the streaming
    rules (levelset/dagpart plans at contracts level and above)."""
    extra = [r for r in PORT_ONLY_RULES if "kc.stream.slices" in ref_rules]
    return list(ref_rules) + extra


# -----------------------------------------------------------------------
# clean plans: both verifiers pass strict with the same rules
# -----------------------------------------------------------------------

CLEAN_MATRICES = {
    "skewed": lambda: suite.random_levelled(400, 8, 4.0, seed=6),
    "banded": lambda: suite.random_levelled(300, 8, 4.0, seed=7, locality=0.8),
    "grid": lambda: suite.grid2d_factor(18, seed=1),
    "chain": lambda: suite.chain(150),
    "diagonal": strategies.diagonal_matrix,
}


@pytest.mark.parametrize("name", sorted(CLEAN_MATRICES))
@pytest.mark.parametrize("sched", ["levelset", "dagpart", "syncfree"])
def test_clean_plans_pass_strict_with_the_same_rules(name, sched):
    a = CLEAN_MATRICES[name]()
    for D in (1, 2, 4, 8):
        for comm, kernel, transpose in (("zerocopy", None, False),
                                        ("unified", "fused", True),
                                        ("zerocopy", "fused_streamed", D == 2)):
            cfg = jsolver.SolverConfig(block_size=8, sched=sched, comm=comm,
                                       partition="taskpool", kernel_backend=kernel)
            ref, port = both_plans(a, D, cfg, transpose=transpose)
            jrep = jverify.verify_plan(ref, level="strict")
            trep = tverify.verify_plan(port, level="strict")
            assert jrep.passed, jrep.summary()  # the reference agrees with itself
            assert trep.passed, "\n".join(str(f) for f in trep.findings)
            assert list(trep.rules_checked) == port_rules_for(jrep.rules_checked, port)
            assert trep.plan == jrep.plan


def test_levels_check_what_the_reference_checks():
    ref, port = both_plans(suite.chain(40), 1, jsolver.SolverConfig(block_size=8))
    for level in ("basic", "contracts"):
        jrep = jverify.verify_plan(ref, level=level)
        trep = tverify.verify_plan(port, level=level)
        assert list(trep.rules_checked) == port_rules_for(jrep.rules_checked, port)
    assert not any(r.startswith("kc.") for r in tverify.verify_plan(port, "basic").rules_checked)
    with pytest.raises(ValueError, match="invalid verify level"):
        tverify.verify_plan(port, level="paranoid")


def test_sweep_module_is_green():
    """The port's sweep over a cut of its grid (the whole grid is
    ``python -m repro_torch.verify.sweep``, 2916 plans)."""
    from repro_torch.verify.sweep import run_sweep, sweep_grid, sweep_matrices

    mats = {k: v for k, v in sweep_matrices().items()
            if k in ("chain", "grid", "empty", "single")}
    out = io.StringIO()
    assert run_sweep(level="strict", out=out, matrices=mats,
                     grid=sweep_grid(devices=(1, 8))) == 0
    assert "PASS: 864 plans" in out.getvalue()


# -----------------------------------------------------------------------
# the reference's mutations, applied to both packages' plans
# -----------------------------------------------------------------------


def level_slice(plan, t, col):
    lo = int(plan.lvl_off[t, col])
    return lo, lo + int(plan.buckets[int(plan.lvl_bucket[t])][col])


def swap_two_levels(plan):
    sr = plan.solve_rows.copy()
    (l1, _), (l2, _) = level_slice(plan, 1, 0), level_slice(plan, 2, 0)
    sr[:, [l1, l2]] = sr[:, [l2, l1]]
    return dataclasses.replace(plan, solve_rows=sr), "basic"


def drop_exchange_row(plan):
    owner = np.asarray(plan.part.owner)
    rows, cols = plan.bs.off_rows, plan.bs.off_cols
    remote_dest = set(np.unique(rows[owner[cols] != owner[rows]]).tolist())
    idx = next(i for i, r in enumerate(plan.ex_rows) if int(r) in remote_dest)
    ex = plan.ex_rows.copy()
    ex[idx] = plan.bs.nb
    return dataclasses.replace(plan, ex_rows=ex), "basic"


def shrink_bucket_width(plan):
    bid = int(plan.lvl_bucket[0])
    ws, wu, we = plan.buckets[bid]
    buckets = tuple((ws - 1, wu, we) if i == bid else b for i, b in enumerate(plan.buckets))
    return dataclasses.replace(plan, buckets=buckets), "contracts"


def overlap_dma_slices(plan):
    off = plan.lvl_off.copy()
    off[1, 1] -= 1
    return dataclasses.replace(plan, lvl_off=off), "contracts"


def double_assign_row(plan):
    sr = plan.solve_rows.copy()
    for t in range(1, plan.n_levels):
        lo, hi = level_slice(plan, t, 0)
        for d in range(plan.n_devices):
            pads = np.nonzero(sr[d, lo:hi] == -1)[0]
            for te in range(t) if pads.size else ():
                le, he = level_slice(plan, te, 0)
                real = [int(r) for r in sr[d, le:he] if int(r) != -1]
                if real:
                    sr[d, lo + int(pads[0])] = real[0]
                    return dataclasses.replace(plan, solve_rows=sr), "basic"
    raise AssertionError("fixture must have bucket slack")


def double_schedule_tile(plan):
    ut = plan.upd_tiles.copy()
    (l0, _), (l1, _) = level_slice(plan, 0, 1), level_slice(plan, 1, 1)
    ut[0, l1] = ut[0, l0]
    return dataclasses.replace(plan, upd_tiles=ut), "basic"


def disowned_row(plan):
    sr = plan.solve_rows.copy()
    lo, hi = level_slice(plan, 0, 0)
    d = next(d for d in range(plan.n_devices) if any(int(r) != -1 for r in sr[d, lo:hi]))
    pos = lo + next(i for i, r in enumerate(sr[d, lo:hi]) if int(r) != -1)
    sr[(d + 1) % plan.n_devices, pos], sr[d, pos] = sr[d, pos], -1
    return dataclasses.replace(plan, solve_rows=sr), "basic"


def undershoot_frontier_caps(plan):
    return dataclasses.replace(plan, frontier_caps=(1, 1)), "basic"


def duplicate_boundary_row(plan):
    exb = plan.ex_boundary.copy()
    real = np.nonzero(exb != plan.bs.nb)[0]
    exb[real[1]] = exb[real[0]]
    return dataclasses.replace(plan, ex_boundary=exb), "basic"


def bucket_id_out_of_range(plan):
    lb = plan.lvl_bucket.copy()
    lb[0] = len(plan.buckets) + 3
    return dataclasses.replace(plan, lvl_bucket=lb), "contracts"


def poisoned_pad_tile(plan):
    tiles = plan.tiles.copy()
    tiles[0, -1] = 1.0
    return dataclasses.replace(plan, tiles=tiles), "contracts"


def corrupt_step_table(k):
    def mutate(plan):
        T = plan.n_levels
        bad = (np.array([0, 0, T], np.int32), np.array([1, T], np.int32),
               np.array([0, T + 1], np.int32))[k]
        return dataclasses.replace(plan, step_off=bad), "contracts"
    return mutate


def _skewed():
    return suite.random_levelled(400, 8, 4.0, seed=6)


# fixture: (matrix, D, config fields) as in tests/test_verify.py
CHAIN = (lambda: suite.chain(40), 1, {})
MULTI = (_skewed, 2, {"partition": "taskpool"})
SYNCFREE = (_skewed, 2, {"sched": "syncfree", "partition": "taskpool"})
DAGPART = (_skewed, 2, {"sched": "dagpart", "partition": "taskpool"})

MUTATIONS = {
    "swap_two_levels": (CHAIN, swap_two_levels),
    "drop_exchange_row": (MULTI, drop_exchange_row),
    "shrink_bucket_width": (CHAIN, shrink_bucket_width),
    "overlap_dma_slices": (CHAIN, overlap_dma_slices),
    "double_assign_row": (MULTI, double_assign_row),
    "double_schedule_tile": (CHAIN, double_schedule_tile),
    "disowned_row": (MULTI, disowned_row),
    "undershoot_frontier_caps": (SYNCFREE, undershoot_frontier_caps),
    "duplicate_boundary_row": (SYNCFREE, duplicate_boundary_row),
    "bucket_id_out_of_range": (CHAIN, bucket_id_out_of_range),
    "poisoned_pad_tile": (CHAIN, poisoned_pad_tile),
    **{f"corrupt_step_table_{k}": (DAGPART, corrupt_step_table(k)) for k in range(3)},
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutation_fires_the_same_rules_in_both(name):
    (make, D, fields), mutate = MUTATIONS[name]
    cfg = jsolver.SolverConfig(block_size=8, **fields)
    ref, port = both_plans(make(), D, cfg)
    assert jverify.verify_plan(ref, level="strict").passed
    assert tverify.verify_plan(port, level="strict").passed
    jbad, level = mutate(ref)
    tbad, _ = mutate(port)
    assert_plans_identical(jbad, tbad)
    jrep = jverify.verify_plan(jbad, level=level)
    trep = tverify.verify_plan(tbad, level=level)
    assert not jrep.passed and rules_of(jrep)
    assert rules_of(trep) == rules_of(jrep)
    # the same findings, not just the same ids
    assert [str(f) for f in trep.findings if f.rule.startswith("hb.")] == \
        [str(f) for f in jrep.findings if f.rule.startswith("hb.")]


def merge_everything(bs, part, **_kw):
    """An illegal merge pass: the whole level range in one superstep."""
    return np.array([0, int(bs.block_level.max()) + 1], dtype=np.int32)


@pytest.mark.parametrize("comm,rule", [("zerocopy", "hb.exchange.position"),
                                       ("unified", "hb.upd.dest-step")])
def test_illegal_merge_fires_the_same_rules_in_both(comm, rule):
    a = suite.chain(160)
    cfg = jsolver.SolverConfig(block_size=8, sched="dagpart", comm=comm, partition="taskpool")
    with mock.patch("repro.core.solver.merge_levels", merge_everything), \
            mock.patch("repro_torch.core.solver.merge_levels", merge_everything):
        ref, port = both_plans(a, 2, cfg)
    jrep = jverify.verify_plan(ref, level="strict")
    trep = tverify.verify_plan(port, level="strict")
    assert jrep.by_rule(rule) and not jrep.passed
    assert rules_of(trep) == rules_of(jrep)


# -----------------------------------------------------------------------
# the port's own contracts: each fails on a mutation made for it
# -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def clean_plan():
    """A single-device levelset plan with orphan-free pulls and bucket slack."""
    _, port = both_plans(suite.random_levelled(400, 8, 4.0, seed=6), 1,
                         jsolver.SolverConfig(block_size=8, kernel_backend="fused_streamed"))
    assert tverify.verify_plan(port, level="strict").passed
    return port


def _source(fn, old, new):
    src = inspect.getsource(fn)
    assert old in src, old
    return src.replace(old, new)


def test_carry_donation_lint_is_clean_on_the_kernels():
    assert tcontracts.carry_donation_findings() == []
    names = set(tcontracts._carry_functions())
    assert names == {"superstep.superstep_call", "superstep.superstep_streamed_call",
                     "ref.superstep_ref", "ref.superstep_streamed_ref"}


@pytest.mark.parametrize("fn,old,new,expect", [
    (tsuperstep.superstep_call,
     "acc_out, x_out = torch.empty_like(acc), torch.empty_like(x)",
     "acc_out, x_out = acc, x", "returns 'acc_out'"),
    (tsuperstep.superstep_streamed_call, "return acc.clone(), x.clone()",
     "return acc, x", "returns 'acc'"),
    (tsuperstep.superstep_call, "    t_lo, t_hi = table.levels\n",
     "    t_lo, t_hi = table.levels\n    x.zero_()\n", "x.zero_(...)"),
    (tref.superstep_ref, "    acc, x = acc.clone(), x.clone()\n", "",
     "writes into the carry passed in: x[...] ="),
    (tref.superstep_streamed_ref, "acc.clone(), x.clone()", "acc, x.clone()",
     "acc.index_add_(...)"),
])
def test_carry_donation_fires_on_a_write_to_a_carry(fn, old, new, expect, monkeypatch):
    name = f"{fn.__module__.rsplit('.', 1)[-1]}.{fn.__name__}"
    found = tcontracts.carry_donation_findings({name: _source(fn, old, new)})
    assert any(expect in m for m in found), found
    # and through verify_plan, with the mutated function among the linted ones
    sources = dict(tcontracts._carry_functions(), **{name: _source(fn, old, new)})
    monkeypatch.setattr(tcontracts, "_carry_functions", lambda: sources)
    tcontracts._lint_once.cache_clear()
    try:
        _, port = both_plans(suite.chain(40), 1, jsolver.SolverConfig(block_size=8))
        report = tverify.verify_plan(port, level="contracts")
        assert rules_of(report) == {"kc.carry.donation"}
    finally:
        monkeypatch.undo()
        tcontracts._lint_once.cache_clear()


def test_stream_slices_fires_on_a_layout_claiming_an_entry_twice(clean_plan, monkeypatch):
    real = tsolver.fused_layouts

    def twice(plan):
        layouts = real(plan)
        te = np.asarray(layouts[0].tile_entry).copy()
        live = np.nonzero(te >= 0)[0]
        te[live[1]] = te[live[0]]  # two updates read one stored tile
        return [dataclasses.replace(layouts[0], tile_entry=te)] + layouts[1:]

    monkeypatch.setattr(tsolver, "fused_layouts", twice)
    report = tverify.verify_plan(clean_plan, level="contracts")
    assert rules_of(report) == {"kc.stream.slices"}
    assert "claimed by more than one work item" in report.by_rule("kc.stream.slices")[0].message


def test_stream_slices_fires_on_a_layout_missing_an_update(clean_plan, monkeypatch):
    real = tsolver.fused_layouts

    def drop(plan):
        layouts = real(plan)
        te = np.asarray(layouts[0].tile_entry).copy()
        te[np.nonzero(te >= 0)[0][-1]] = -1
        return [dataclasses.replace(layouts[0], tile_entry=te)] + layouts[1:]

    monkeypatch.setattr(tsolver, "fused_layouts", drop)
    msgs = [f.message for f in tverify.verify_plan(clean_plan, "contracts").findings]
    assert any("tile_entry covers" in m for m in msgs)
    assert any("by none" in m for m in msgs)


@pytest.mark.parametrize("mutation,expect", [
    ("swap_update_tiles", "hold another tile than the update reads"),
    ("swap_diagonals", "diagonal entry is not the last of its run, or holds another tile"),
    ("move_update_across_items", "lie outside their work item's run"),
])
def test_stream_slices_fires_on_a_layout_holding_the_wrong_tile(clean_plan, mutation, expect,
                                                                  monkeypatch):
    real = tsolver.fused_layouts

    def mutate(plan):
        layouts = real(plan)
        lay = layouts[0]
        src, de = np.asarray(lay.source).copy(), np.asarray(lay.diag_entry).copy()
        te = np.asarray(lay.tile_entry).copy()
        live = np.nonzero(te >= 0)[0]
        if mutation == "swap_update_tiles":
            i, j = te[live[0]], te[live[-1]]
            src[[i, j]] = src[[j, i]]
        elif mutation == "swap_diagonals":
            real_slots = np.nonzero(plan.solve_rows[0] >= 0)[0]
            i, j = de[real_slots[0]], de[real_slots[-1]]
            src[[i, j]] = src[[j, i]]
        else:  # two updates of different rows trade entries, tiles moved along
            a, b = live[0], live[-1]
            src[[te[a], te[b]]] = src[[te[b], te[a]]]
            te[[a, b]] = te[[b, a]]
        return [dataclasses.replace(lay, source=src, diag_entry=de, tile_entry=te)] + layouts[1:]

    monkeypatch.setattr(tsolver, "fused_layouts", mutate)
    report = tverify.verify_plan(clean_plan, level="contracts")
    assert rules_of(report) == {"kc.stream.slices"}
    assert any(expect in f.message for f in report.findings), [str(f) for f in report.findings]


def test_stream_bytes_fires_on_a_count_that_ignores_the_columns(clean_plan, monkeypatch):
    real = tsolver.stream_dma_bytes_per_solve
    monkeypatch.setattr(tsolver, "stream_dma_bytes_per_solve",
                        lambda plan, R=1, *, layouts=None: real(plan, 1, layouts=layouts))
    report = tverify.verify_plan(clean_plan, level="contracts")
    assert rules_of(report) == {"kc.stream.bytes"}
    assert "R=8" in report.by_rule("kc.stream.bytes")[0].message


def test_stream_bytes_fires_on_a_count_that_copies_pad_slots(clean_plan, monkeypatch):
    def with_pads(plan, R=1, *, layouts=None):
        layouts = layouts or tsolver.fused_layouts(plan)
        n = max(int(np.asarray(lay.source).shape[0]) for lay in layouts)
        return R * n * 4 * tsuperstep.stream_tile_floats(plan.bs.B)

    assert (clean_plan.solve_rows[0] < 0).any()  # the plan has pad slots
    monkeypatch.setattr(tsolver, "stream_dma_bytes_per_solve", with_pads)
    assert rules_of(tverify.verify_plan(clean_plan, "contracts")) == {"kc.stream.bytes"}


def test_scratch_shape_fires_on_a_stage_sized_by_the_whole_store(clean_plan, monkeypatch):
    real = tsolver.fused_vmem_bytes

    def by_store(plan, *, streamed=False, layouts=None):
        if not streamed:
            return real(plan, layouts=layouts)
        layouts = layouts or tsolver.fused_layouts(plan)
        return tsuperstep.streamed_shared_bytes(plan.bs.B, layouts[0].copied_entries)

    monkeypatch.setattr(tsolver, "fused_vmem_bytes", by_store)
    assert rules_of(tverify.verify_plan(clean_plan, "contracts")) == {"kc.scratch.shape"}


@pytest.mark.parametrize("B,fits", [(169, True), (170, True), (1056, False)])
def test_scratch_shape_refuses_the_streamed_form_above_b169(B, fits):
    """The streamed form is clean at every B < 1056 (from B = 170 it copies
    row chunks); at B = 1056 both fused forms fail ``kc.scratch.shape``,
    and ``cuda``, which makes no fused launch, passes."""
    a = to_torch_csr(suite.random_levelled(600, 4, 2.0, seed=3))
    for kernel, fused in (("fused_streamed", True), ("fused", True), ("cuda", False)):
        plan = tsolver.build_plan(a, 1, tsolver.SolverConfig(block_size=B, kernel_backend=kernel),
                                  device="cpu")
        report = tverify.verify_plan(plan, level="strict")
        bad = report.by_rule("kc.scratch.shape")
        assert bool(bad) == (fused and not fits), [str(f) for f in bad]
        assert report.passed == (not bad)
        if bad:
            assert "over the card's" in bad[0].message


def test_stream_ladder_fires_on_a_stale_ladder(clean_plan, monkeypatch):
    real = tsolver.stream_widths
    monkeypatch.setattr(tsolver, "stream_widths",
                        lambda plan: tuple(w[:-1] for w in real(plan)))
    assert rules_of(tverify.verify_plan(clean_plan, "contracts")) == {"kc.stream.ladder"}


def test_pull_wait_holds_on_the_kernels_tables(clean_plan):
    table = tsolver.fused_layouts(clean_plan)[0].table
    assert int(np.asarray(table.pull_wait).sum()) > 0
    sink = tverify.RuleSink()
    tcontracts.check_pull_wait(clean_plan, [table], sink)
    assert sink.rules_checked == ["kc.pull.wait"] and not sink.findings


@pytest.mark.parametrize("flip", ["skip_a_wait", "wait_on_an_unsolved_row"])
def test_pull_wait_fires_on_a_flipped_bit(clean_plan, flip, monkeypatch):
    """Over the whole schedule every pull's source row is solved in the
    launch, so every bit is 1. One pull that skips its wait would read its
    source before it is solved; one whose source the launch never solves
    (here, the pad row) would wait forever."""
    plan = clean_plan
    whole = tsolver.fused_layouts(plan)[0].table
    assert np.asarray(whole.pull_wait).all()
    i = len(np.asarray(whole.pull_wait)) // 2

    def mutate(t):
        wait, col = np.asarray(t.pull_wait).copy(), np.asarray(t.pull_col).copy()
        if flip == "skip_a_wait":
            wait[i] = 0
        else:
            col[i] = plan.bs.nb
        return dataclasses.replace(t, pull_wait=wait, pull_col=col)

    sink = tverify.RuleSink()
    tcontracts.check_pull_wait(plan, [mutate(whole)], sink)
    assert [f.rule for f in sink.findings] == ["kc.pull.wait"]
    want = "would wait on a row" if flip != "skip_a_wait" else "would read a row before"
    assert f"1 pulled tiles" in sink.findings[0].message and want in sink.findings[0].message
    # through verify_plan: the table the layout builder makes, mutated
    real = tsuperstep._table
    monkeypatch.setattr(tsuperstep, "_table", lambda o: mutate(real(o)))
    assert rules_of(tverify.verify_plan(plan, "contracts")) == {"kc.pull.wait"}


# -----------------------------------------------------------------------
# wiring: env, build_plan, PlanOptions, span, metrics
# -----------------------------------------------------------------------


def test_env_verify_level_reads_the_ports_variable(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_VERIFY", raising=False)
    monkeypatch.setenv("REPRO_VERIFY", "strict")  # the reference's: not read here
    assert tverify.ENV_VERIFY == "REPRO_TORCH_VERIFY"
    assert tverify.env_verify_level() is None
    assert tverify.env_verify_level(default="basic") == "basic"
    for raw, want in (("", None), ("0", None), ("off", None), ("none", None),
                      ("false", None), ("basic", "basic"), ("contracts", "contracts"),
                      ("strict", "strict"), ("1", "strict"), ("yes", "strict"),
                      ("STRICT", "strict")):
        monkeypatch.setenv("REPRO_TORCH_VERIFY", raw)
        assert tverify.env_verify_level(default="basic") == want, raw
        monkeypatch.setenv("REPRO_VERIFY", raw)
        assert jverify.env_verify_level(default="basic") == want, raw


def test_build_plan_verify_optin(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_VERIFY", raising=False)
    monkeypatch.delenv("REPRO_VERIFY", raising=False)
    a = to_torch_csr(suite.chain(40))
    cfg = tsolver.SolverConfig(block_size=8)
    runs = tmet.get_registry().counter("verify.runs")
    before = runs.value
    tsolver.build_plan(a, 1, cfg, verify="strict", device="cpu")
    assert runs.value == before + 1
    monkeypatch.setenv("REPRO_VERIFY", "strict")  # the reference's switch
    tsolver.build_plan(a, 1, cfg, device="cpu")
    assert runs.value == before + 1
    monkeypatch.setenv("REPRO_TORCH_VERIFY", "strict")
    tsolver.build_plan(a, 1, cfg, device="cpu")
    assert runs.value == before + 2
    monkeypatch.delenv("REPRO_TORCH_VERIFY")
    tsolver.build_plan(a, 1, cfg, device="cpu")
    assert runs.value == before + 2  # off by default


def test_build_plan_verify_raises_on_a_bad_plan(monkeypatch):
    monkeypatch.setattr(tsolver, "merge_levels", merge_everything)
    a = to_torch_csr(suite.chain(160))
    cfg = tsolver.SolverConfig(block_size=8, sched="dagpart", partition="taskpool")
    plan = tsolver.build_plan(a, 2, cfg, device="cpu")  # no verify: builds
    with pytest.raises(tverify.PlanVerificationError) as ei:
        tsolver.build_plan(a, 2, cfg, device="cpu", verify="basic")
    assert ei.value.report.by_rule("hb.exchange.position")
    assert not tverify.verify_plan(plan, "basic").passed


def test_plan_options_verify_field_and_session():
    from repro_torch.api import PlanOptions, SpTRSVContext

    assert PlanOptions(verify="strict").verify == "strict"
    assert PlanOptions().verify is None
    with pytest.raises(ValueError, match="invalid verify"):
        PlanOptions(verify="paranoid")
    reg = tmet.get_registry()
    before = reg.counter("verify.runs").value
    ctx = SpTRSVContext(device="cpu", options=PlanOptions(block_size=8, verify="strict"),
                        registry=tmet.MetricsRegistry())
    a = to_torch_csr(strategies.dyadic(suite.random_levelled(120, 5, 3.0, seed=2)))
    h = ctx.analyse(a)
    b = strategies.dyadic_rhs(a.n)
    ctx.solve(h, b)
    ctx.solve(h, b, transpose=True)
    assert reg.counter("verify.runs").value == before + 2  # forward and transpose


def test_verify_emits_trace_span_and_metrics():
    _, port = both_plans(suite.chain(40), 1, jsolver.SolverConfig(block_size=8))
    reg = tmet.get_registry()
    runs, failed = reg.counter("verify.runs").value, reg.counter("verify.failed").value
    with ttrace.trace_to() as tracer:
        tverify.verify_plan(port, level="contracts")
        sr = port.solve_rows.copy()
        sr[0, 0] = -1  # row 0 is never solved
        bad = tverify.verify_plan(dataclasses.replace(port, solve_rows=sr), level="basic")
        records = tracer.export()
    spans = [r for r in records if r.get("type") == "span" and r["name"] == "sptrsv.verify"]
    assert [s["attrs"]["passed"] for s in spans] == [True, False]
    assert spans[0]["attrs"]["n_errors"] == 0 and spans[1]["attrs"]["n_errors"] >= 1
    assert reg.counter("verify.runs").value == runs + 2
    assert reg.counter("verify.failed").value == failed + 1
    assert reg.gauge("verify.last_findings").value == len(bad.findings)
    assert reg.gauge("verify.last_rules_checked").value == len(bad.rules_checked)
    f = bad.by_rule("hb.solve.once")[0].to_dict()
    assert f["rows"] == [0] and f["severity"] == "error"
    with pytest.raises(tverify.PlanVerificationError, match="hb.solve.once"):
        bad.raise_if_failed()
    d = tverify.verify_plan(port, level="strict").to_dict()
    assert d["passed"] and d["findings"] == [] and "kc.pull.wait" in d["rules_checked"]
