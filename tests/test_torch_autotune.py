"""The port's auto-tuner on the CPU, held against the reference's: the
candidate grid, modelled scores and choices, probed choices with their
calibration samples, the context's surfacing of the decision, and the
``calibrate_cost`` plans.

Modelled scores agree at rtol 1e-12 (the same float64 model on identical
plans); where a candidate streams, the port's bulk-copy term is its own
(the streamed store copies what ``stream_dma_bytes_per_solve`` counts), so
the comparison replaces the reference's term by the port's.
"""
import numpy as np
import pytest

import strategies
from torch_parity import to_torch_csr
from repro.api import PlanOptions as JPlanOptions
from repro.api import autotune as jauto
from repro.core import solver as jsolver
from repro.core.solver import SolverConfig, build_plan
from repro.obs import calibration as jcal
from repro.sparse import suite
from repro.sparse.matrix import reference_solve
from repro_torch.api import PlanOptions, SpTRSVContext
from repro_torch.api import autotune
from repro_torch.core import solver as tsolver
from repro_torch.core.costmodel import FLOPS_PER_BYTE
from repro_torch.obs import calibration as cal
from repro_torch.obs import metrics as met

AUTO = dict(sched="auto", comm="auto", kernel="auto", block_size=16)


@pytest.fixture(autouse=True)
def _clean_stores(monkeypatch):
    monkeypatch.delenv(tsolver.ENV_STREAM_LIMIT, raising=False)
    for c in (cal, jcal):
        c.set_store(c.CalibrationStore())
    yield
    for c in (cal, jcal):
        c.set_store(None)


def _dma_term(plan, module, fused_streaming, R=1) -> float:
    if not fused_streaming(plan, R):
        return 0.0
    B = plan.bs.B
    nbytes = (module.stream_dma_bytes_per_solve(plan, R) if module is tsolver
              else module.stream_dma_bytes_per_solve(plan))
    return nbytes * FLOPS_PER_BYTE / (B * B)


@pytest.mark.parametrize("limit", [None, 2**62])
@pytest.mark.parametrize("name", sorted(strategies.SOLVER_MATRICES))
def test_modelled_scores_and_choice_match_reference(monkeypatch, name, limit):
    """``probe_solves=0``, empty stores: the same grid, the same scores
    (the bulk-copy term the port's own where a candidate streams), and the
    same choice wherever the scores agree. ``limit``: the default stream
    limit (0: the port's plain ``fused`` streams, so its ``fused_streamed``
    duplicate is dropped) or one above every plan (resident, as the
    reference's)."""
    if limit is not None:
        monkeypatch.setenv(tsolver.ENV_STREAM_LIMIT, str(limit))
    a = strategies.SOLVER_MATRICES[name]()
    jopts, opts = JPlanOptions(**AUTO), PlanOptions(**AUTO)
    assert autotune.candidate_grid(opts, 1, "cpu") == jauto.candidate_grid(jopts, 1)
    _, _, jdec, jsolver_ = jauto.tune(a, jopts, strategies.mesh1())
    _, _, dec, solver = autotune.tune(to_torch_csr(a), opts, "cpu")
    assert dec.mode == jdec.mode == "modelled" and solver is jsolver_ is None
    assert set(dec.scores) <= set(jdec.scores)
    equal = set()
    for combo, score in dec.scores.items():
        sched, comm, kernel = combo
        cfg = SolverConfig(block_size=16, sched=sched, comm=comm, kernel_backend=kernel)
        pen = autotune.INTERPRET_PENALTY if (kernel in ("fused", "fused_streamed")
                                             and sched != "syncfree") else 1.0
        jplan = build_plan(a, 1, cfg)
        tplan = tsolver.build_plan(to_torch_csr(a), 1, tsolver.SolverConfig(
            block_size=16, sched=sched, comm=comm, kernel_backend=cfg.kernel_backend))
        jd = _dma_term(jplan, jsolver, jsolver.fused_streaming)
        td = _dma_term(tplan, tsolver, tsolver.fused_streaming)
        want = (jdec.scores[combo] / pen - jd + td) * pen
        np.testing.assert_allclose(score, want, rtol=1e-12, err_msg=str(combo))
        if jd == td:
            equal.add(combo)
    missing = set(jdec.scores) - set(dec.scores)
    assert missing == ({c for c in jdec.scores if c[2] == "fused_streamed"
                        and c[0] != "syncfree"} if limit is None else set())
    if jdec.chosen in equal and dec.chosen in equal:
        assert dec.chosen == jdec.chosen


@pytest.mark.parametrize("sched", ["auto", "levelset"])
def test_probed_choice_records_cpu_samples(sched):
    """Probed on the CPU: the winner has the smallest ``probe_us``, each
    probed candidate left one ``cpu:``-keyed sample, and a second handle on
    the same analysis reuses the decision."""
    a = to_torch_csr(strategies.dyadic(suite.random_levelled(240, 6, 4.0, seed=3)))
    ctx = SpTRSVContext(device="cpu", options=PlanOptions(
        block_size=16, sched=sched, kernel="auto", probe_solves=1))
    h = ctx.analyse(a)
    d = h.auto
    assert d.mode == "probed" and set(d.probe_us) == set(d.compile_us) == set(d.scores)
    assert d.chosen == min(d.probe_us, key=d.probe_us.get)
    assert all(us > 0 for us in d.probe_us.values())
    assert d.probe_overhead_us >= sum(d.probe_us.values())
    groups = cal.get_store().sample_groups()
    assert all(k.startswith("cpu:") for k in groups)
    assert sum(len(v) for v in groups.values()) == len(d.probe_us)
    assert all(sig.startswith("cpu:") for v in groups.values() for sig in v)
    assert h.solvers[False].plan is h.plan  # the winner's executor is kept
    b = np.random.default_rng(1).uniform(-1, 1, a.n)
    np.testing.assert_allclose(ctx.solve(h, b), reference_solve(a, b), rtol=2e-4, atol=2e-4)
    h2 = ctx.analyse(a, tag="second")
    assert h2.auto is d and ctx.stats()["auto_reuses"] == 1
    assert ctx.stats()["analyses"] == 1


def test_probe_samples_mean_what_the_scorer_multiplies(tmp_path):
    path = str(tmp_path / "weights.json")
    cal.set_store(cal.CalibrationStore(path=path))
    a = to_torch_csr(strategies.dyadic(suite.random_levelled(80, 5, 4.0, seed=3)))
    opts = PlanOptions(sched="auto", kernel="reference", block_size=16, probe_solves=1)
    _, plan, decision, _ = autotune.tune(a, opts, "cpu")
    reloaded = cal.CalibrationStore(path=path)
    assert reloaded.n_samples() == len(decision.probe_us) == 3
    sample = reloaded.samples("reference", 16, "cpu")[cal.probe_signature(plan, 1, "cpu")]
    assert (sample["su"], sample["tu"], sample["tf"]) == autotune.plan_work_units(plan, 1)
    assert sample["us"] == decision.probe_us[decision.chosen]


def test_context_surfaces_the_decision():
    a = to_torch_csr(suite.random_levelled(200, 6, 4.0, seed=2))
    ctx = SpTRSVContext(device="cpu", registry=met.MetricsRegistry(),
                        options=PlanOptions.auto(block_size=16, probe_solves=1))
    h = ctx.analyse(a)
    stats = ctx.dispatch_stats(h)
    auto = stats.pop("auto")
    assert stats.pop("plan_store_hit") is False  # no plan store: analysed here
    assert auto["chosen"] == h.auto.chosen and auto["mode"] == "probed"
    assert h.config == ctx.options.to_config(sched=auto["chosen"][0], comm=auto["chosen"][1],
                                             kernel=auto["chosen"][2])
    assert stats == tsolver.dispatch_stats(ctx.plan(h))
    snap = ctx.metrics_snapshot(h)
    assert snap["auto.probe_overhead_us"] == auto["probe_overhead_us"]
    for combo, us in auto["probe_us"].items():
        assert snap["auto.probe_us." + "/".join(combo)] == us
        assert snap["auto.compile_us." + "/".join(combo)] == auto["compile_us"][combo]
    # comm="auto" collapses to zerocopy on one device
    assert {c[1] for c in auto["scores"]} == {"zerocopy"}


def test_auto_options():
    opts = PlanOptions.auto()
    assert opts.is_auto and opts.probe_solves == 2
    assert not PlanOptions().is_auto
    cfg = opts.to_config(sched="dagpart", comm="zerocopy", kernel="fused")
    assert (cfg.sched, cfg.comm, cfg.kernel_backend) == ("dagpart", "zerocopy", "fused")
    assert opts.to_config(sched="levelset", comm="unified", kernel="default").kernel_backend \
        is None
    with pytest.raises(ValueError, match="probe_solves"):
        PlanOptions(probe_solves=-1)
    round_trip = PlanOptions(calibrate_cost=True, partition="malleable").to_config()
    assert round_trip.calibrate_cost and PlanOptions.from_config(round_trip).calibrate_cost


@pytest.mark.parametrize("kw", [{"partition": "malleable"}, {"sched": "dagpart"},
                                {"partition": "malleable", "kernel_backend": "fused"}])
def test_calibrate_cost_plans_identical_to_reference(kw):
    """With ``calibrate_cost`` the CPU prices the plan with the analytic
    weights, the reference with its HLO weights, which equal them: the plans
    are byte-identical."""
    from torch_parity import assert_plans_identical, port_config

    a = strategies.SOLVER_MATRICES["levelled"]()
    for D in (1, 2):
        cfg = SolverConfig(block_size=16, calibrate_cost=True, **kw)
        port = tsolver.build_plan(to_torch_csr(a), D, port_config(cfg), device="cpu")
        assert_plans_identical(build_plan(a, D, cfg), port)
