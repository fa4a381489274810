"""The port's telemetry on the CPU, held against the reference's: span
structure, results with tracing on and off, the ``record_function`` ranges,
the metrics registry's plan mirror, the calibration store's fits, the
analytic weights, and the port's streamed/resident rule.

Dyadic problems (``tests/strategies.py``) are compared bit for bit; fitted
weights and weights bit for bit (the same float64 arithmetic on the same
numbers).
"""
import json

import numpy as np
import pytest
import torch

import strategies
from torch_parity import HOPPER_FUSED_KEYS, port_config, to_torch_csr
from repro.api import PlanOptions as JPlanOptions
from repro.api import SpTRSVContext as JContext
from repro.core.costmodel import hlo_weights
from repro.core.solver import SolverConfig, build_plan
from repro.obs import calibration as jcal
from repro.obs import metrics as jmet
from repro.obs import trace as jtr
from repro.sparse import suite
from repro_torch.api import PlanOptions, SpTRSVContext
from repro_torch.core import costmodel as tcost
from repro_torch.core import solver as tsolver
from repro_torch.core.partition import cut_stats
from repro_torch.kernels import ops
from repro_torch.kernels import superstep as tss
from repro_torch.obs import calibration as cal
from repro_torch.obs import metrics as met
from repro_torch.obs import trace as tr


@pytest.fixture(autouse=True)
def _clean_telemetry(monkeypatch):
    """Each test gets pristine tracers, registries and calibration stores in
    both packages, and no stream-limit override."""
    monkeypatch.delenv(tsolver.ENV_STREAM_LIMIT, raising=False)
    for t, m, c in ((tr, met, cal), (jtr, jmet, jcal)):
        t.configure_tracing(enabled=False)
        m.get_registry().clear()
        c.set_store(c.CalibrationStore())
    yield
    for t, m, c in ((tr, met, cal), (jtr, jmet, jcal)):
        t.configure_tracing(enabled=False)
        m.get_registry().clear()
        c.set_store(None)


def small_problem(n=120, levels=6, seed=3):
    a = strategies.dyadic(suite.random_levelled(n, levels, 4.0, seed=seed))
    return a, strategies.dyadic_rhs(a.n, seed=seed + 1)


def _session(ctx, a, a2, b):
    """analyse -> solve -> factorize -> transpose solve."""
    h = ctx.analyse(a)
    ctx.solve(h, b)
    ctx.factorize(a2, h)
    ctx.solve(h, b, transpose=True)


def _pairs(records) -> set:
    spans = {r["id"]: r for r in records if r["type"] == "span"}
    assert all(r["parent"] is None or r["parent"] in spans for r in spans.values())
    return {(r["name"], None if r["parent"] is None else spans[r["parent"]]["name"])
            for r in spans.values()}


# ---------------------------------------------------------------------------
# span tracer
# ---------------------------------------------------------------------------


def test_span_structure_matches_reference(tmp_path):
    a, b = small_problem()
    a2 = strategies.dyadic(a, seed=9)  # same pattern, new values
    with jtr.trace_to() as jtracer:
        _session(JContext(mesh=strategies.mesh1(), options=JPlanOptions(block_size=16)),
                 a, a2, b)
    path = str(tmp_path / "t.jsonl")
    with tr.trace_to(path) as tracer:
        _session(SpTRSVContext(device="cpu", options=PlanOptions(block_size=16)),
                 to_torch_csr(a), to_torch_csr(a2), b)
        recs = tracer.export()
    assert _pairs(recs) == _pairs(jtracer.export())
    assert {name for name, _ in _pairs(recs)} >= {
        "sptrsv.analyse", "sptrsv.partition", "sptrsv.schedule", "sptrsv.solve",
        "sptrsv.factorize", "sptrsv.refresh"}
    # the JSONL sink holds the same records in close order; ids are the open order
    lines = [json.loads(line) for line in open(path)]
    assert [r["id"] for r in lines] == [r["id"] for r in recs]
    assert sorted(r["id"] for r in lines) == list(range(len(lines)))


def test_env_variable_is_the_ports_own(monkeypatch, tmp_path):
    """``REPRO_TORCH_TRACE`` switches on the port's tracer and not the
    reference's, so one process can hold both packages."""
    assert tr.ENV_TRACE == "REPRO_TORCH_TRACE" != jtr.ENV_TRACE
    monkeypatch.setenv("REPRO_TORCH_TRACE", str(tmp_path / "port.jsonl"))
    monkeypatch.setattr(tr, "_active", None)
    monkeypatch.setattr(jtr, "_active", None)
    assert tr.get_tracer().enabled and not jtr.get_tracer().enabled
    tr.configure_tracing(enabled=False)


def test_disabled_tracer_is_shared_noop():
    tracer = tr.get_tracer()
    assert tracer is tr.NULL_TRACER and not tracer.enabled
    s1, s2 = tracer.span("a", x=1), tracer.span("b")
    assert s1 is s2
    with s1 as s:
        assert s.set(anything=True) is s
    assert tracer.export() == []


@pytest.mark.parametrize("sched", ["levelset", "syncfree"])
@pytest.mark.parametrize("kernel", ops.BACKENDS)
def test_solves_bit_identical_tracing_on_vs_off(kernel, sched):
    a, b = small_problem()
    assert strategies.exactness_holds(a, b)
    a = to_torch_csr(a)
    opts = PlanOptions(block_size=16, kernel=kernel, sched=sched)
    outs = []
    for on in (False, True):
        tr.configure_tracing(enabled=on)
        ctx = SpTRSVContext(device="cpu", options=opts)
        h = ctx.analyse(a)
        outs.append((ctx.solve(h, b), ctx.solve(h, b, transpose=True),
                     ctx.solve(h, np.stack([b, -b], axis=1))))
        if on:
            assert {r["name"] for r in tr.get_tracer().export()} >= {"sptrsv.solve"}
    for off, on in zip(*outs):
        np.testing.assert_array_equal(off, on)


def _count_record_function(monkeypatch) -> list:
    names = []
    real = torch.profiler.record_function

    def counted(name, *args, **kwargs):
        names.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    return names


def test_tracing_off_enters_no_record_function(monkeypatch):
    """With tracing off and no profiler, a switch solve enters no range;
    with tracing on, one ``sptrsv.level_solve`` per level with rows and one
    ``sptrsv.tile_update`` per level with tiles."""
    a, b = small_problem()
    solver = tsolver.Solver(tsolver.build_plan(to_torch_csr(a), 1,
                                               tsolver.SolverConfig(block_size=16)), "cpu")
    names = _count_record_function(monkeypatch)
    x_off = solver.solve(b)
    assert names == []
    wid = tsolver.level_widths(solver.plan)
    with tr.trace_to():
        x_on = solver.solve(b)
    assert names.count("sptrsv.level_solve") == int((wid[:, 0] > 0).sum())
    assert names.count("sptrsv.tile_update") == int((wid[:, 1] > 0).sum())
    np.testing.assert_array_equal(x_off, x_on)


def test_profiler_session_opens_the_executor_ranges():
    """A ``torch.profiler`` capture of an untraced switch solve holds the
    ``sptrsv.level_solve`` ranges."""
    a, b = small_problem()
    solver = tsolver.Solver(tsolver.build_plan(to_torch_csr(a), 1,
                                               tsolver.SolverConfig(block_size=16)), "cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        solver.solve(b)
    keys = {e.key for e in prof.key_averages()}
    assert {"sptrsv.level_solve", "sptrsv.tile_update"} <= keys


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D,kw", [(1, {}), (1, {"kernel_backend": "fused"}),
                                  (1, {"sched": "syncfree"}), (2, {"sched": "dagpart"}),
                                  (2, {"comm": "unified"})])
def test_plan_metrics_match_reference(D, kw):
    """``record_plan_metrics`` gives the reference's gauge names, and its
    values but for the port's fused on-chip keys."""
    a, _ = small_problem()
    cfg = SolverConfig(block_size=16, **kw)
    ref = jmet.record_plan_metrics(jmet.MetricsRegistry(), build_plan(a, D, cfg)).snapshot()
    port = met.record_plan_metrics(met.MetricsRegistry(), tsolver.build_plan(
        to_torch_csr(a), D, port_config(cfg))).snapshot()
    assert set(port) == set(ref)
    for k, v in ref.items():
        if k.split(".", 1)[1] not in HOPPER_FUSED_KEYS:
            assert port[k] == v, k


def test_registry_instrument_types_and_snapshot(tmp_path):
    reg = met.MetricsRegistry()
    reg.counter("c").inc()
    reg.counter("c").inc(2)
    reg.gauge("g").set(2.5)
    for v in (10.0, 30.0):
        reg.histogram("h").observe(v)
    snap = reg.snapshot()
    assert snap == {"c": 3, "g": 2.5, "h": {"count": 2, "sum": 40.0, "min": 10.0,
                                            "max": 30.0, "mean": 20.0, "last": 30.0}}
    with pytest.raises(TypeError):
        reg.gauge("c")
    path = str(tmp_path / "m.jsonl")
    written = reg.dump(path)
    rec = json.loads(open(path).read())
    assert rec["type"] == "metrics" and rec["metrics"] == written == snap


def test_context_metrics_snapshot_mirrors_stats():
    a, b = small_problem()
    ctx = SpTRSVContext(device="cpu", options=PlanOptions(block_size=16),
                        registry=met.MetricsRegistry())
    h = ctx.analyse(to_torch_csr(a))
    for _ in range(3):
        ctx.solve(h, b)
    snap = ctx.metrics_snapshot(h)
    stats = ctx.stats()
    for k, v in stats.items():
        if k != "cache_hit_rate":
            assert snap[f"session.{k}"] == v, k
    assert snap["session.cache_hit_rate"] == stats["cache_hit_rate"]
    assert snap["session.solves"] == snap["session.solve_us"]["count"] == 3
    assert snap["session.solve_us"]["min"] > 0
    plan = ctx.plan(h)
    stats = ctx.dispatch_stats(h)
    assert stats.pop("plan_store_hit") is False  # a handle's origin, not a plan gauge
    for k, v in stats.items():
        assert snap[f"plan.{k}"] == (int(v) if isinstance(v, bool) else v), k
    cs = cut_stats(plan.bs, plan.part)
    assert snap["plan.boundary_rows"] == cs.boundary_rows
    assert snap["plan.level_cost_imbalance"] == cs.level_cost_imbalance
    assert snap["plan.n_levels"] == plan.n_levels


# ---------------------------------------------------------------------------
# calibration store
# ---------------------------------------------------------------------------


def synthetic_samples(w_solve_us=3.0, c_tile=6.0, n=4, Rs=(1,)):
    """Samples generated exactly by us = w_solve*su + c_tile*tu (+ a flop
    slope when R varies), the reference's own test pattern."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        R = Rs[i % len(Rs)]
        su = float(rng.integers(50, 400)) * R
        tu = float(rng.integers(20, 300))
        out.append(dict(signature=f"sig{i}", su=su, tu=tu, tf=tu * R, R=R,
                        us=w_solve_us * su + c_tile * tu + 0.5 * tu * R))
    return out


def record_all(store, samples, backend="reference", B=16, **kw):
    for s in samples:
        store.record(backend=backend, B=B, signature=s["signature"], solve_units=s["su"],
                     tile_units=s["tu"], tile_flop_units=s["tf"], R=s["R"],
                     measured_us=s["us"], **kw)


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("n,Rs", [(0, (1,)), (1, (1,)), (4, (1,)), (6, (1, 4, 8)),
                                  (2, (1, 8))])
def test_fitted_weights_bit_equal_to_reference(n, Rs, backend):
    """The same samples give the same fit (``None`` included): uniform R
    splits the tile cost by the analytic weights, mixed R fits all three."""
    samples = synthetic_samples(n=n, Rs=Rs)
    jstore, store = jcal.CalibrationStore(), cal.CalibrationStore()
    record_all(jstore, samples, backend=backend)
    record_all(store, samples, backend=backend, device="cpu")
    want = jstore.fitted_weights(16, backend)
    assert store.fitted_weights(16, backend, "cpu") == want
    assert (want is None) == (n < 2)
    assert store.fitted_weights(16, backend, "cuda") is None  # the card's group is empty


def test_store_keys_carry_the_device_type_and_round_trip(tmp_path):
    path = str(tmp_path / "weights.json")
    store = cal.CalibrationStore(path=path)
    record_all(store, synthetic_samples(), device="cpu")
    record_all(store, synthetic_samples(n=2), backend="fused", device="cuda")
    assert set(store.sample_groups()) == {"cpu:reference/B16", "cuda:fused/B16"}
    fresh = cal.CalibrationStore(path=path)  # record() persisted each sample
    assert fresh.sample_groups() == store.sample_groups() and fresh.n_samples() == 6
    assert fresh.fitted_weights(16, "reference", "cpu") == \
        store.fitted_weights(16, "reference", "cpu")
    assert json.load(open(path))["version"] == 1


def test_probe_free_session_inherits_persisted_weights(tmp_path):
    path = str(tmp_path / "weights.json")
    record_all(cal.CalibrationStore(path=path), synthetic_samples(), device="cpu")
    cal.set_store(cal.CalibrationStore(path=path))
    w = tcost.calibrate_weights(16, "reference", device="cpu")
    assert w == cal.get_store().fitted_weights(16, "reference", "cpu")
    assert w != tcost.analytic_weights(16)
    assert tcost.calibrate_weights(16, "reference", device="cpu", feedback=False) is \
        tcost.analytic_weights(16)
    cal.set_store(cal.CalibrationStore())
    assert tcost.calibrate_weights(16, "reference", device="cpu") is tcost.analytic_weights(16)


@pytest.mark.parametrize("B", [1, 8, 16, 32])
def test_cpu_weights_bit_equal_to_reference_hlo_weights(B):
    want = hlo_weights(B, "reference")
    for backend in ops.BACKENDS + (None,):
        assert tcost.calibrate_weights(B, backend, device="cpu", feedback=False) == want


def record_pair(store, ratio, B=16, n=3, device="cuda"):
    """Paired fused / fused_streamed samples, the streamed form costing
    ``ratio`` times the resident one per work unit."""
    for i in range(n):
        su, tu = 100.0 + 10 * i, 50.0 + 5 * i
        for backend, us in (("fused", 2.0 * (su + tu)), ("fused_streamed",
                                                         2.0 * ratio * (su + tu))):
            store.record(backend=backend, B=B, device=device, signature=f"{backend}{i}",
                         solve_units=su, tile_units=tu, tile_flop_units=tu, R=1,
                         measured_us=us)


def test_calibrated_stream_limit_scales_and_clamps(monkeypatch):
    store = cal.CalibrationStore()
    assert cal.calibrated_stream_limit(store) is None
    record_pair(store, ratio=0.5)
    # the card's measured default is 0: no ratio moves a limit of 0
    assert tsolver.DEFAULT_STREAM_LIMIT == 0 == cal.calibrated_stream_limit(store)
    monkeypatch.setattr(tsolver, "DEFAULT_STREAM_LIMIT", 1_000_000)
    assert cal.calibrated_stream_limit(store) == 500_000
    # costly streaming saturates at the ceiling; the floor is 0 (streaming
    # won at the smallest plan measured), so cheap streaming may reach it
    costly = cal.CalibrationStore()
    record_pair(costly, ratio=1000.0)
    assert cal.STREAM_LIMIT_FLOOR == 0 and cal.STREAM_LIMIT_CEIL == 1_310_720
    assert cal.calibrated_stream_limit(costly) == cal.STREAM_LIMIT_CEIL
    monkeypatch.setattr(cal, "STREAM_LIMIT_FLOOR", 400_000)
    assert cal.calibrated_stream_limit(store) == 500_000
    record_pair(store, ratio=0.1)
    assert cal.calibrated_stream_limit(store) == 400_000


def test_calibrated_stream_limit_needs_paired_backends_on_the_card():
    store = cal.CalibrationStore()
    record_all(store, synthetic_samples(), backend="fused", device="cuda")
    assert cal.calibrated_stream_limit(store) is None  # fused alone measures nothing
    cpu = cal.CalibrationStore()
    record_pair(cpu, ratio=2.0, device="cpu")
    assert cal.calibrated_stream_limit(cpu) is None  # plain versions say nothing of the card
    assert cal.calibrated_stream_limit(cpu, device="cpu") == 0


def test_stream_limit_resolution_order(monkeypatch):
    """env override > calibrated crossover > the measured default."""
    monkeypatch.setattr(tsolver, "DEFAULT_STREAM_LIMIT", 1_000_000)
    assert tsolver.stream_limit() == 1_000_000  # pristine store
    record_pair(cal.get_store(), ratio=0.25)
    assert tsolver.stream_limit() == 250_000
    monkeypatch.setenv("REPRO_TORCH_STREAM_LIMIT", "123456")
    assert tsolver.stream_limit() == 123456


# ---------------------------------------------------------------------------
# the streamed/resident rule
# ---------------------------------------------------------------------------


def _solver_form(plan) -> bool:
    solver = tsolver.Solver(plan, "cpu")
    return solver._fused is not None and solver._fused.layout is not None


@pytest.mark.parametrize("sched", ["levelset", "dagpart", "syncfree"])
def test_fused_streams_exactly_above_the_limit(monkeypatch, sched):
    a = to_torch_csr(small_problem()[0])
    plan = tsolver.build_plan(a, 1, tsolver.SolverConfig(block_size=16, sched=sched,
                                                         kernel_backend="fused"))
    store = tsolver.resident_store_bytes(plan)
    assert store == plan.diag.nbytes + plan.tiles.nbytes
    for limit, above in ((store - 1, True), (store, False), (None, True)):
        if limit is None:
            monkeypatch.delenv(tsolver.ENV_STREAM_LIMIT, raising=False)  # the default, 0
        else:
            monkeypatch.setenv(tsolver.ENV_STREAM_LIMIT, str(limit))
        want = above and sched != "syncfree"
        assert tsolver.fused_streaming(plan) == want
        assert tsolver.dispatch_stats(plan)["streamed"] == want
        assert _solver_form(plan) == want
    # fused_streamed streams whatever the limit; the switch backends never
    monkeypatch.setenv(tsolver.ENV_STREAM_LIMIT, str(2**62))
    for kernel, want in (("fused_streamed", sched != "syncfree"), ("cuda", False), (None, False)):
        p = tsolver.build_plan(a, 1, tsolver.SolverConfig(block_size=16, sched=sched,
                                                          kernel_backend=kernel))
        assert tsolver.fused_streaming(p) == tsolver.dispatch_stats(p)["streamed"] == want


@pytest.mark.parametrize("B,fits", [(169, True), (170, True), (1056, False)])
def test_fused_stays_resident_where_the_streamed_form_does_not_fit(B, fits):
    """The streamed kernel takes every B < 1056 (from B = 170 in row
    chunks, measured faster than the resident kernel there: PERF.md), so
    plain ``fused`` above the stream limit streams at every such B; at B =
    1056, which neither form takes, both fused ``Solver``s are refused
    when built."""
    a = to_torch_csr(strategies.random_triangular(n=2 * B, seed=1, m=8 * B))
    plans = {k: tsolver.build_plan(a, 1, tsolver.SolverConfig(block_size=B, kernel_backend=k))
             for k in ("fused", "fused_streamed")}
    assert tss.streamed_shared_bytes(B, 1) <= tss.SHARED_LIMIT
    for plan in plans.values():
        assert tsolver.fused_streaming(plan) and tsolver.dispatch_stats(plan)["streamed"]
        if not fits:
            with pytest.raises(ValueError, match="block size"):
                tsolver.Solver(plan, "cpu")
    if fits:
        assert _solver_form(plans["fused"])
        b = np.random.default_rng(3).uniform(-1, 1, a.n)
        np.testing.assert_array_equal(tsolver.Solver(plans["fused"], "cpu").solve(b),
                                      tsolver.Solver(plans["fused_streamed"], "cpu").solve(b))
