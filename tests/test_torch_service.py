"""The port's plan store, solve queue, engine and CLIs
(``repro_torch.service``, ``repro_torch.launch``) against the reference's.

A store written by either package loads in the other, keyed by the same
``options_signature``, and the solves it serves are bit-identical on the
dyadic suites (forward, transpose, panel); every defect the reference's
store rejects the port's rejects too, counted, with a fresh analysis after.
The queue's batches and scatter equal the reference queue's on the same
submissions. The engine cases of ``tests/test_service.py`` run on
``device="cpu"``, and both CLIs' ``main(argv)`` at small n.
"""
import json
import os
import threading
import warnings
import zipfile

import numpy as np
import pytest

import strategies as st
from repro.api import PlanOptions as JPlanOptions
from repro.api import SpTRSVContext as JContext
from repro.core.solver import SolverConfig as JSolverConfig
from repro.core.solver import build_plan as jbuild_plan
from repro.service import PlanStore as JPlanStore
from repro.service import SolveQueue as JSolveQueue
from repro.service import options_signature as joptions_signature
from repro.sparse import suite
from repro.sparse.matrix import reference_solve
from repro_torch.api import PlanOptions, SpTRSVContext
from repro_torch.core import solver as tsolver
from repro_torch.obs import metrics as met
from repro_torch.obs import trace as ttrace
from repro_torch.service import PlanStore, QueueFull, SolveEngine, SolveQueue
from repro_torch.service import options_signature
from repro_torch.service.queue import pad_width, rhs_ladder, value_key
from torch_parity import to_torch_csr


def exact_problem(n=120, levels=6, seed=3):
    a = st.dyadic(suite.random_levelled(n, levels, 4.0, seed=seed))
    b = st.dyadic_rhs(a.n, seed=seed + 1)
    assert st.exactness_holds(a, b)
    return a, b


def exact(n=96, levels=5, seed=1):
    return to_torch_csr(st.dyadic(suite.random_levelled(n, levels, 3.0, seed=seed)))


def oracle(a, b):
    return reference_solve(a, b).astype(np.float32)


def make_store(tmp_path, **kw):
    kw.setdefault("registry", met.MetricsRegistry())
    return PlanStore(str(tmp_path / "plans"), **kw)


def port_ctx(opts, store=None):
    return SpTRSVContext(device="cpu", options=opts, registry=met.MetricsRegistry(),
                         plan_store=store)


def make_engine(**kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("options", PlanOptions(block_size=16))
    kw.setdefault("registry", met.MetricsRegistry())
    return SolveEngine(**kw)


# ---------------------------------------------------------------------------
# keying: the same signature in both packages
# ---------------------------------------------------------------------------

SHARED_OPTIONS = [
    {}, {"block_size": 16}, {"sched": "dagpart", "merge_width": 8},
    {"sched": "syncfree", "comm": "unified"}, {"partition": "malleable", "rhs_hint": 8},
    {"kernel": "reference"}, {"kernel": "fused"}, {"kernel": "fused_streamed", "gemv_group": 4},
    {"sched": "auto", "comm": "auto", "kernel": "auto"},
    {"sched": "auto", "kernel": "reference", "calibrate_cost": True, "merge_cost": 1.5},
    {"tasks_per_device": 3, "verify": "strict", "probe_solves": 3},
]


@pytest.mark.parametrize("kw", SHARED_OPTIONS, ids=lambda kw: ",".join(kw) or "default")
def test_options_signature_equals_the_references(kw):
    for D in (1, 4):
        for transpose in (False, True):
            want = joptions_signature(JPlanOptions(**kw), D, transpose=transpose)
            assert options_signature(PlanOptions(**kw), D, transpose=transpose) == want
    cfg = PlanOptions(**{k: v for k, v in kw.items() if "auto" not in str(v)}).to_config()
    jcfg = JSolverConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    assert options_signature(cfg, 2) == joptions_signature(jcfg, 2)


def test_options_signature_stable_and_sensitive():
    o = PlanOptions(block_size=16, sched="levelset")
    assert options_signature(o, 2) == options_signature(
        PlanOptions(block_size=16, sched="levelset"), 2)
    assert options_signature(o, 2) != options_signature(o, 4)
    assert options_signature(o, 2) != options_signature(o, 2, transpose=True)
    assert options_signature(o, 2) != options_signature(PlanOptions(block_size=8), 2)
    assert options_signature(o, 2) != options_signature(
        PlanOptions(block_size=16, sched="dagpart"), 2)
    assert options_signature(o, 2) == options_signature(
        PlanOptions(block_size=16, verify="strict", probe_solves=3), 2)


# ---------------------------------------------------------------------------
# interop: a store written by either package loads in the other
# ---------------------------------------------------------------------------


def _three_solves(ctx, h, b):
    panel = np.stack([b, -2 * b], axis=1)
    return [np.asarray(ctx.solve(h, b)), np.asarray(ctx.solve(h, b, transpose=True)),
            np.asarray(ctx.solve(h, panel))]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_store_interop_bit_identical(tmp_path, writer):
    a, b = exact_problem()
    kw = dict(block_size=16, kernel="reference")
    root = str(tmp_path / "plans")

    def jctx():
        return JContext(mesh=st.mesh1(), options=JPlanOptions(**kw),
                        registry=met.MetricsRegistry(),
                        plan_store=JPlanStore(root, registry=met.MetricsRegistry()))

    def tctx():
        return port_ctx(PlanOptions(**kw), PlanStore(root, registry=met.MetricsRegistry()))

    cold, warm = (jctx(), tctx()) if writer == "reference" else (tctx(), jctx())
    ta = to_torch_csr(a)
    h = cold.analyse(a if writer == "reference" else ta)
    x_cold = _three_solves(cold, h, b)
    # the cold package's solves are exact, so any correct one agrees
    np.testing.assert_array_equal(x_cold[0], oracle(a, b))
    assert cold.stats()["analyses"] == 1
    assert len(os.listdir(root)) == 2  # forward and transpose entries
    h2 = warm.analyse(ta if writer == "reference" else a)
    x_warm = _three_solves(warm, h2, b)
    for got, want in zip(x_warm, x_cold):
        np.testing.assert_array_equal(got, want)
    s = warm.stats()
    assert s.get("analyses", 0) == 0 and s.get("transpose_extensions", 0) == 0
    assert s["plan_store_hits"] == 2 and h2.plan_store_hit
    assert warm.plan_store.stats.get("rejected", 0) == 0


def test_store_entries_are_byte_identical_across_packages(tmp_path):
    a = st.dyadic(suite.random_levelled(200, 8, 4.0, seed=6))
    opts = dict(block_size=8, sched="dagpart", partition="malleable")
    jplan = jbuild_plan(a, 1, JSolverConfig(**opts))
    tplan = tsolver.build_plan(to_torch_csr(a), 1, tsolver.SolverConfig(**opts), device="cpu")
    jpath = JPlanStore(str(tmp_path / "j"), registry=met.MetricsRegistry()).save(
        jplan, pattern="p", options=JPlanOptions(**opts))
    tpath = make_store(tmp_path).save(tplan, pattern="p", options=PlanOptions(**opts))
    assert os.path.basename(jpath) == os.path.basename(tpath)
    with np.load(jpath) as jz, np.load(tpath) as tz:
        assert sorted(jz.files) == sorted(tz.files)
        assert json.loads(str(jz["meta"][()])) == json.loads(str(tz["meta"][()]))
        for k in jz.files:
            np.testing.assert_array_equal(jz[k], tz[k])
            assert jz[k].dtype == tz[k].dtype, k


def test_entry_naming_a_backend_the_port_lacks_is_rejected(tmp_path):
    """The reference's "pallas" never maps onto another backend: stale."""
    a, b = exact_problem()
    store = make_store(tmp_path)
    plan = jbuild_plan(a, 1, JSolverConfig(block_size=16, kernel_backend="pallas"))
    opts = PlanOptions(block_size=16)
    JPlanStore(store.root, registry=met.MetricsRegistry()).save(
        plan, pattern=st_pattern(a), options=JPlanOptions(block_size=16))
    assert store.load(to_torch_csr(a), 1, opts) is None
    assert store.stats["rejected"] == 1
    ctx = port_ctx(opts, store)
    np.testing.assert_array_equal(ctx.solve(ctx.analyse(to_torch_csr(a)), b), oracle(a, b))
    assert ctx.stats()["analyses"] == 1 and store.stats["rejected"] == 2


def st_pattern(a):
    from repro_torch.api import pattern_key

    return pattern_key(to_torch_csr(a))


# ---------------------------------------------------------------------------
# the port's own round trip, and every rejection case
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sched,kernel,transpose", [
    ("levelset", "default", False), ("dagpart", "fused", True),
    ("syncfree", "fused_streamed", False), ("levelset", "cuda", True),
])
def test_roundtrip_bit_identical(tmp_path, sched, kernel, transpose):
    a, b = exact_problem()
    ta = to_torch_csr(a)
    opts = PlanOptions(block_size=16, sched=sched, kernel=kernel)
    cold = port_ctx(opts, make_store(tmp_path))
    h = cold.analyse(ta)
    if transpose:
        cold.plan(h)
    x_cold = cold.solve(h, b, transpose=transpose)
    warm = port_ctx(opts, make_store(tmp_path))
    h2 = warm.analyse(ta)
    np.testing.assert_array_equal(warm.solve(h2, b, transpose=transpose), x_cold)
    assert warm.stats().get("analyses", 0) == 0 and warm.stats()["plan_store_hits"] >= 1
    assert warm.dispatch_stats(h2)["plan_store_hit"] is True
    if not transpose:
        np.testing.assert_array_equal(x_cold, oracle(a, b))


def test_auto_session_warm_starts_under_auto_key(tmp_path):
    a, b = exact_problem(n=80, levels=5)
    ta = to_torch_csr(a)
    opts = PlanOptions(block_size=16, sched="auto", comm="zerocopy", kernel="reference")
    cold = port_ctx(opts, make_store(tmp_path))
    x_cold = cold.solve(cold.analyse(ta), b)
    warm = port_ctx(opts, make_store(tmp_path))
    h = warm.analyse(ta)
    np.testing.assert_array_equal(warm.solve(h, b), x_cold)
    s = warm.stats()
    assert s.get("analyses", 0) == 0 and s["plan_store_hits"] == 1 and h.auto is None
    assert h.config == cold.analyse(ta).config


def test_values_rehydrate_from_caller_matrix(tmp_path):
    a, b = exact_problem()
    a2 = st.dyadic(a, seed=99)
    opts = PlanOptions(block_size=16)
    cold = port_ctx(opts, make_store(tmp_path))
    cold.solve(cold.analyse(to_torch_csr(a)), b)
    warm = port_ctx(opts, make_store(tmp_path))
    x2 = warm.solve(warm.analyse(to_torch_csr(a2)), b)
    assert warm.stats().get("analyses", 0) == 0
    np.testing.assert_array_equal(x2, oracle(a2, b))


def populated_store(tmp_path, a, b, opts):
    ctx = port_ctx(opts, make_store(tmp_path))
    ctx.solve(ctx.analyse(to_torch_csr(a)), b)
    root = str(tmp_path / "plans")
    paths = [os.path.join(root, f) for f in sorted(os.listdir(root))]
    assert len(paths) == 1 and paths[0].endswith(".plan.npz")
    return paths[0]


def rewrite_npz(path, *, meta_patch=None, array_patch=None):
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(str(arrays["meta"][()]))
    meta.update(meta_patch or {})
    arrays["meta"] = np.array(json.dumps(meta))
    for k, fn in (array_patch or {}).items():
        arrays[k] = fn(arrays[k])
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def assert_falls_back(tmp_path, a, b, opts):
    """A defective entry yields a fresh-analysis session that still solves
    correctly — and counts the rejection, not a crash."""
    store = make_store(tmp_path)
    ctx = port_ctx(opts, store)
    np.testing.assert_array_equal(ctx.solve(ctx.analyse(to_torch_csr(a)), b), oracle(a, b))
    s = ctx.stats()
    assert s["analyses"] == 1 and s.get("plan_store_hits", 0) == 0
    assert store.stats["rejected"] == 1
    return store


def _truncate(path):
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 3])


def _garbage_zip(path):
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("meta", "garbage")


@pytest.mark.parametrize("defect", [
    lambda p: _truncate(p),
    lambda p: rewrite_npz(p, meta_patch={"version": 999}),
    lambda p: rewrite_npz(p, meta_patch={"format": "not-a-plan", "version": 1}),
    # a tampered schedule that still parses dies at the strict verifier
    lambda p: rewrite_npz(p, array_patch={"solve_rows": lambda v: v[..., ::-1].copy()}),
    lambda p: rewrite_npz(p, array_patch={"lvl_off": lambda v: v + 1}),
    lambda p: _garbage_zip(p),
], ids=["truncated", "version", "format", "solve_rows", "lvl_off", "zip_garbage"])
def test_defective_entry_rejected(tmp_path, defect):
    a, b = exact_problem()
    opts = PlanOptions(block_size=16)
    defect(populated_store(tmp_path, a, b, opts))
    assert_falls_back(tmp_path, a, b, opts)


def test_reference_written_tampered_entry_rejected_by_the_ports_verifier(tmp_path):
    a, b = exact_problem()
    ctx = JContext(mesh=st.mesh1(), options=JPlanOptions(block_size=16),
                   registry=met.MetricsRegistry(),
                   plan_store=JPlanStore(str(tmp_path / "plans"), registry=met.MetricsRegistry()))
    ctx.plan(ctx.analyse(a))
    (name,) = os.listdir(str(tmp_path / "plans"))
    rewrite_npz(os.path.join(str(tmp_path / "plans"), name),
                array_patch={"solve_rows": lambda v: v[..., ::-1].copy()})
    assert_falls_back(tmp_path, a, b, PlanOptions(block_size=16))


def test_atomic_save_leaves_no_temp_files(tmp_path):
    a, b = exact_problem()
    populated_store(tmp_path, a, b, PlanOptions(block_size=16))
    assert [f for f in os.listdir(str(tmp_path / "plans"))
            if not f.endswith(".plan.npz")] == []


def test_unwritable_store_degrades_to_no_persistence(tmp_path, monkeypatch):
    a, b = exact_problem()
    store = make_store(tmp_path)

    def refuse(*args, **kwargs):
        raise OSError("read-only file system")

    monkeypatch.setattr(store, "save", refuse)
    ctx = port_ctx(PlanOptions(block_size=16), store)
    np.testing.assert_array_equal(ctx.solve(ctx.analyse(to_torch_csr(a)), b), oracle(a, b))
    assert ctx.stats()["plan_store_save_errors"] == 1
    assert ctx.registry.snapshot()["session.plan_store_save_errors"] == 1
    assert store.stats.get("saves", 0) == 0


def test_warm_worker_serves_mix_with_zero_analyses(tmp_path):
    patterns = [to_torch_csr(st.dyadic(suite.random_levelled(n, 6, 3.0, seed=s)))
                for n, s in ((120, 1), (90, 2), (70, 3))]
    opts = PlanOptions(block_size=16)
    cold = port_ctx(opts, make_store(tmp_path))
    for a in patterns:
        cold.solve(cold.analyse(a), st.dyadic_rhs(a.n))
    assert cold.stats()["analyses"] == len(patterns)
    store = make_store(tmp_path)
    assert store.verify == "strict"
    warm = port_ctx(opts, store)
    for a in (patterns[0], patterns[1], patterns[0], patterns[2], patterns[0]):
        x = warm.solve(warm.analyse(a), st.dyadic_rhs(a.n))
        np.testing.assert_array_equal(x, oracle(a, st.dyadic_rhs(a.n)))
    s = warm.stats()
    assert s.get("analyses", 0) == 0 and s["plan_store_hits"] == len(patterns)
    assert store.stats["hits"] == len(patterns) and store.stats.get("rejected", 0) == 0
    assert store.stats["hit_rate"] == 1.0
    snap = warm.registry.snapshot()
    assert snap["session.plan_store_hits"] == len(patterns)
    assert store.registry.snapshot()["planstore.hits"] == len(patterns)
    assert s["cache_hit_rate"] > 0


def test_store_load_emits_span(tmp_path):
    a, b = exact_problem()
    populated_store(tmp_path, a, b, PlanOptions(block_size=16))
    with ttrace.trace_to() as tracer:
        ctx = port_ctx(PlanOptions(block_size=16), make_store(tmp_path))
        ctx.analyse(to_torch_csr(a))
        spans = [r for r in tracer.export() if r.get("type") == "span"]
    load = [r for r in spans if r["name"] == "planstore.load"]
    analyse = [r for r in spans if r["name"] == "sptrsv.analyse"]
    assert len(load) == 1 and load[0]["parent"] == analyse[0]["id"]
    assert analyse[0]["attrs"]["plan_store_hit"] is True
    assert "sptrsv.verify" in {r["name"] for r in spans}


# ---------------------------------------------------------------------------
# queue: the reference's batches, and its cases
# ---------------------------------------------------------------------------


def test_queue_batches_and_scatter_equal_the_references():
    mats = [st.dyadic(suite.random_levelled(n, 5, 3.0, seed=s)) for n, s in ((96, 1), (64, 2))]
    mats.append(st.dyadic(mats[0], seed=9))  # the first pattern with other values
    rng = np.random.default_rng(0)
    subs = []
    for i in range(40):
        m = int(rng.integers(3))
        k = int(rng.integers(1, 4))
        rhs = rng.integers(-4, 5, (mats[m].n, k) if k > 1 else mats[m].n).astype(np.float32)
        subs.append((f"t{i % 3}", m, rhs, bool(rng.integers(4) == 0)))
    jq, tq = JSolveQueue(max_batch=6), SolveQueue(max_batch=6)
    tmats = [to_torch_csr(m) for m in mats]
    jt = [jq.submit(t, mats[m], r, transpose=tr) for t, m, r, tr in subs]
    tt = [tq.submit(t, tmats[m], r, transpose=tr) for t, m, r, tr in subs]
    assert [t.request.group for t in tt] == [t.request.group for t in jt]
    while True:
        jb, tb = jq.next_batch(force=True), tq.next_batch(force=True)
        if jb is None:
            assert tb is None
            break
        assert [t.request.id for t in tb] == [t.request.id for t in jb]
        (jp, jr), (tp, tr) = jq.coalesce(jb), tq.coalesce(tb)
        np.testing.assert_array_equal(tp, jp)
        assert tr == jr
        jq.scatter(jb, jp * 2)
        tq.scatter(tb, tp * 2)
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a.result(0), b.result(0))


def test_rhs_ladder_and_pad_width():
    assert rhs_ladder(8) == (1, 2, 4, 8) and rhs_ladder(6) == (1, 2, 4, 6)
    assert rhs_ladder(1) == (1,)
    assert [pad_width(rhs_ladder(8), r) for r in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]


def test_groups_split_by_pattern_values_and_direction():
    a = exact(seed=1)
    a_vals = to_torch_csr(st.dyadic(a, seed=9))
    c = exact(n=64, seed=2)
    q = SolveQueue(max_batch=8)
    b = np.ones(a.n, np.float32)
    reqs = [q.submit("t", a, b), q.submit("t", a_vals, b),
            q.submit("t", c, np.ones(c.n, np.float32)),
            q.submit("t", a, b, transpose=True), q.submit("t", a, b)]
    assert len({t.request.group for t in reqs}) == 4
    assert value_key(a) != value_key(a_vals)
    assert sorted(t.request.id for t in q.next_batch(force=True)) == [0, 4]


def test_fairness_window_backpressure_and_oversized_panels():
    a = exact()
    b = np.ones(a.n, np.float32)
    q = SolveQueue(max_batch=4)
    for _ in range(6):
        q.submit("hog", a, b)
    q.submit("quiet", a, b)
    ids = [t.request.id for t in q.next_batch(force=True)]
    assert 6 in ids and len(ids) == 4 and len(q.next_batch(force=True)) == 3
    q = SolveQueue(max_batch=4, max_wait_s=60.0)
    q.submit("t", a, b)
    assert q.next_batch() is None
    for _ in range(3):
        q.submit("t", a, b)
    assert len(q.next_batch()) == 4
    q.submit("t", a, b)
    assert q.next_batch() is None and len(q.next_batch(force=True)) == 1
    q = SolveQueue(max_batch=2, max_pending=3)
    q.submit("t", a, b)
    q.submit("t", a, np.ones((a.n, 2), np.float32))
    with pytest.raises(QueueFull):
        q.submit("t", a, b)
    q.next_batch(force=True)
    q.submit("t", a, b)
    q = SolveQueue(max_batch=2)
    q.submit("t", a, np.ones((a.n, 5), np.float32))
    batch = q.next_batch(force=True)
    assert len(batch) == 1 and batch[0].request.n_columns == 5 and q.depth == 0


# ---------------------------------------------------------------------------
# engine: the reference's cases on device="cpu"
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["default", "fused"])
def test_engine_serves_mix_correctly_and_counts(kernel):
    mats = [exact(seed=1), exact(n=64, seed=2), exact(n=48, seed=3)]
    eng = make_engine(max_batch=4, options=PlanOptions(block_size=16, kernel=kernel))
    rng = np.random.default_rng(0)
    tickets = []
    for i in range(10):
        m = mats[i % 3 if i % 2 else 0]
        tickets.append(eng.submit(f"t{i % 2}", m, rng.integers(-4, 5, m.n).astype(np.float32)))
    assert eng.drain() == 10
    for t in tickets:
        np.testing.assert_array_equal(t.result(0), oracle(t.request.matrix, t.request.rhs))
        # coalesced and solo give the same bits
        solo = eng.ctx.solve(eng.ctx.analyse(t.request.matrix), t.request.rhs)
        np.testing.assert_array_equal(t.result(0), solo)
        assert t.done() and t.latency_s > 0
    s = eng.stats()
    assert s["requests"] == s["results"] == 10
    assert s["coalesced_columns"] == 10 and s["queue_depth"] == 0
    assert s["batches"] == s["solves"] and s["batches"] < 10
    assert s["session"]["analyses"] == 3
    snap = eng.registry.snapshot()
    assert snap["service.batches"] == s["batches"]
    assert snap["service.coalesce_width"]["count"] == s["batches"]
    assert eng.stream is None  # the CPU has no streams


def test_engine_hot_pattern_value_refresh_in_place():
    a = exact(seed=1)
    a2 = to_torch_csr(st.dyadic(a, seed=7))
    eng = make_engine()
    b = st.dyadic_rhs(a.n)
    t1 = eng.submit("t", a, b)
    eng.drain()
    t2 = eng.submit("t", a2, b)
    eng.drain()
    np.testing.assert_array_equal(t1.result(0), oracle(a, b))
    np.testing.assert_array_equal(t2.result(0), oracle(a2, b))
    sess = eng.stats()["session"]
    assert sess["analyses"] == 1 and sess["factorizes"] == 1


def test_engine_routes_solve_errors_to_tickets(monkeypatch):
    eng = make_engine()
    a = exact()

    def boom(*args, **kwargs):
        raise RuntimeError("device fell over")

    monkeypatch.setattr(eng.ctx, "solve", boom)
    t = eng.submit("t", a, np.ones(a.n, np.float32))
    assert eng.step() == 1
    with pytest.raises(RuntimeError, match="device fell over"):
        t.result(0)
    s = eng.stats()
    assert s["errors"] == 1 and s["queue_depth"] == 0 and s.get("results", 0) == 0


def test_engine_submit_shape_mismatch_raises():
    eng = make_engine()
    a = exact()
    with pytest.raises(ValueError, match="rhs shape"):
        eng.submit("t", a, np.ones(a.n + 1, np.float32))


def test_engine_background_thread_serves_blocking_tenants(tmp_path):
    a = exact()
    eng = make_engine(max_batch=4, max_wait_s=0.01, plan_store=str(tmp_path / "plans"))
    b = st.dyadic_rhs(a.n)
    results = {}

    def tenant(name):
        results[name] = eng.submit(name, a, b).result(timeout=30)

    with eng:
        threads = [threading.Thread(target=tenant, args=(f"t{i}",)) for i in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    assert len(results) == 6
    for x in results.values():
        np.testing.assert_array_equal(x, oracle(a, b))
    assert eng.stats()["queue_depth"] == 0
    assert eng.stats()["plan_store"]["saves"] == 1
    with pytest.raises(RuntimeError, match="already started"):
        eng.start().start()
    eng.stop()


def test_cache_capacity_evicts_lru_with_counter():
    mats = [exact(seed=s) for s in (1, 2, 3)]
    reg = met.MetricsRegistry()
    ctx = SpTRSVContext(device="cpu", options=PlanOptions(block_size=16), registry=reg,
                        cache_capacity=2)
    b = [st.dyadic_rhs(m.n) for m in mats]
    h0 = ctx.analyse(mats[0])
    ctx.solve(h0, b[0])
    ctx.solve(ctx.analyse(mats[1]), b[1])
    ctx.solve(h0, b[0])
    ctx.solve(ctx.analyse(mats[2]), b[2])
    assert ctx.stats()["evictions"] == 1 and reg.snapshot()["session.evictions"] == 1
    analyses = ctx.stats()["analyses"]
    ctx.analyse(mats[0])
    ctx.solve(ctx.analyse(mats[1]), b[1])
    s = ctx.stats()
    assert s["analyses"] == analyses and s["symbolic_hits"] >= 1 and s["evictions"] == 2


def test_engine_passes_capacity_through():
    eng = make_engine(cache_capacity=1)
    for s in (1, 2):
        a = exact(n=48, seed=s)
        eng.submit("t", a, np.ones(a.n, np.float32))
    eng.drain()
    assert eng.stats()["session"]["evictions"] == 1


def test_entry_points_run_on_the_card_unless_asked_for_the_cpu(tmp_path):
    """Without a card, nothing falls back to the CPU on its own."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the entry points run on it")
    from repro_torch.launch import serve_solve, solve

    with pytest.raises(RuntimeError, match="no CUDA device"):
        SolveEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpTRSVContext(plan_store=make_store(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve.main(["--matrix", "random", "--n", "64", "--levels", "4"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_solve.main(["--n", "64", "--requests", "4"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            tsolver.sptrsv(exact(), np.ones(96, np.float32))


# ---------------------------------------------------------------------------
# the CLIs and the deprecated shim
# ---------------------------------------------------------------------------


def test_solve_cli_verifies_and_solves(tmp_path, capsys):
    from repro_torch.launch import solve

    argv = ["--device", "cpu", "--matrix", "webbase-1M", "--scale", "0.05", "--block-size",
            "16", "--repeats", "1", "--verify", "--tol", "2e-4",
            "--plan-store", str(tmp_path / "plans")]
    assert solve.main(argv) == 0
    out = capsys.readouterr().out
    assert "verify[strict] PASS" in out and "rel.err" in out and "hit=False" in out
    assert solve.main(argv + ["--kernel", "fused", "--sched", "dagpart"]) == 0
    capsys.readouterr()
    assert solve.main(argv) == 0  # warm: the store's plan, strict-verified on load
    assert "plan-store: hit=True (hits=1 misses=0 rejected=0" in capsys.readouterr().out
    assert solve.main(argv[:-4] + ["--tol", "0"]) == 1


def test_solve_cli_exits_2_on_a_finding(monkeypatch, capsys):
    import repro_torch.verify as tverify
    from repro_torch.launch import solve

    real = tverify.verify_plan

    def failing(plan, level="contracts"):
        report = real(plan, level)
        bad = tverify.report.Finding(rule="hb.solve.once", severity="error", message="x")
        return tverify.VerificationReport(level=level, plan=report.plan, findings=(bad,),
                                          rules_checked=report.rules_checked)

    monkeypatch.setattr(tverify, "verify_plan", failing)
    assert solve.main(["--device", "cpu", "--matrix", "random", "--n", "200", "--levels",
                       "8", "--block-size", "8", "--verify", "basic"]) == 2
    assert "FAIL" in capsys.readouterr().out


def test_serve_cli_cold_then_warm(tmp_path, capsys):
    from repro_torch.launch import serve_solve

    argv = ["--device", "cpu", "--n", "256", "--requests", "24", "--block-size", "16",
            "--plan-store", str(tmp_path / "plans")]
    assert serve_solve.main(argv + ["--assert-warm"]) == 2  # cold: 3 analyses
    capsys.readouterr()
    res = serve_solve.serve(serve_solve.parse_args(argv + ["--dyadic", "--assert-warm",
                                                           "--assert-hit-rate", "1"]))
    assert res.exit_code == 0 and res.max_rel_err == 0.0
    for t, want in zip(res.tickets, res.answers):
        np.testing.assert_array_equal(t.result(0), want)
    out = capsys.readouterr().out
    assert "analyses=0" in out and "hit_rate=100%" in out and "solves/s" in out
    assert "coalesce width" in out
    assert serve_solve.main(argv + ["--kernel", "fused", "--tol", "2e-4"]) == 0


def test_sptrsv_shim_warns_and_solves():
    a, b = exact_problem()
    with pytest.warns(DeprecationWarning, match="SpTRSVContext"):
        x = tsolver.sptrsv(to_torch_csr(a), b, device="cpu",
                           config=tsolver.SolverConfig(block_size=16))
    np.testing.assert_array_equal(x, oracle(a, b))
    with pytest.warns(DeprecationWarning):
        xt = tsolver.sptrsv(to_torch_csr(a), b, device="cpu", transpose=True)
    from repro.core.solver import sptrsv as jsptrsv

    with pytest.warns(DeprecationWarning):
        want = jsptrsv(a, b, mesh=st.mesh1(), transpose=True)
    np.testing.assert_array_equal(xt, np.asarray(want))
