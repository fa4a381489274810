"""Multi-device ``comm="unified"`` on the CPU: the port's executors on D
gloo ranks against the reference's ``DistributedSolver`` on a D-device mesh,
for D = 4 and 8.

Four subprocesses run once for the module, side by side: for each D, the
reference on a mesh of D forced host devices, and one process that imports
the port and forks D ranks of one gloo group (no JAX there). The reference
runs its megakernel executor (``fused``, whose split form the port's fused
backends run) at both D and its switch executor (``reference``) at D = 8;
the port's switch executor is held to the reference's switch executor at
D = 8 and to its megakernel at D = 4. The reference's executors agree bit
for bit on these problems (its own ``tests/test_multidevice.py`` pins the
megakernel against the switch executor on 8 devices), so each of the port's
executors is held to the reference's bits either way; running the
reference's switch executor at D = 4 too would double the reference's time. The parent writes their inputs (the
dyadic suites of ``tests/strategies.py``, a real-valued problem, new values
for a refresh, a matrix whose cut is empty), and the tests read their
results: every rank's ``x`` bit for bit against the reference's, real values
within rtol = atol = 2e-4 of ``reference_solve``, launch and exchange counts
against ``dispatch_stats``, strict verification of every plan run. Last,
each rank runs what a multi-device session runs beside the executors:
``"auto"`` options with a plan store (cold, then warm) and IC(0)-PCG and CG
on the group, held to ``spsolve`` and to one another.

Run as ``python tests/test_torch_unified.py D INPUTS OUT`` this file is the
port's side: it forks the D ranks and writes one ``.npz`` and one ``.json``
per rank to OUT.
"""
from __future__ import annotations

import os
import sys
import textwrap

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
DEVICES = (4, 8)
B = 8
SCHEDS = ("levelset", "dagpart")
# the port's kernels, and the reference's run at each D
KERNELS = ("reference", "fused", "fused_streamed")
REFERENCE_KERNELS = {4: ("fused",), 8: ("reference", "fused")}
FORMS = ("forward", "transpose", "panel")
MATRICES = ("banded", "skewed")
TOL = dict(rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# the port's side: D forked gloo ranks (runs in a process of its own)
# ---------------------------------------------------------------------------


def _rank(rank: int, D: int, inputs: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    from torch_parity import RankRecorder, read_csr

    torch.set_num_threads(1)
    # "fused" means the resident megakernel here, "fused_streamed" the
    # streamed one (the port's rule streams every plan on its own)
    os.environ["REPRO_TORCH_STREAM_LIMIT"] = str(2**62)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(out, "rendezvous"),
                            rank=rank, world_size=D)
    from repro_torch.api import PlanOptions, SpTRSVContext

    group = dist.group.WORLD
    data = np.load(inputs)
    rec = RankRecorder()
    solve, report = rec.solve, rec.report

    def csr(key):
        return read_csr(data, key)

    for m in MATRICES:
        a = csr(m)
        b, panel = data[m + "/b"], data[m + "/panel"]
        for sched in SCHEDS:
            for kernel in KERNELS:
                ctx = SpTRSVContext(device="cpu", group=group, options=PlanOptions(
                    block_size=B, comm="unified", sched=sched, kernel=kernel))
                h = ctx.analyse(a)
                key = f"{m}/{sched}/{kernel}"
                solve(ctx, h, b, key + "/forward")
                solve(ctx, h, b, key + "/transpose", transpose=True)
                solve(ctx, h, panel, key + "/panel")
                if m == "skewed" and sched == "dagpart":
                    report[key + "/ranges"] = rec.ranges(ctx, h, b)
                if m == "skewed":
                    snap = ctx.metrics_snapshot(h)
                    stats = ctx.dispatch_stats(h)
                    report[key + "/metrics"] = all(
                        snap[f"plan.{k}"] == stats[k]
                        for k in ("fused_launches", "exchanges", "supersteps"))
                    # a refresh to new values solves with them, then back
                    ctx.factorize(csr("skewed_new"), h)
                    solve(ctx, h, b, key + "/refreshed")
                    ctx.factorize(a, h)
                    solve(ctx, h, b, key + "/refreshed_back")
    for kernel in KERNELS:  # real values
        ctx = SpTRSVContext(device="cpu", group=group, options=PlanOptions(
            block_size=16, comm="unified", sched="dagpart", kernel=kernel))
        solve(ctx, ctx.analyse(csr("real")), data["real/b"], f"real/{kernel}")
    for kernel in KERNELS:  # an empty cut: no exchange, one launch per solve
        ctx = SpTRSVContext(device="cpu", group=group, options=PlanOptions(
            block_size=B, comm="unified", partition="contiguous", kernel=kernel))
        h = ctx.analyse(csr("uncut"))
        solve(ctx, h, data["uncut/b"], f"uncut/{kernel}")
    # "auto" with a plan store at D devices: a cold session tunes and
    # saves, a warm one hits; IC(0)-PCG and CG on the group
    from repro_torch.krylov import solve_cg, solve_ic0_pcg, spd_lower_from_triangular
    from repro_torch.service import PlanStore
    from repro_torch.sparse import suite

    auto = PlanOptions(block_size=B, sched="auto", comm="auto", kernel="auto")
    for phase in ("cold", "warm"):
        ctx = SpTRSVContext(device="cpu", group=group,
                            plan_store=PlanStore(os.path.join(out, "store")))
        h = ctx.analyse(csr("skewed"), auto)
        rec.xs[f"auto/{phase}"] = ctx.solve(h, data["skewed/b"])
        report[f"auto/{phase}"] = {
            "chosen": [h.config.sched, h.config.comm, h.config.kernel_backend],
            "stats": ctx.stats()}
    spd = spd_lower_from_triangular(suite.grid2d_factor(12, seed=1))
    b_spd = np.random.default_rng(2).uniform(-1, 1, spd.n)
    for name, fn in (("pcg", solve_ic0_pcg), ("cg", solve_cg)):
        res = fn(spd, b_spd, device="cpu", config=PlanOptions(block_size=B), tol=1e-8,
                 group=group)
        rec.xs[f"krylov/{name}"] = res.x
        report[f"krylov/{name}"] = {"n_iters": res.n_iters, "converged": res.converged}
    rec.save(out, rank)
    dist.barrier()
    dist.destroy_process_group()


def _port_main(D: int, inputs: str, out: str) -> None:
    """Fork the D ranks (the port is imported once, here) and wait for them."""
    # imported before the fork, so the ranks share them
    import torch  # noqa: F401
    import repro_torch.api  # noqa: F401
    import repro_torch.verify  # noqa: F401
    from torch_parity import fork_ranks

    fork_ranks(_rank, D, (inputs, out))


# ---------------------------------------------------------------------------
# the reference's side (runs in a process of its own)
# ---------------------------------------------------------------------------

REFERENCE = textwrap.dedent("""
    import sys
    import numpy as np, jax
    from repro import compat
    from repro.core import DistributedSolver, SolverConfig, build_plan
    from repro.sparse.matrix import CSR
    inputs, out, D, kernels = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4:]
    data = np.load(inputs)
    mesh = compat.make_mesh((D,), ("x",), devices=jax.devices()[:D])
    xs = {}
    for m in ("banded", "skewed"):
        a = CSR(n=int(data[m + "/n"]), row_ptr=data[m + "/row_ptr"],
                col_idx=data[m + "/col_idx"], val=data[m + "/val"])
        b, panel = data[m + "/b"], data[m + "/panel"]
        for sched in ("levelset", "dagpart"):
            for kernel in kernels:
                cfg = SolverConfig(block_size=%d, comm="unified", sched=sched,
                                   kernel_backend=kernel)
                fw = DistributedSolver(build_plan(a, D, cfg), mesh)
                tr = DistributedSolver(build_plan(a, D, cfg, transpose=True), mesh)
                key = f"{D}/{m}/{sched}/{kernel}"
                xs[key + "/forward"] = fw.solve(b)
                xs[key + "/transpose"] = tr.solve(b)
                xs[key + "/panel"] = fw.solve(panel)
    np.savez(out, **xs)
""" % B)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the reference and both port runs together, wait for all of
    them, and return their results with the inputs."""
    from torch_parity import multi_device_inputs, rank_results, run_together

    tmp = tmp_path_factory.mktemp("unified")
    inputs = str(tmp / "inputs.npz")
    probs = multi_device_inputs(inputs, B)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    commands = {}
    for D in DEVICES:
        commands[f"reference {D}"] = (
            [sys.executable, "-c", REFERENCE, inputs, str(tmp / f"reference{D}.npz"), str(D),
             *REFERENCE_KERNELS[D]],
            {"JAX_PLATFORMS": "cpu", "XLA_FLAGS": f"--xla_force_host_platform_device_count={D}"})
        (tmp / f"port{D}").mkdir()
        commands[f"port {D}"] = (
            [sys.executable, os.path.abspath(__file__), str(D), inputs, str(tmp / f"port{D}")],
            {})
    run_together(commands, env)
    ref = {k: v for D in DEVICES for k, v in np.load(tmp / f"reference{D}.npz").items()}
    port = {D: rank_results(tmp / f"port{D}", D) for D in DEVICES}
    return probs, ref, port


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("sched", SCHEDS)
@pytest.mark.parametrize("matrix", MATRICES)
@pytest.mark.parametrize("D", DEVICES)
def test_every_rank_bit_identical_to_the_reference(runs, D, matrix, sched, kernel, form):
    _, ref, port = runs
    counterpart = kernel if kernel in REFERENCE_KERNELS[D] else "fused"
    want = ref[f"{D}/{matrix}/{sched}/{counterpart}/{form}"]
    for r, (xs, _) in enumerate(port[D]):
        np.testing.assert_array_equal(xs[f"{matrix}/{sched}/{kernel}/{form}"], want,
                                      err_msg=f"rank {r}")


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("D", DEVICES)
def test_real_values_within_tolerance_and_refresh(runs, D, kernel):
    """Real values within 2e-4 of ``reference_solve`` on every rank; a
    refresh to new values solves with them (exact on the dyadic suite), and
    back with the old ones."""
    from repro.sparse.matrix import reference_solve

    probs, _, port = runs
    a, b = probs["real"]
    want = reference_solve(a, b)
    new, bn = probs["skewed_new"]
    exact_new = reference_solve(new, bn).astype(np.float32)
    for xs, _ in port[D]:
        np.testing.assert_allclose(xs[f"real/{kernel}"], want, **TOL)
        for sched in SCHEDS:
            np.testing.assert_array_equal(xs[f"skewed/{sched}/{kernel}/refreshed"], exact_new)
            np.testing.assert_array_equal(xs[f"skewed/{sched}/{kernel}/refreshed_back"],
                                          xs[f"skewed/{sched}/{kernel}/forward"])


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("D", DEVICES)
def test_launches_and_exchanges_are_dispatch_stats(runs, D, kernel):
    """Per solve: as many exchanges as ``dispatch_stats`` says (one per
    superstep), one all-reduce more (the gather), and under the fused
    backends as many launches of the split form and no unsplit one,
    streamed exactly under ``fused_streamed``; ``metrics_snapshot`` reports
    the same counts; every plan run verifies strict."""
    for _, report in runs[2][D]:
        tags = [t for t, c in report.items()
                if t.split("/")[2:3] == [kernel] and isinstance(c, dict) and "exchanges" in c]
        tags += [f"real/{kernel}"]
        assert len(tags) == 2 * 2 * 3 + 2 * 2 + 1
        for tag in tags:
            c = report[tag]
            assert c["verified"], tag
            assert c["exchanges"] == c["want_exchanges"] > 0, (tag, c)
            assert c["all_reduces"] == c["exchanges"] + 1, (tag, c)
            if kernel != "reference":
                assert c["split"] == c["want_launches"] == c["want_exchanges"], (tag, c)
                assert c["whole"] == 0, (tag, c)
                assert (c["streamed"] > 0) == (kernel == "fused_streamed"), (tag, c)
        assert all(report[f"skewed/{s}/{kernel}/metrics"] for s in SCHEDS)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_exchange_and_gather_ranges_only_when_traced(runs, kernel):
    """A solve enters no ``record_function`` range untraced; traced, one
    ``sptrsv.exchange`` per superstep and one ``sptrsv.gather``, beside one
    ``sptrsv.superstep`` per launch (fused backends)."""
    for D in DEVICES:
        for _, report in runs[2][D]:
            r = report[f"skewed/dagpart/{kernel}/ranges"]
            assert r["off"] == [], r
            assert r["on"]["sptrsv.exchange"] == r["supersteps"], r
            assert r["on"]["sptrsv.gather"] == 1, r
            if kernel != "reference":
                assert r["on"]["sptrsv.superstep"] == r["supersteps"], r
            else:
                assert r["on"]["sptrsv.level_solve"] > 0, r


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("D", DEVICES)
def test_empty_cut_runs_one_launch_and_no_exchange(runs, D, kernel):
    from repro.sparse.matrix import reference_solve

    probs, _, port = runs
    a, b = probs["uncut"]
    want = reference_solve(a, b).astype(np.float32)
    for xs, report in port[D]:
        c = report[f"uncut/{kernel}"]
        assert c["boundary"] == 0 and c["verified"], c
        np.testing.assert_array_equal(xs[f"uncut/{kernel}"], want)
        assert c["exchanges"] == c["want_exchanges"] == 0, c
        assert c["all_reduces"] == 1, c  # the gather alone
        if kernel != "reference":
            assert c["whole"] == c["want_launches"] == 1 and c["split"] == 0, c


@pytest.mark.parametrize("D", DEVICES)
def test_auto_and_plan_store_run_on_several_devices(runs, D):
    """``"auto"`` options with a plan store at D ranks: the cold session
    analyses once and tunes, the warm one hits the store; every rank picks
    the same candidate, and the solves are exact on the dyadic suite."""
    from repro.sparse.matrix import reference_solve

    probs, _, port = runs
    a, b = probs["skewed"]
    exact = reference_solve(a, b).astype(np.float32)
    chosen = {tuple(report["auto/cold"]["chosen"]) for _, report in port[D]}
    assert len(chosen) == 1
    for xs, report in port[D]:
        cold, warm = report["auto/cold"], report["auto/warm"]
        assert cold["stats"]["analyses"] == 1 and not cold["stats"].get("plan_store_hits")
        assert warm["stats"]["plan_store_hits"] == 1 and not warm["stats"].get("analyses")
        assert warm["chosen"] == cold["chosen"]
        np.testing.assert_array_equal(xs["auto/cold"], exact)
        np.testing.assert_array_equal(xs["auto/warm"], exact)


@pytest.mark.parametrize("D", DEVICES)
def test_krylov_runs_on_several_devices(runs, D):
    """IC(0)-PCG and CG on D ranks: converged, within 1e-5 of ``spsolve``,
    the same iterations and bits on every rank, PCG in fewer iterations."""
    import scipy.sparse.linalg as spla

    from repro.krylov import spd_lower_from_triangular, symmetric_full_csr
    from repro.sparse import suite
    from repro.sparse.matrix import to_scipy

    spd = spd_lower_from_triangular(suite.grid2d_factor(12, seed=1))
    b = np.random.default_rng(2).uniform(-1, 1, spd.n)
    want = spla.spsolve(to_scipy(symmetric_full_csr(spd)).tocsc(), b)
    (xs0, rep0), *others = runs[2][D]
    assert rep0["krylov/pcg"]["n_iters"] < rep0["krylov/cg"]["n_iters"]
    for name in ("pcg", "cg"):
        assert rep0[f"krylov/{name}"]["converged"]
        np.testing.assert_allclose(xs0[f"krylov/{name}"], want, rtol=1e-5, atol=1e-5)
        for xs, rep in others:
            assert rep[f"krylov/{name}"] == rep0[f"krylov/{name}"]
            np.testing.assert_array_equal(xs[f"krylov/{name}"], xs0[f"krylov/{name}"])


def test_plan_digest_tells_plans_apart():
    """The digest the ranks compare: equal for the same plan built twice,
    different for another partition or device count."""
    import strategies
    from torch_parity import to_torch_csr
    from repro_torch.api.context import plan_digest
    from repro_torch.core import solver as tsolver

    a = to_torch_csr(strategies.EXACT_MATRICES["skewed"]())

    def digest(D, **kw):
        return plan_digest(tsolver.build_plan(a, D, tsolver.SolverConfig(
            block_size=B, comm="unified", **kw)))

    assert digest(4) == digest(4)
    assert len({digest(4), digest(8), digest(4, partition="contiguous"),
                digest(4, sched="dagpart")}) == 4


def test_multi_device_plans_need_a_matching_group():
    """A multi-device plan of D > 1 devices without a group of D ranks
    raises ``ValueError``, under either comm mode and every scheduler (all
    of them execute at D > 1 now), and so does the multi-device SpMV."""
    import torch.distributed as dist

    import strategies
    from torch_parity import to_torch_csr
    from repro_torch.api import PlanOptions, SpTRSVContext
    from repro_torch.core import solver as tsolver
    from repro_torch.krylov.spmv import SpMV

    a = to_torch_csr(strategies.EXACT_MATRICES["skewed"]())
    plan = tsolver.build_plan(a, 2, tsolver.SolverConfig(block_size=B, comm="unified"))
    with pytest.raises(ValueError, match="group"):
        tsolver.Solver(plan, "cpu")
    with pytest.raises(ValueError, match="group"):
        SpMV(plan, "cpu")
    store = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"unified-{os.getpid()}")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        for kw in ({}, {"comm": "zerocopy"}, {"comm": "unified", "sched": "syncfree"},
                   {"comm": "zerocopy", "sched": "syncfree"}):
            p = tsolver.build_plan(a, 2, tsolver.SolverConfig(block_size=B, **kw))
            with pytest.raises(ValueError, match="2 ranks"):
                tsolver.Solver(p, "cpu", dist.group.WORLD)
        # a one-device session on a group of one: the gather is its only all-reduce
        ctx = SpTRSVContext(device="cpu", group=dist.group.WORLD,
                            options=PlanOptions(block_size=B, comm="unified"))
        b = strategies.dyadic_rhs(a.n)
        np.testing.assert_array_equal(ctx.solve(ctx.analyse(a), b),
                                      SpTRSVContext(device="cpu", options=PlanOptions(
                                          block_size=B)).solve(a, b))
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.unlink(store)


if __name__ == "__main__":
    _port_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
