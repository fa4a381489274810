"""The multi-device tail on the CPU: the port's SpMV, IC(0)-PCG,
ILU(0)-BiCGStab, ``"auto"``, plan store and solve engine on D gloo ranks
against the reference's on a D-device mesh, for D = 2 and 4.

Five subprocesses run once for the module, side by side: the reference on
a mesh of four forced host devices (its ``DistributedSpMV``, IC(0)-PCG and
ILU(0)-BiCGStab under ``comm="zerocopy"``, backend ``reference``, and its
modelled ``tune``, each at D = 2 and 4), and for each D one process that
imports the port and forks D ranks of one gloo group (no JAX there), and
beside them ``launch/serve_solve.py`` (cold, then warm on its store) and
``launch/solve.py`` (probed ``"auto"`` with a store) on two gloo ranks
under ``torch.distributed.run``. The problem is
``tests/test_multidevice.py``'s: the SPD matrix of ``grid2d_factor(16,
seed=1)``, B = 8, with its dyadic twin for the SpMV's bits; the store and
the engine take the exact suites of ``tests/strategies.py``. The tests
read the results: the SpMV bit-identical to the
reference's on dyadic vectors and a two-column panel, iteration counts
equal to the reference's and histories at rtol 1e-4, ``x`` within 1e-5 of
``spsolve``, every rank's ``x`` the same bits, one ``all_reduce`` a matvec,
modelled ``"auto"`` scores and choice equal to the reference's, probed
``"auto"`` one decision on every rank with the other ranks' clocks slowed, the
plan store's hits on every rank and one writer, ``SolveEngine(group=)``
exact under ``drain`` and its background thread, ranks whose residuals
differ stopping together, and both CLIs' exit and report.

Run as ``python tests/test_torch_dist_krylov.py D INPUTS OUT`` this file is
the port's side: it forks the D ranks and writes one ``.npz`` and one
``.json`` per rank to OUT. Each rank's collectives time out after 120 s and
each side after ``torch_parity.RANK_TIMEOUT``, so no test can hang.
"""
from __future__ import annotations

import os
import shlex
import subprocess
import sys
import textwrap

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
DEVICES = (2, 4)
B = 8
SIDE = 16
TOL = 1e-8
AUTO = dict(sched="auto", comm="auto", kernel="auto", block_size=B)
METHODS = ("pcg", "bicgstab")
# two gloo ranks on the CPU under torch.distributed.run (full option names:
# it reads an abbreviation of one of its own, such as --n, as its own)
CLI = [shlex.quote(sys.executable), "-m", "torch.distributed.run", "--standalone",
       "--nproc-per-node", "2"]
SERVE = ["--requests", "12", "--dyadic", "--solo-check", "--n", "256", "--levels", "12",
         "--block-size", "8", "--dist-backend", "gloo", "--device", "cpu"]
SOLVE = ["--matrix", "random", "--n", "600", "--levels", "12", "--block-size", "8",
         "--sched", "auto", "--comm", "auto", "--kernel", "auto", "--probe", "1",
         "--dist-backend", "gloo", "--device", "cpu", "--repeats", "1", "--tol", "1e-4"]


# ---------------------------------------------------------------------------
# the port's side: D forked gloo ranks (runs in a process of its own)
# ---------------------------------------------------------------------------


def _rank(rank: int, D: int, inputs: str, out: str) -> None:
    import datetime
    import json
    import types

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    # "fused" candidates stay resident, as the reference's at this size
    os.environ["REPRO_TORCH_STREAM_LIMIT"] = str(2**62)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(out, "rendezvous"),
                            rank=rank, world_size=D, timeout=datetime.timedelta(seconds=120))
    from torch_parity import read_csr
    from repro_torch.api import PlanOptions, SpTRSVContext, autotune
    from repro_torch.core import comm
    from repro_torch.core.solver import SolverConfig, build_plan
    from repro_torch.krylov import SpMV, pcg, solve_cg, solve_ic0_pcg, solve_ilu0_bicgstab
    from repro_torch.obs import calibration as cal
    from repro_torch.service import PlanStore, SolveEngine

    group = dist.group.WORLD
    data = np.load(inputs)
    a, a_dy, b = read_csr(data, "spd"), read_csr(data, "spd_dy"), data["b"]
    opts = PlanOptions(block_size=B)
    xs, report = {}, {}

    # the SpMV: dyadic vector and panel (exact), real values; one
    # all_reduce a matvec
    for name, mat in (("dyadic", a_dy), ("real", a)):
        spmv = SpMV(build_plan(mat, D, SolverConfig(block_size=B)), "cpu", group)
        before = comm.all_reduce_sum_.calls
        xs[f"spmv/{name}/vector"] = spmv.matvec(data["v"])
        xs[f"spmv/{name}/panel"] = spmv.matvec(data["v_panel"])
        report[f"spmv/{name}"] = {"all_reduces": comm.all_reduce_sum_.calls - before,
                                  "exchanges": spmv.exchanges, "matvecs": spmv.n_matvecs}

    # the Krylov solvers
    for method, fn in (("pcg", solve_ic0_pcg), ("bicgstab", solve_ilu0_bicgstab),
                       ("cg", solve_cg)):
        res = fn(a, b, device="cpu", config=opts, tol=TOL, group=group)
        xs[f"krylov/{method}"] = res.x
        info = res.info
        report[f"krylov/{method}"] = {
            "n_iters": res.n_iters, "history": res.history, "converged": res.converged,
            "matvecs": info["spmv"].n_matvecs, "spmv_exchanges": info["spmv"].exchanges,
            "forward": info["forward"].n_solves if "forward" in info else None,
            "backward": info["backward"].n_solves if "backward" in info else None,
            "analyses": info["context"].stats()["analyses"]}
    res = solve_ic0_pcg(a, data["b_panel"], device="cpu", config=opts, tol=TOL, group=group)
    xs["krylov/pcg_panel"] = res.x

    # ranks whose residuals differ stop together: rank 0 solves for b, the
    # others for an eigenvector of A, the matvec a collective
    spmv = SpMV(build_plan(a, D, SolverConfig(block_size=B)), "cpu", group)
    alone = SpMV(build_plan(a, 1, SolverConfig(block_size=B)), "cpu")
    mine = b if rank == 0 else data["b_other"]

    def agree(relres):
        return comm.group_max(relres, group, "cpu")

    def matvec(v):
        y = alone.matvec(v)
        spmv.matvec(np.zeros_like(v))  # a collective a matvec, as a group's
        return y

    together = pcg(matvec, mine, tol=TOL, agree=agree)
    report["stop"] = {"together": together.n_iters, "history": together.history,
                      "alone": pcg(alone.matvec, mine, tol=TOL).n_iters}

    # modelled "auto": rank 0's scores and choice on every rank
    _, _, dec, _ = autotune.tune(a, PlanOptions(**AUTO), "cpu", group=group)
    report["auto/modelled"] = {"chosen": list(dec.chosen), "mode": dec.mode,
                               "scores": {"/".join(c): s for c, s in dec.scores.items()}}

    # probed "auto": every rank's clock but rank 0's is slowed by seconds,
    # the more the earlier the candidate, so alone this rank would pick
    # the last candidate; the group's times are its slowest rank's
    saves = []
    store = cal.CalibrationStore(path=os.path.join(out, "calibration.json"))
    real_save = store.save
    store.save = lambda path: (saves.append(path), real_save(path))
    cal.set_store(store)
    built = []
    real_solver, real_time = autotune.Solver, autotune.time
    if rank > 0:
        offset = [0.0]

        def slow_clock():  # each reading 40 - (candidates built) s later
            offset[0] += 40 - len(built)
            return real_time.perf_counter() + offset[0]

        autotune.time = types.SimpleNamespace(perf_counter=slow_clock)

    def solver(plan, dev, g):
        built.append(plan.config)
        return real_solver(plan, dev, g)

    autotune.Solver = solver
    try:
        ctx = SpTRSVContext(device="cpu", group=group)
        h = ctx.analyse(a, PlanOptions(**AUTO, probe_solves=1))
        x = ctx.solve(h, b)
    finally:
        autotune.Solver, autotune.time = real_solver, real_time
    d = h.auto
    xs["auto/probed"] = x
    report["auto/probed"] = {
        "chosen": list(d.chosen), "mode": d.mode, "candidates": len(built),
        "probe_us": {"/".join(c): v for c, v in d.probe_us.items()},
        "compile_us": {"/".join(c): v for c, v in d.compile_us.items()},
        "last": "/".join((built[-1].sched, built[-1].comm, built[-1].kernel_backend)),
        "saves": len(saves), "samples": store.sample_groups()}
    cal.set_store(None)

    # the plan store: a cold session analyses and rank 0 saves; a warm one
    # hits on every rank
    root = os.path.join(out, "store")
    for phase in ("cold", "warm"):
        store = PlanStore(root)
        ctx = SpTRSVContext(device="cpu", group=group, plan_store=store, options=opts)
        h = ctx.analyse(read_csr(data, "mix1"))
        xs[f"store/{phase}/forward"] = ctx.solve(h, data["b_dy"])
        xs[f"store/{phase}/transpose"] = ctx.solve(h, data["b_dy"], transpose=True)
        report[f"store/{phase}"] = {"session": ctx.stats(), "store": store.stats}
    ctx = SpTRSVContext(device="cpu", group=group, plan_store=PlanStore(root),
                        options=PlanOptions(**AUTO))
    h = ctx.analyse(a)
    report["store/auto"] = {"chosen": list(h.auto.chosen), "session": ctx.stats()}

    # the engine: a dyadic mix, drained, then from the background thread
    mats = [read_csr(data, f"mix{p}") for p in range(2)]
    rhs, want = data["mix_rhs"], data["mix_x"]
    pick = data["mix_pattern"]
    for mode in ("drain", "thread"):
        engine = SolveEngine(device="cpu", group=group, options=opts, max_batch=4)
        got = []
        if rank == 0:
            if mode == "thread":
                engine.start()
            tickets = [engine.submit(f"t{i % 3}", mats[p], rhs[i][: mats[p].n])
                       for i, p in enumerate(pick)]
            if mode == "drain":
                engine.drain()
                engine.close()
            got = [t.result(timeout=120) for t in tickets]
            if mode == "thread":
                engine.stop()
            report[f"engine/{mode}"] = {
                "exact": [bool(np.array_equal(x, want[i][: len(x)]))
                          for i, x in enumerate(got)],
                "batches": engine.stats()["batches"]}
        else:
            if mode == "drain":
                served = engine.follow()
            else:
                engine.start()
                engine.stop()
                served = engine.stats().get("batches", 0)
            report[f"engine/{mode}"] = {"batches": served}

    np.savez(os.path.join(out, f"rank{rank}.npz"), **xs)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()


def _port_main(D: int, inputs: str, out: str) -> None:
    """Fork the D ranks (the port is imported once, here) and wait for them."""
    import torch  # noqa: F401
    import repro_torch.api  # noqa: F401
    import repro_torch.krylov  # noqa: F401
    import repro_torch.service  # noqa: F401
    from torch_parity import fork_ranks

    fork_ranks(_rank, D, (inputs, out))


# ---------------------------------------------------------------------------
# the reference's side (runs in a process of its own)
# ---------------------------------------------------------------------------

REFERENCE = textwrap.dedent("""
    import json, sys
    import numpy as np, jax
    from repro import compat
    from repro.api import PlanOptions
    from repro.api import autotune
    from repro.core import SolverConfig
    from repro.core.solver import build_plan
    from repro.krylov import DistributedSpMV, solve_ic0_pcg, solve_ilu0_bicgstab
    from repro.sparse.matrix import CSR
    inputs, out = sys.argv[1], sys.argv[2]
    data = np.load(inputs)

    def csr(key):
        return CSR(n=int(data[key + "/n"]), row_ptr=data[key + "/row_ptr"],
                   col_idx=data[key + "/col_idx"], val=data[key + "/val"])

    a, a_dy, b = csr("spd"), csr("spd_dy"), data["b"]
    cfg = SolverConfig(block_size=%(B)d, comm="zerocopy", kernel_backend="reference")
    xs, report = {}, {}
    for D in (2, 4):
        mesh = compat.make_mesh((D,), ("x",), devices=jax.devices()[:D])
        for name, mat in (("dyadic", a_dy), ("real", a)):
            spmv = DistributedSpMV(build_plan(mat, D, cfg), mesh)
            xs[f"{D}/spmv/{name}/vector"] = spmv.matvec(data["v"])
            xs[f"{D}/spmv/{name}/panel"] = spmv.matvec(data["v_panel"])
        for method, fn in (("pcg", solve_ic0_pcg), ("bicgstab", solve_ilu0_bicgstab)):
            res = fn(a, b, mesh=mesh, config=cfg, tol=%(TOL)r)
            xs[f"{D}/krylov/{method}"] = res.x
            report[f"{D}/krylov/{method}"] = {"n_iters": res.n_iters,
                                              "history": res.history}
        _, _, dec, _ = autotune.tune(a, PlanOptions(sched="auto", comm="auto",
                                                    kernel="auto", block_size=%(B)d), mesh)
        report[f"{D}/auto"] = {"chosen": list(dec.chosen), "mode": dec.mode,
                               "scores": {"/".join(c): s for c, s in dec.scores.items()}}
    np.savez(out + ".npz", **xs)
    with open(out + ".json", "w") as f:
        json.dump(report, f)
""" % {"B": B, "TOL": TOL})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Write the inputs, start the reference and both port runs together,
    wait for all of them, and return the inputs with their results."""
    import json

    import strategies
    from torch_parity import RANK_TIMEOUT, rank_results, run_together
    from repro.krylov import spd_lower_from_triangular, symmetric_full_csr
    from repro.sparse import suite
    from repro.sparse.matrix import to_scipy

    tmp = tmp_path_factory.mktemp("dist_krylov")
    a = spd_lower_from_triangular(suite.grid2d_factor(SIDE, seed=1))
    a_dy = strategies.dyadic(a, seed=3)
    rng = np.random.default_rng(2)
    # an eigenvector of A: CG converges in an iteration or two, where b
    # takes about twenty
    eig = np.linalg.eigh(to_scipy(symmetric_full_csr(a)).toarray())[1][:, -1]
    data = {"b": rng.uniform(-1, 1, a.n), "b_other": eig,
            "b_panel": rng.uniform(-1, 1, (a.n, 2)),
            "v": strategies.dyadic_rhs(a.n, seed=4),
            "v_panel": np.stack([strategies.dyadic_rhs(a.n, seed=5),
                                 strategies.dyadic_rhs(a.n, seed=6)], axis=1),
            "b_dy": strategies.dyadic_rhs(strategies.EXACT_MATRICES["skewed"]().n, seed=7)}
    for key, m in (("spd", a), ("spd_dy", a_dy)):
        data.update({f"{key}/n": m.n, f"{key}/row_ptr": m.row_ptr,
                     f"{key}/col_idx": m.col_idx, f"{key}/val": m.val})
    # the engine's dyadic mix: two patterns, twelve requests, b = L x
    mats = [strategies.EXACT_MATRICES[m]() for m in ("banded", "skewed")]
    pick = rng.integers(0, 2, 12)
    n_max = max(m.n for m in mats)
    mix_x = np.zeros((12, n_max), np.float32)
    mix_rhs = np.zeros((12, n_max), np.float32)
    for i, p in enumerate(pick):
        x = rng.integers(-4, 5, mats[p].n).astype(np.float64)
        mix_x[i, : mats[p].n] = x
        mix_rhs[i, : mats[p].n] = to_scipy(mats[p]) @ x
    for p, m in enumerate(mats):
        data.update({f"mix{p}/n": m.n, f"mix{p}/row_ptr": m.row_ptr,
                     f"mix{p}/col_idx": m.col_idx, f"mix{p}/val": m.val})
    data.update(mix_x=mix_x, mix_rhs=mix_rhs, mix_pattern=pick)
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **data)

    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    # the CLIs on two gloo ranks, beside the parity runs: serve_solve cold
    # then warm on one store, solve with probed "auto" and a store
    logs = {name: tmp / f"{name}.log" for name in ("serve", "solve")}
    clis = {"serve": " && ".join(" ".join(CLI + ["-m", "repro_torch.launch.serve_solve",
                                                 *SERVE, "--plan-store", str(tmp / "serve"),
                                                 *extra])
                                 for extra in ([], ["--assert-warm"])),
            "solve": " ".join(CLI + ["-m", "repro_torch.launch.solve", *SOLVE,
                                     "--plan-store", str(tmp / "solve")])}
    procs = {name: subprocess.Popen(["bash", "-c", cmd], env=env, cwd=tmp,
                                    stdout=open(logs[name], "w"), stderr=subprocess.STDOUT)
             for name, cmd in clis.items()}
    commands = {"reference": (
        [sys.executable, "-c", REFERENCE, inputs, str(tmp / "reference")],
        {"JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})}
    for D in DEVICES:
        (tmp / f"port{D}").mkdir()
        commands[f"port {D}"] = (
            [sys.executable, os.path.abspath(__file__), str(D), inputs, str(tmp / f"port{D}")],
            {})
    run_together(commands, env)
    cli = {name: (p.wait(timeout=RANK_TIMEOUT), logs[name].read_text())
           for name, p in procs.items()}
    ref = (dict(np.load(tmp / "reference.npz")),
           json.load(open(tmp / "reference.json")))
    port = {D: rank_results(tmp / f"port{D}", D) for D in DEVICES}
    return a, data, ref, port, cli


@pytest.mark.parametrize("form", ["vector", "panel"])
@pytest.mark.parametrize("D", DEVICES)
def test_spmv_bit_identical_to_the_reference(runs, D, form):
    """Dyadic matrix and vectors: every rank's ``y`` is the reference's
    ``DistributedSpMV`` bit for bit; one ``all_reduce`` a matvec."""
    _, _, (ref, _), port, _ = runs
    want = ref[f"{D}/spmv/dyadic/{form}"]
    for r, (xs, report) in enumerate(port[D]):
        np.testing.assert_array_equal(xs[f"spmv/dyadic/{form}"], want, err_msg=f"rank {r}")
        c = report["spmv/dyadic"]
        assert c["all_reduces"] == c["exchanges"] == c["matvecs"] == 2, c


@pytest.mark.parametrize("form", ["vector", "panel"])
@pytest.mark.parametrize("D", DEVICES)
def test_spmv_real_values_match_scipy_and_the_reference(runs, D, form):
    from repro.krylov import symmetric_full_csr
    from repro.sparse.matrix import to_scipy

    a, data, (ref, _), port, _ = runs
    v = data["v"] if form == "vector" else data["v_panel"]
    want = to_scipy(symmetric_full_csr(a)) @ v.astype(np.float64)
    for xs, _ in port[D]:
        got = xs[f"spmv/real/{form}"]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, ref[f"{D}/spmv/real/{form}"], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("D", DEVICES)
def test_krylov_matches_the_reference_on_d_devices(runs, D, method):
    """The reference's D-device iteration count, its history at rtol 1e-4,
    ``x`` within 1e-5 of ``spsolve``; one analysis, the solves audited."""
    import scipy.sparse.linalg as spla

    from repro.krylov import symmetric_full_csr
    from repro.sparse.matrix import to_scipy

    a, data, (_, rep), port, _ = runs
    want = rep[f"{D}/krylov/{method}"]
    x_ref = spla.spsolve(to_scipy(symmetric_full_csr(a)).tocsc(), data["b"])
    per_iter = 1 if method == "pcg" else 2
    for xs, report in port[D]:
        c = report[f"krylov/{method}"]
        assert c["converged"] and c["n_iters"] == want["n_iters"], (c["n_iters"], want)
        np.testing.assert_allclose(c["history"], want["history"], rtol=1e-4, atol=1e-12)
        np.testing.assert_allclose(xs[f"krylov/{method}"], x_ref, rtol=1e-5, atol=1e-5)
        assert c["forward"] == c["backward"] == per_iter * c["n_iters"], c
        assert c["spmv_exchanges"] == c["matvecs"] > 0 and c["analyses"] == 1, c


@pytest.mark.parametrize("what", ["spmv/dyadic/vector", "spmv/real/panel", "krylov/pcg",
                                  "krylov/bicgstab", "krylov/cg", "krylov/pcg_panel"])
@pytest.mark.parametrize("D", DEVICES)
def test_every_rank_returns_the_same_bits(runs, D, what):
    (xs0, rep0), *others = runs[3][D]
    for r, (xs, rep) in enumerate(others, 1):
        np.testing.assert_array_equal(xs[what], xs0[what], err_msg=f"rank {r}")
        if what.startswith("krylov/") and what != "krylov/pcg_panel":
            assert rep[what]["n_iters"] == rep0[what]["n_iters"]
            assert rep[what]["history"] == rep0[what]["history"]


@pytest.mark.parametrize("D", DEVICES)
def test_cg_and_the_pcg_panel_converge(runs, D):
    import scipy.sparse.linalg as spla

    from repro.krylov import symmetric_full_csr
    from repro.sparse.matrix import to_scipy

    a, data, _, port, _ = runs
    full = to_scipy(symmetric_full_csr(a)).tocsc()
    for xs, report in port[D]:
        assert report["krylov/cg"]["converged"]
        assert report["krylov/cg"]["n_iters"] > report["krylov/pcg"]["n_iters"]
        np.testing.assert_allclose(xs["krylov/cg"], spla.spsolve(full, data["b"]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(xs["krylov/pcg_panel"], spla.spsolve(full, data["b_panel"]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("D", DEVICES)
def test_ranks_whose_residuals_differ_stop_together(runs, D):
    """Alone, the ranks' right-hand sides converge in different iteration
    counts; under the group's max every rank takes the slowest count, with
    the same history, and none is left in a collective (the run ended)."""
    ranks = runs[3][D]
    alone = [rep["stop"]["alone"] for _, rep in ranks]
    together = {rep["stop"]["together"] for _, rep in ranks}
    assert len(set(alone)) > 1, alone
    assert together == {max(alone)}, (together, alone)
    assert len({tuple(rep["stop"]["history"]) for _, rep in ranks}) == 1


@pytest.mark.parametrize("D", DEVICES)
def test_modelled_auto_matches_the_reference(runs, monkeypatch, D):
    """``probe_solves=0`` at D devices: the reference's candidate grid (both
    comm modes), its scores at rtol 1e-12 (a streamed candidate's bulk-copy
    term the port's own, as ``tests/test_torch_autotune.py`` holds at one
    device) and its choice, on every rank."""
    from test_torch_autotune import _dma_term
    from torch_parity import to_torch_csr
    from repro.api import PlanOptions as JPlanOptions
    from repro.api import autotune as jauto
    from repro.core import solver as jsolver
    from repro_torch.api import PlanOptions, autotune
    from repro_torch.core import solver as tsolver

    monkeypatch.setenv(tsolver.ENV_STREAM_LIMIT, str(2**62))  # as in the ranks
    a, _, (_, rep), port, _ = runs
    want = rep[f"{D}/auto"]
    opts, jopts = PlanOptions(**AUTO), JPlanOptions(**AUTO)
    grid = autotune.candidate_grid(opts, D, "cpu")
    assert grid == jauto.candidate_grid(jopts, D)
    assert {c[1] for c in grid} == {"zerocopy", "unified"}
    adjusted = {}
    for key, score in want["scores"].items():
        sched, comm, kernel = key.split("/")
        jplan = jsolver.build_plan(a, D, jopts.to_config(sched=sched, comm=comm, kernel=kernel))
        tplan = tsolver.build_plan(to_torch_csr(a), D, opts.to_config(
            sched=sched, comm=comm, kernel=kernel))
        pen = autotune.INTERPRET_PENALTY if (kernel in ("fused", "fused_streamed")
                                             and sched != "syncfree") else 1.0
        adjusted[key] = (score / pen - _dma_term(jplan, jsolver, jsolver.fused_streaming)
                         + _dma_term(tplan, tsolver, tsolver.fused_streaming)) * pen
    for _, report in port[D]:
        got = report["auto/modelled"]
        assert got["mode"] == want["mode"] == "modelled"
        assert set(got["scores"]) == set(want["scores"])
        for combo, score in got["scores"].items():
            np.testing.assert_allclose(score, adjusted[combo], rtol=1e-12, err_msg=combo)
        assert got["chosen"] == want["chosen"]
        assert min(adjusted, key=adjusted.get) == "/".join(got["chosen"])


@pytest.mark.parametrize("D", DEVICES)
def test_probed_auto_reaches_one_decision(runs, D):
    """Every rank but 0 slows its clock (seconds, most for the first
    candidate): the group's times are the slowest rank's, so every rank
    has the same ``probe_us`` and ``compile_us``, picks the last candidate,
    and solves with it; rank 0 alone writes the calibration file, and every
    rank's store holds the same samples."""
    ranks = runs[3][D]
    reps = [rep["auto/probed"] for _, rep in ranks]
    r0 = reps[0]
    assert r0["mode"] == "probed" and r0["candidates"] > 1
    for rep in reps[1:]:
        for key in ("chosen", "probe_us", "compile_us", "samples"):
            assert rep[key] == r0[key], key
    assert "/".join(r0["chosen"]) == r0["last"]
    assert min(r0["probe_us"].values()) > 1e6  # seconds: the slowed ranks' times
    assert r0["saves"] == r0["candidates"] and all(rep["saves"] == 0 for rep in reps[1:])
    assert sum(len(v) for v in r0["samples"].values()) == r0["candidates"]
    xs = [x["auto/probed"] for x, _ in ranks]
    assert all(np.array_equal(x, xs[0]) for x in xs)


@pytest.mark.parametrize("D", DEVICES)
def test_plan_store_hits_on_every_rank(runs, D):
    """Cold: one analysis and two saves (forward, transpose), on rank 0
    alone; warm: two store hits and no analysis on every rank, the solves
    bit-equal to the cold session's and exact; a store written by one
    options' session serves ``"auto"`` only after its own analysis."""
    from repro.sparse.matrix import reference_solve

    from torch_parity import read_csr

    _, data, _, port, _ = runs

    exact = reference_solve(read_csr(data, "mix1"), data["b_dy"]).astype(np.float32)
    for r, (xs, rep) in enumerate(port[D]):
        cold, warm = rep["store/cold"], rep["store/warm"]
        assert cold["session"]["analyses"] == 1 and not cold["session"].get("plan_store_hits")
        assert cold["store"].get("saves", 0) == (2 if r == 0 else 0), (r, cold)
        assert warm["session"]["plan_store_hits"] == 2, warm
        assert not warm["session"].get("analyses") and not warm["store"].get("rejected")
        for form in ("forward", "transpose"):
            np.testing.assert_array_equal(xs[f"store/warm/{form}"], xs[f"store/cold/{form}"])
        np.testing.assert_array_equal(xs["store/cold/forward"], exact)
        assert rep["store/auto"]["session"]["analyses"] == 1
        assert rep["store/auto"]["chosen"] == port[D][0][1]["store/auto"]["chosen"]


@pytest.mark.parametrize("mode", ["drain", "thread"])
@pytest.mark.parametrize("D", DEVICES)
def test_engine_serves_a_dyadic_mix_on_every_rank(runs, D, mode):
    """Rank 0 takes twelve requests of two dyadic patterns; every ticket is
    the exact ``x``; each other rank served as many batches as rank 0."""
    ranks = runs[3][D]
    rep0 = ranks[0][1][f"engine/{mode}"]
    assert rep0["exact"] == [True] * 12, rep0
    assert 2 <= rep0["batches"] <= 12
    for _, rep in ranks[1:]:
        assert rep[f"engine/{mode}"]["batches"] == rep0["batches"]


def test_serve_solve_cli_under_torch_distributed(runs):
    """``launch/serve_solve.py`` on two gloo ranks: the dyadic mix exact and
    each ticket its solo solve's bits (exit 0), rank 0 reporting once a
    run; the warm run on the cold run's store makes no analysis."""
    code, log = runs[4]["serve"]
    assert code == 0, log[-3000:]
    assert log.count("req/s") == 2 and log.count("D=2") == 2, log[-3000:]
    assert "analyses=0 plan_store_hits=3" in log, log[-3000:]


def test_solve_cli_probes_and_stores_under_torch_distributed(runs):
    """``launch/solve.py --probe 1 --plan-store`` with ``"auto"`` options on
    two gloo ranks: probed, saved once, within ``--tol`` of scipy."""
    code, log = runs[4]["solve"]
    assert code == 0, log[-3000:]
    assert "D=2" in log and "(probed" in log and "saves=1" in log, log[-3000:]
    assert log.count("ms/solve") == 1, log[-3000:]


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    _port_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
