"""Multi-device ``comm="zerocopy"`` and ``sched="syncfree"`` on the CPU: the
port's executors on D gloo ranks against the reference's
``DistributedSolver`` on a D-device mesh, for D = 4 and 8.

Subprocesses run once for the module, side by side: for each D, the
reference on a mesh of D forced host devices (one process per suite) and
one process that imports the port and forks D ranks of one gloo group (no
JAX there); beside them
``launch/solve.py`` under ``torch.distributed.run`` on two gloo ranks. The
reference runs its switch executor and its syncfree dense scan (backend
``reference``, no Pallas interpret mode); on the dyadic suites every
intermediate is exact, so its executors agree bit for bit, and each of the
port's executors (switch, resident and streamed split megakernels, the
syncfree dense scan and frontier form) is held to those bits. At D = 4
both dyadic suites run; at D = 8 ``skewed`` alone. The parent writes the
inputs (``torch_parity.multi_device_inputs``) and the tests read the
results: every rank's ``x`` bit for bit against the reference's, real
values within rtol = atol = 2e-4 of ``reference_solve``, exchange, launch
and ``all_reduce`` counts against ``dispatch_stats`` (syncfree: one
exchange a sweep, ``n_levels`` sweeps), the empty cut, a refresh, strict
verification of every plan run.

Run as ``python tests/test_torch_zerocopy.py D INPUTS OUT`` this file is
the port's side: it forks the D ranks and writes one ``.npz`` and one
``.json`` per rank to OUT.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
B = 8
# the dyadic suites each D runs
MATRICES = {4: ("banded", "skewed"), 8: ("skewed",)}
CELLS = [(D, m) for D, ms in MATRICES.items() for m in ms]
SCHEDS = ("levelset", "dagpart")
KERNELS = ("reference", "fused", "fused_streamed")
# syncfree: the dense scan (reference) and the frontier form (fused)
SYNCFREE_KERNELS = ("reference", "fused")
COMMS = ("zerocopy", "unified")
FORMS = ("forward", "transpose", "panel")
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
    report = rec.report

    def session(**kw):
        return SpTRSVContext(device="cpu", group=group,
                             options=PlanOptions(**{"block_size": B, **kw}))

    def forms(ctx, h, m, key):
        b, panel = data[m + "/b"], data[m + "/panel"]
        rec.solve(ctx, h, b, key + "/forward")
        rec.solve(ctx, h, b, key + "/transpose", transpose=True)
        rec.solve(ctx, h, panel, key + "/panel")

    def refresh(ctx, h, key):
        # a refresh to new values solves with them, then back
        ctx.factorize(read_csr(data, "skewed_new"), h)
        rec.solve(ctx, h, data["skewed/b"], key + "/refreshed")
        ctx.factorize(read_csr(data, "skewed"), h)
        rec.solve(ctx, h, data["skewed/b"], key + "/refreshed_back")

    for m in MATRICES[D]:
        a = read_csr(data, m)
        for sched in SCHEDS:
            for kernel in KERNELS:
                ctx = session(comm="zerocopy", sched=sched, kernel=kernel)
                h = ctx.analyse(a)
                key = f"{m}/zerocopy/{sched}/{kernel}"
                forms(ctx, h, m, key)
                if m == "skewed" and sched == "dagpart":
                    report[key + "/ranges"] = rec.ranges(ctx, h, data[m + "/b"])
                    refresh(ctx, h, key)
        for comm in COMMS:
            for kernel in SYNCFREE_KERNELS:
                ctx = session(comm=comm, sched="syncfree", kernel=kernel)
                h = ctx.analyse(a)
                key = f"{m}/{comm}/syncfree/{kernel}"
                forms(ctx, h, m, key)
                if m == "skewed":
                    report[key + "/ranges"] = rec.ranges(ctx, h, data[m + "/b"])
                    refresh(ctx, h, key)
    real, uncut = read_csr(data, "real"), read_csr(data, "uncut")
    for kernel in KERNELS:  # real values; an empty cut: no exchange, one launch
        ctx = session(block_size=16, comm="zerocopy", sched="dagpart", kernel=kernel)
        rec.solve(ctx, ctx.analyse(real), data["real/b"], f"real/zerocopy/dagpart/{kernel}")
        ctx = session(comm="zerocopy", partition="contiguous", kernel=kernel)
        rec.solve(ctx, ctx.analyse(uncut), data["uncut/b"], f"uncut/zerocopy/levelset/{kernel}")
    for comm in COMMS:
        for kernel in SYNCFREE_KERNELS:
            ctx = session(block_size=16, comm=comm, sched="syncfree", kernel=kernel)
            rec.solve(ctx, ctx.analyse(real), data["real/b"], f"real/{comm}/syncfree/{kernel}")
            ctx = session(comm=comm, sched="syncfree", partition="contiguous", kernel=kernel)
            rec.solve(ctx, ctx.analyse(uncut), data["uncut/b"],
                      f"uncut/{comm}/syncfree/{kernel}")
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
    inputs, out, D, matrices = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4:]
    data = np.load(inputs)
    mesh = compat.make_mesh((D,), ("x",), devices=jax.devices()[:D])
    xs = {}
    for m in matrices:
        a = CSR(n=int(data[m + "/n"]), row_ptr=data[m + "/row_ptr"],
                col_idx=data[m + "/col_idx"], val=data[m + "/val"])
        b, panel = data[m + "/b"], data[m + "/panel"]
        for comm, sched in (("zerocopy", "levelset"), ("zerocopy", "dagpart"),
                            ("zerocopy", "syncfree"), ("unified", "syncfree")):
            cfg = SolverConfig(block_size=%d, comm=comm, sched=sched,
                               kernel_backend="reference")
            fw = DistributedSolver(build_plan(a, D, cfg), mesh)
            tr = DistributedSolver(build_plan(a, D, cfg, transpose=True), mesh)
            key = f"{D}/{m}/{comm}/{sched}"
            xs[key + "/forward"] = fw.solve(b)
            xs[key + "/transpose"] = tr.solve(b)
            xs[key + "/panel"] = fw.solve(panel)
    np.savez(out, **xs)
""" % B)

# launch/solve.py's defaults (comm="zerocopy") with the syncfree scheduler,
# two gloo ranks on the CPU (full option names: torch.distributed.run reads
# an abbreviation of one of its own, such as --n, as its own)
CLI = ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
       "-m", "repro_torch.launch.solve", "--matrix", "random", "--n", "600",
       "--levels", "12", "--block-size", "8", "--sched", "syncfree", "--dist-backend",
       "gloo", "--device", "cpu", "--repeats", "1", "--tol", "1e-4", "--verify"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the reference, the port and the CLI runs together, wait for
    all of them, and return their results with the inputs."""
    from torch_parity import multi_device_inputs, rank_results, run_together

    tmp = tmp_path_factory.mktemp("zerocopy")
    inputs = str(tmp / "inputs.npz")
    probs = multi_device_inputs(inputs, B)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    commands = {}
    for D, m in CELLS:  # one reference process per suite: the compiles set its pace
        commands[f"reference {D} {m}"] = (
            [sys.executable, "-c", REFERENCE, inputs, str(tmp / f"reference{D}-{m}.npz"),
             str(D), m],
            {"JAX_PLATFORMS": "cpu", "XLA_FLAGS": f"--xla_force_host_platform_device_count={D}"})
    for D in MATRICES:
        (tmp / f"port{D}").mkdir()
        commands[f"port {D}"] = (
            [sys.executable, os.path.abspath(__file__), str(D), inputs, str(tmp / f"port{D}")],
            {})
    cli_log = tmp / "cli.log"
    with open(cli_log, "w") as log:
        cli = subprocess.Popen([sys.executable, *CLI], env=env, stdout=log,
                               stderr=subprocess.STDOUT, cwd=tmp)
        run_together(commands, env)
        cli_code = cli.wait(timeout=300)
    ref = {k: v for D, m in CELLS for k, v in np.load(tmp / f"reference{D}-{m}.npz").items()}
    port = {D: rank_results(tmp / f"port{D}", D) for D in MATRICES}
    return probs, ref, port, (cli_code, cli_log.read_text())


def _ranks(runs, D):
    return runs[2][D]


def _solves(report: dict, comm: str, scheds: tuple, kernel: str) -> list:
    """The tags of every solve a rank recorded under ``comm``, one of
    ``scheds`` and ``kernel`` (tags read ``problem/comm/sched/kernel...``)."""
    return [t for t, c in report.items() if isinstance(c, dict) and "verified" in c
            and t.split("/")[1] == comm and t.split("/")[2] in scheds
            and t.split("/")[3] == kernel]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("sched", SCHEDS)
@pytest.mark.parametrize("D, matrix", CELLS)
def test_zerocopy_every_rank_bit_identical_to_the_reference(runs, D, matrix, sched, kernel,
                                                            form):
    want = runs[1][f"{D}/{matrix}/zerocopy/{sched}/{form}"]
    for r, (xs, _) in enumerate(_ranks(runs, D)):
        np.testing.assert_array_equal(xs[f"{matrix}/zerocopy/{sched}/{kernel}/{form}"], want,
                                      err_msg=f"rank {r}")


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("kernel", SYNCFREE_KERNELS)
@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("D, matrix", CELLS)
def test_syncfree_every_rank_bit_identical_to_the_dense_scan(runs, D, matrix, comm, kernel,
                                                             form):
    """Both forms, dense scan and frontier, against the reference's dense
    scan under the same comm mode."""
    want = runs[1][f"{D}/{matrix}/{comm}/syncfree/{form}"]
    for r, (xs, _) in enumerate(_ranks(runs, D)):
        np.testing.assert_array_equal(xs[f"{matrix}/{comm}/syncfree/{kernel}/{form}"], want,
                                      err_msg=f"rank {r}")


def _real_tags():
    return ([f"zerocopy/dagpart/{k}" for k in KERNELS]
            + [f"{c}/syncfree/{k}" for c in COMMS for k in SYNCFREE_KERNELS])


@pytest.mark.parametrize("tag", _real_tags())
@pytest.mark.parametrize("D", sorted(MATRICES))
def test_real_values_within_tolerance(runs, D, tag):
    from repro.sparse.matrix import reference_solve

    a, b = runs[0]["real"]
    want = reference_solve(a, b)
    for xs, report in _ranks(runs, D):
        assert report[f"real/{tag}"]["boundary"] > 0
        np.testing.assert_allclose(xs[f"real/{tag}"], want, **TOL)


@pytest.mark.parametrize("tag", [f"zerocopy/dagpart/{k}" for k in KERNELS]
                         + [f"{c}/syncfree/{k}" for c in COMMS for k in SYNCFREE_KERNELS])
@pytest.mark.parametrize("D", sorted(MATRICES))
def test_refresh_solves_with_new_values_and_back(runs, D, tag):
    from repro.sparse.matrix import reference_solve

    new, bn = runs[0]["skewed_new"]
    exact_new = reference_solve(new, bn).astype(np.float32)
    for xs, _ in _ranks(runs, D):
        np.testing.assert_array_equal(xs[f"skewed/{tag}/refreshed"], exact_new)
        np.testing.assert_array_equal(xs[f"skewed/{tag}/refreshed_back"],
                                      xs[f"skewed/{tag}/forward"])


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("D", sorted(MATRICES))
def test_zerocopy_exchanges_and_launches_are_dispatch_stats(runs, D, kernel):
    """Per solve: one packed exchange per level with exchange rows, as
    ``dispatch_stats`` says, and one ``all_reduce`` more (the gather); under
    the fused backends one split launch per exchange segment (one more than
    the exchanges: the first segment starts at level 0) and no unsplit
    one, streamed exactly under ``fused_streamed``; every plan verifies
    strict."""
    for _, report in _ranks(runs, D):
        tags = _solves(report, "zerocopy", SCHEDS, kernel)
        # per suite 2 scheds x 3 forms; a refresh and back; real; uncut
        assert len(tags) == len(MATRICES[D]) * 6 + 4, tags
        for tag in tags:
            c = report[tag]
            assert c["verified"], tag
            if tag.startswith("uncut/"):
                continue
            assert c["boundary"] > 0 and c["exchanges"] == c["want_exchanges"] > 0, (tag, c)
            assert c["all_reduces"] == c["exchanges"] + 1, (tag, c)
            if kernel != "reference":
                assert c["split"] == c["want_launches"] == c["exchanges"] + 1, (tag, c)
                assert c["whole"] == 0, (tag, c)
                assert (c["streamed"] > 0) == (kernel == "fused_streamed"), (tag, c)
            else:
                assert c["split"] == c["whole"] == 0, (tag, c)


@pytest.mark.parametrize("kernel", SYNCFREE_KERNELS)
@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("D", sorted(MATRICES))
def test_syncfree_sweeps_and_exchanges(runs, D, comm, kernel):
    """Per solve on every rank: ``n_levels`` sweeps, one exchange a sweep
    made of two ``all_reduce`` calls (values; counts with the rows left),
    then the gather; no megakernel launch; every plan verifies strict."""
    for _, report in _ranks(runs, D):
        tags = [t for t in _solves(report, comm, ("syncfree",), kernel)
                if not t.startswith("uncut/")]
        # per suite 3 forms; a refresh and back; real
        assert len(tags) == len(MATRICES[D]) * 3 + 3, tags
        for tag in tags:
            c = report[tag]
            assert c["verified"] and c["boundary"] > 0, (tag, c)
            assert c["sweeps"] == c["levels"] == c["exchanges"] > 0, (tag, c)
            assert c["all_reduces"] == 2 * c["exchanges"] + 1, (tag, c)
            assert c["split"] == c["whole"] == 0, (tag, c)


@pytest.mark.parametrize("tag", [f"zerocopy/levelset/{k}" for k in KERNELS]
                         + [f"{c}/syncfree/{k}" for c in COMMS for k in SYNCFREE_KERNELS])
@pytest.mark.parametrize("D", sorted(MATRICES))
def test_empty_cut_exchanges_nothing(runs, D, tag):
    """A contiguous partition that cuts nothing: every rank exact, no
    exchange; a fused solve is one unsplit launch, a syncfree solve still
    takes ``n_levels`` sweeps, summing the rows left once a sweep."""
    from repro.sparse.matrix import reference_solve

    a, b = runs[0]["uncut"]
    want = reference_solve(a, b).astype(np.float32)
    for xs, report in _ranks(runs, D):
        c = report[f"uncut/{tag}"]
        assert c["boundary"] == 0 and c["verified"], c
        np.testing.assert_array_equal(xs[f"uncut/{tag}"], want)
        assert c["exchanges"] == 0, c
        if "syncfree" in tag:
            assert c["sweeps"] == c["levels"] and c["all_reduces"] == c["levels"] + 1, c
        else:
            assert c["want_exchanges"] == 0 and c["all_reduces"] == 1, c  # the gather alone
            if not tag.endswith("/reference"):
                assert c["whole"] == c["want_launches"] == 1 and c["split"] == 0, c


@pytest.mark.parametrize("tag", [f"zerocopy/dagpart/{k}" for k in KERNELS]
                         + [f"{c}/syncfree/{k}" for c in COMMS for k in SYNCFREE_KERNELS])
def test_exchange_ranges_only_when_traced(runs, tag):
    """A solve enters no ``record_function`` range untraced; traced, one
    ``sptrsv.exchange`` per exchange and one ``sptrsv.gather``, beside one
    ``sptrsv.superstep`` per launch (fused backends) or ``sptrsv.level_solve``
    ranges (switch executor, syncfree)."""
    for D in MATRICES:
        for _, report in _ranks(runs, D):
            r = report[f"skewed/{tag}/ranges"]
            n_ex = report[f"skewed/{tag}/forward"]["exchanges"]
            assert r["off"] == [], r
            assert r["on"]["sptrsv.exchange"] == n_ex > 0, r
            assert r["on"]["sptrsv.gather"] == 1, r
            if "syncfree" in tag or tag.endswith("/reference"):
                assert r["on"]["sptrsv.level_solve"] > 0, r
            else:
                assert r["on"]["sptrsv.superstep"] == n_ex + 1, r


def test_cli_runs_zerocopy_syncfree_under_torch_distributed(runs):
    """``launch/solve.py`` with its default ``--comm zerocopy`` and
    ``--sched syncfree`` on two gloo ranks: the plan verifies, the solve is
    within ``--tol`` of scipy, and rank 0 reports once."""
    code, log = runs[3]
    assert code == 0, log[-3000:]
    assert log.count("ms/solve") == 1 and "rel.err" in log, log[-3000:]
    assert "D=2" in log, log[-3000:]


if __name__ == "__main__":
    _port_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
