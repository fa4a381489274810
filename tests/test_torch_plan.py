"""Port host side: sparse containers, suite generators, blocking, analysis,
partitions and plans are byte-identical to the reference package's."""
import dataclasses
import itertools

import numpy as np
import pytest

import strategies
from torch_parity import (
    assert_arrays_identical, assert_dispatch_stats_match, assert_plans_identical,
    flatten_plan, port_config, to_torch_csr,
)
from repro.core import analysis as janalysis, blocking as jblocking, partition as jpartition
from repro.core.solver import SolverConfig, build_plan, dispatch_stats, refresh_plan
from repro.sparse import matrix as jmatrix, suite as jsuite
from repro_torch.core import analysis as tanalysis, blocking as tblocking
from repro_torch.core import partition as tpartition, solver as tsolver
from repro_torch.sparse import matrix as tmatrix, suite as tsuite

PLAN_MATRICES = {
    "skewed": (strategies.EXACT_MATRICES["skewed"], 8),
    "grid": (strategies.SOLVER_MATRICES["grid"], 16),
}


def _csr_identical(a, b):
    assert a.n == b.n
    for f in ("row_ptr", "col_idx", "val"):
        assert_arrays_identical(getattr(a, f), getattr(b, f), f)


def test_suite_generators_identical():
    ref, port = jsuite.table1_suite(scale=0.02), tsuite.table1_suite(scale=0.02)
    assert [e.name for e in ref] == [e.name for e in port]
    for r, p in zip(ref, port):
        _csr_identical(r.build(), p.build())


def test_matrix_transforms_identical():
    a = strategies.random_triangular(n=150, seed=3, m=500)
    t = to_torch_csr(a)
    _csr_identical(jmatrix.reverse_transpose(a), tmatrix.reverse_transpose(t))
    _csr_identical(jmatrix.csr_transpose(a), tmatrix.csr_transpose(t))
    rng = np.random.default_rng(0)
    rows, cols = rng.integers(0, 90, 300), rng.integers(0, 90, 300)
    _csr_identical(jmatrix.lower_triangular_from_coo(90, rows, cols),
                   tmatrix.lower_triangular_from_coo(90, rows, cols))
    c_ref, c_port = jmatrix.csr_to_csc(a), tmatrix.csr_to_csc(t)
    c_port.validate()
    for f in ("col_ptr", "row_idx", "val"):
        assert_arrays_identical(getattr(c_ref, f), getattr(c_port, f), f)
    b = rng.uniform(-1, 1, a.n)
    np.testing.assert_array_equal(jmatrix.reference_solve(a, b), tmatrix.reference_solve(t, b))


@pytest.mark.parametrize("name", sorted(strategies.SOLVER_MATRICES))
def test_analysis_and_blocking_identical(name):
    a = strategies.SOLVER_MATRICES[name]()
    t = to_torch_csr(a)
    ls_r, ls_p = janalysis.level_sets(a), tanalysis.level_sets(t)
    assert ls_r.n_levels == ls_p.n_levels
    for f in ("level_ptr", "order", "level_of"):
        assert_arrays_identical(getattr(ls_r, f), getattr(ls_p, f), f)
    assert dataclasses.astuple(janalysis.metrics(a)) == dataclasses.astuple(tanalysis.metrics(t))
    assert_arrays_identical(janalysis.in_degrees(a), tanalysis.in_degrees(t), "in_degrees")
    bs_r, bs_p = jblocking.build_blocks(a, 16), tblocking.build_blocks(t, 16)
    for f in dataclasses.fields(bs_r):
        assert_arrays_identical(getattr(bs_r, f.name), getattr(bs_p, f.name), f.name)
    b = np.random.default_rng(1).uniform(-1, 1, (a.n, 3))
    assert_arrays_identical(jblocking.pad_rhs(b, bs_r), tblocking.pad_rhs(b, bs_p), "pad_rhs")


@pytest.mark.parametrize("strategy", ["contiguous", "taskpool", "malleable"])
@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_partition_merge_and_cut_stats_identical(strategy, D, seed):
    a = strategies.random_triangular(240, seed, 900)
    bs_r, bs_p = jblocking.build_blocks(a, 8), tblocking.build_blocks(to_torch_csr(a), 8)
    p_r = jpartition.make_partition(bs_r, D, strategy, 4)
    p_p = tpartition.make_partition(bs_p, D, strategy, 4)
    for f in ("owner", "boundary"):
        assert_arrays_identical(getattr(p_r, f), getattr(p_p, f), f)
    assert (p_r.n_devices, p_r.strategy, p_r.tasks_per_device) == \
        (p_p.n_devices, p_p.strategy, p_p.tasks_per_device)
    assert_arrays_identical(jpartition.remote_source_levels(bs_r, p_r),
                            tpartition.remote_source_levels(bs_p, p_p), "remote_source_levels")
    for kw in ({}, {"merge_width": 4}, {"merge_cost": 1e9}):
        assert_arrays_identical(jpartition.merge_levels(bs_r, p_r, **kw),
                                tpartition.merge_levels(bs_p, p_p, **kw), f"merge_levels {kw}")
    assert dataclasses.astuple(jpartition.cut_stats(bs_r, p_r)) == \
        dataclasses.astuple(tpartition.cut_stats(bs_p, p_p))


@pytest.mark.parametrize("matrix", sorted(PLAN_MATRICES))
@pytest.mark.parametrize("sched", ["levelset", "dagpart"])
@pytest.mark.parametrize("partition", ["taskpool", "contiguous", "malleable"])
@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("transpose", [False, True])
def test_plans_identical(matrix, sched, partition, D, transpose):
    build, B = PLAN_MATRICES[matrix]
    a = build()
    for comm in ("zerocopy", "unified"):
        cfg = SolverConfig(block_size=B, sched=sched, partition=partition, comm=comm,
                           tasks_per_device=4)
        ref = build_plan(a, D, cfg, transpose=transpose)
        port = tsolver.build_plan(to_torch_csr(a), D, port_config(cfg), transpose=transpose)
        assert_plans_identical(ref, port)
        assert ref.comm_bytes_per_solve == port.comm_bytes_per_solve
        assert_dispatch_stats_match(dispatch_stats(ref), ref, tsolver.dispatch_stats(port))


def test_syncfree_and_fused_plans_identical():
    """Syncfree and fused plans build byte-identically and report the
    reference's dispatch statistics, but for the fused executor's on-chip
    plan, which follows the port's rule."""
    a = strategies.SOLVER_MATRICES["levelled"]()
    for D, kw in itertools.product((1, 2), ({"sched": "syncfree"}, {"kernel_backend": "fused"},
                                            {"kernel_backend": "fused_streamed"})):
        cfg = SolverConfig(block_size=16, **kw)
        ref = build_plan(a, D, cfg)
        port = tsolver.build_plan(to_torch_csr(a), D, port_config(cfg))
        assert_plans_identical(ref, port)
        assert_dispatch_stats_match(dispatch_stats(ref), ref, tsolver.dispatch_stats(port))
    # this plan is small: the reference keeps it resident too
    assert not dispatch_stats(build_plan(a, 1, SolverConfig(block_size=16,
                                                            kernel_backend="fused")))["streamed"]


def test_partition_reuse_and_refresh_identical():
    a = strategies.SOLVER_MATRICES["levelled"]()
    a2 = jmatrix.CSR(n=a.n, row_ptr=a.row_ptr, col_idx=a.col_idx,
                     val=a.val * (1.0 + 0.25 * np.sin(np.arange(a.nnz))))
    cfg = SolverConfig(block_size=16)
    for transpose in (False, True):
        ref = refresh_plan(build_plan(a, 1, cfg, transpose=transpose), a2)
        port = tsolver.refresh_plan(
            tsolver.build_plan(to_torch_csr(a), 1, port_config(cfg), transpose=transpose),
            to_torch_csr(a2))
        assert_plans_identical(ref, port)
        assert_plans_identical(port, tsolver.build_plan(to_torch_csr(a2), 1, port_config(cfg),
                                                        transpose=transpose))
    with pytest.raises(ValueError, match="pattern"):
        tsolver.refresh_plan(port, tsuite.random_levelled(400, 24, 4.0, seed=9))


def test_plan_from_arrays_round_trip():
    a = strategies.EXACT_MATRICES["banded"]()
    cfg = SolverConfig(block_size=8, sched="dagpart", partition="malleable",
                       kernel_backend="reference")
    for transpose in (False, True):
        ref = build_plan(a, 2, cfg, transpose=transpose)
        port = tsolver.plan_from_arrays(flatten_plan(ref))
        assert_plans_identical(ref, port)
        assert port.config == port_config(cfg)


def test_degenerate_plans_identical():
    for build in (strategies.empty_matrix, strategies.diagonal_matrix,
                  strategies.single_entry_matrix):
        a = build()
        cfg = SolverConfig(block_size=8)
        ref = build_plan(a, 1, cfg)
        port = tsolver.build_plan(to_torch_csr(a), 1, port_config(cfg))
        assert_plans_identical(ref, port)
        assert_dispatch_stats_match(dispatch_stats(ref), ref, tsolver.dispatch_stats(port))
