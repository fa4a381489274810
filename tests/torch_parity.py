"""Helpers for the PyTorch port's parity tests (``tests/test_torch_*.py``).

The JAX package is the reference: the same inputs, made with numpy, go
through both packages and the results are compared as numpy arrays — plans
byte for byte, solves bit for bit on the dyadic suites and by tolerance
otherwise.
"""
from __future__ import annotations

import dataclasses

import numpy as np

import repro_torch.core.solver as tsolver
import repro_torch.sparse.matrix as tmatrix

# the port's SolverConfig fields (the reference has more, e.g. calibrate_cost)
PORT_CONFIG_FIELDS = tuple(f.name for f in dataclasses.fields(tsolver.SolverConfig))
PLAN_ARRAYS = ("diag", "owner", "indeg", "ex_rows", "ex_boundary", "lvl_off",
               "lvl_bucket", "solve_rows", "upd_tiles", "local_rows", "tile_row",
               "tile_col", "tiles")
PLAN_SCALARS = ("n_devices", "n_levels", "buckets", "transpose", "frontier_caps")
BS_FIELDS = ("n", "B", "nb", "diag", "off_rows", "off_cols", "off_tiles",
             "block_level", "block_indeg")
PART_FIELDS = ("n_devices", "strategy", "tasks_per_device", "owner", "boundary")


def to_torch_csr(a) -> tmatrix.CSR:
    """The reference's CSR as the port's (copied arrays)."""
    return tmatrix.CSR(n=a.n, row_ptr=a.row_ptr.copy(), col_idx=a.col_idx.copy(),
                       val=a.val.copy())


def port_config(cfg, **overrides) -> tsolver.SolverConfig:
    """The port's SolverConfig with the same values as a reference config."""
    kw = {name: getattr(cfg, name) for name in PORT_CONFIG_FIELDS}
    kw.update(overrides)
    return tsolver.SolverConfig(**kw)


def flatten_plan(plan) -> dict:
    """A reference ``Plan`` as the plain dict ``plan_from_arrays`` takes."""
    out = {name: getattr(plan, name) for name in PLAN_ARRAYS + PLAN_SCALARS}
    out["step_off"] = plan.step_off
    out.update({f"bs.{k}": getattr(plan.bs, k) for k in BS_FIELDS})
    out.update({f"part.{k}": getattr(plan.part, k) for k in PART_FIELDS})
    out.update({f"config.{k}": getattr(plan.config, k) for k in PORT_CONFIG_FIELDS})
    return out


def assert_arrays_identical(a, b, what: str) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} != {b.dtype}"
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    assert np.array_equal(a, b), f"{what}: values differ"


def assert_plans_identical(ref_plan, port_plan) -> None:
    """Every array of the Plan, its BlockStructure and Partition is
    byte-identical (same dtype, shape and values); scalars are equal."""
    for name in PLAN_ARRAYS:
        assert_arrays_identical(getattr(ref_plan, name), getattr(port_plan, name), name)
    for name in PLAN_SCALARS:
        assert getattr(ref_plan, name) == getattr(port_plan, name), name
    if ref_plan.step_off is None:
        assert port_plan.step_off is None
    else:
        assert_arrays_identical(ref_plan.step_off, port_plan.step_off, "step_off")
    for name in BS_FIELDS:
        assert_arrays_identical(getattr(ref_plan.bs, name), getattr(port_plan.bs, name),
                                f"bs.{name}")
    for name in PART_FIELDS:
        assert_arrays_identical(getattr(ref_plan.part, name),
                                getattr(port_plan.part, name), f"part.{name}")
