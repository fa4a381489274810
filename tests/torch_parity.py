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

# the port's SolverConfig fields (the reference has more, e.g. verify)
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


# dispatch_stats keys that follow the port's rule for the fused executor's
# on-chip plan (core/solver.py) instead of the reference's TPU VMEM budget:
# "streamed" is true for kernel_backend="fused_streamed", and for "fused"
# when the resident store (diag + tiles bytes) exceeds the port's stream
# limit (measured on the card; 0 unless REPRO_TORCH_STREAM_LIMIT or paired
# calibration samples set it) and one tile fits the streamed kernel;
# "fused_vmem_bytes" is the megakernel's dynamic shared memory per CTA and
# "stream_dma_bytes" the bytes the streamed kernel copies per vector solve
HOPPER_FUSED_KEYS = ("streamed", "fused_vmem_bytes", "stream_dma_bytes")
SHARED_LIMIT = 232_448  # bytes of dynamic shared memory one Hopper block may use

# Other deliberate differences of the port, pinned by the tests that name them:
# - environment variables: REPRO_TORCH_TRACE, REPRO_TORCH_CALIBRATION and
#   REPRO_TORCH_STREAM_LIMIT (the reference reads REPRO_TRACE,
#   REPRO_CALIBRATION and REPRO_STREAM_VMEM_LIMIT), so one process holding
#   both packages never switches on both (test_torch_obs.py);
# - calibration store keys and probe signatures carry the device type
#   ("cuda:fused/B32", "cpu:levelset/..."): CPU samples time the plain
#   versions and never mix with the card's (test_torch_obs.py,
#   test_torch_autotune.py);
# - "fused" streams by the port's measured rule above, where the reference's
#   streams above 8 MiB of VMEM;
# - the auto-tuner's INTERPRET_PENALTY applies where the port runs a
#   megakernel's plain version (fused levelset/dagpart on the CPU), where the
#   reference applies it in Pallas interpret mode (test_torch_autotune.py);
# - the verifier's switch is REPRO_TORCH_VERIFY (the reference reads
#   REPRO_VERIFY) (test_torch_verify.py);
# - the verifier's kc.stream.slices, kc.stream.bytes, kc.scratch.shape and
#   kc.carry.donation check the port's Hopper contracts (the streamed
#   layout's work items, the bytes the streamed kernel copies per column,
#   the shared memory a launch requests, the wrappers' fresh outputs) where
#   the reference's check its TPU kernel's level-slice DMA bursts, VMEM
#   scratch and input_output_aliases; they keep the reference's ids and fire
#   on the same mutations of the plan (test_torch_verify.py);
# - the verifier has one rule the reference lacks, kc.pull.wait (the
#   resident kernel's pull table waits exactly on rows the launch solves),
#   run after the streaming rules: PORT_ONLY_RULES (test_torch_verify.py);
# - SpTRSVContext, SolveEngine and the CLIs take device= (the card unless
#   "cpu"), where the reference's take mesh=; the engine launches on one CUDA
#   stream of its own choosing (test_torch_service.py, test_torch_cuda.py).
PORT_ONLY_RULES = ("kc.pull.wait",)


def hopper_fused_stats(ref_plan) -> dict:
    """The three keys by the port's rule, derived here from the reference's
    plan (not through the port's layout builder).

    Streamed, each device's work items are its solved rows (incoming tiles
    stored on the device, then the diagonal tile) and the rows it updates
    but does not solve (incoming tiles only). Store entries are tiles with
    rows padded to B + 1 floats, then to a multiple of four; each warp
    double-buffers its widest item when 8, 4, 2 or 1 warps of them fit the
    shared memory, besides two mbarriers and three B-float columns.
    """
    B = ref_plan.bs.B
    entry = 4 * (-(-B * (B + 1) // 4) * 4)

    def size(warps, cap):
        return warps * (16 + 2 * cap * entry + 12 * B)

    kernel = ref_plan.config.kernel_backend
    streamed = ref_plan.config.sched in ("levelset", "dagpart") and (
        kernel == "fused_streamed"
        or (kernel == "fused" and size(1, 1) <= SHARED_LIMIT
            and ref_plan.diag.nbytes + ref_plan.tiles.nbytes > tsolver.stream_limit()))
    if not streamed:
        # 8 warps, each with a ring of three 1056-float prefetch stages and
        # three B-float columns (the row's sum and two source columns)
        return {"streamed": False, "stream_dma_bytes": 0,
                "fused_vmem_bytes": 4 * 8 * (3 * 33 * 32 + 3 * B)}
    nb = ref_plan.bs.nb
    widest, copied = 0, 0
    for d in range(ref_plan.n_devices):
        solved = ref_plan.solve_rows[d][ref_plan.solve_rows[d] >= 0]
        dest = ref_plan.tile_row[d][ref_plan.tile_row[d] != nb]
        items = np.bincount(dest, minlength=nb + 1)
        items[solved] += 1
        widest = max(widest, int(items.max()))
        copied = max(copied, int(items.sum()))

    need = max(1, widest)
    fits = [w for w in (8, 4, 2, 1) if size(w, need) <= SHARED_LIMIT]
    vmem = (size(fits[0], need) if fits
            else size(1, max(1, min(need, (SHARED_LIMIT - size(1, 0)) // (2 * entry)))))
    return {"streamed": True, "fused_vmem_bytes": vmem,
            "stream_dma_bytes": copied * entry if ref_plan.n_levels else 0}


def assert_dispatch_stats_match(ref_stats: dict, ref_plan, port_stats: dict) -> None:
    """Every key equals the reference's but the three of
    :data:`HOPPER_FUSED_KEYS`, which equal :func:`hopper_fused_stats`."""
    assert set(port_stats) == set(ref_stats)
    for key, want in ref_stats.items():
        if key not in HOPPER_FUSED_KEYS:
            assert port_stats[key] == want, key
    assert {k: port_stats[k] for k in HOPPER_FUSED_KEYS} == hopper_fused_stats(ref_plan)
