"""Symbolic analysis, partitioning, plans and their executors."""
from repro_torch.core.analysis import in_degrees, level_sets, metrics
from repro_torch.core.blocking import BlockStructure, build_blocks, pad_rhs, unpad_x
from repro_torch.core.partition import (
    Partition,
    cut_stats,
    make_partition,
    merge_levels,
    remote_source_levels,
)
from repro_torch.core.solver import (
    Plan,
    Solver,
    SolverConfig,
    build_plan,
    dispatch_stats,
    fused_segments,
    plan_from_arrays,
    refresh_plan,
    schedule_table_bytes,
    solve_local,
    sptrsv,
    step_offsets,
    step_widths,
)
