"""Session front door: analyse / factorize / solve with plan caching and
auto-tuned backend selection."""
from repro_torch.api.autotune import AutoDecision, estimate_plan_cost
from repro_torch.api.context import SpTRSVContext, SpTRSVHandle, pattern_key
from repro_torch.api.options import (
    AUTO,
    Comm,
    KernelBackend,
    PartitionStrategy,
    PlanOptions,
    Sched,
    as_options,
)
