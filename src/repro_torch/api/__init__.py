"""Session front door: analyse / factorize / solve with plan caching."""
from repro_torch.api.context import SpTRSVContext, SpTRSVHandle, pattern_key
from repro_torch.api.options import (
    Comm,
    KernelBackend,
    PartitionStrategy,
    PlanOptions,
    Sched,
    as_options,
)
