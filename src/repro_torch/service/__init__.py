"""SpTRSV as a service: a multi-tenant batched solve engine.

Three layers over the session API:

* :mod:`repro_torch.service.planstore` — cross-process persistence of the
  symbolic analysis (block structure, partition, compacted schedules,
  ``step_off``, bucket tables) keyed by pattern sha1 x options signature,
  strict-verified on every load, so short-lived workers skip the analysis;
  the reference package's file format, readable by either package.
* :mod:`repro_torch.service.queue` — multi-tenant request admission:
  same-pattern right-hand sides coalesce into the ``(n, R)`` panels the
  executors run, under a max-wait/max-batch window with per-tenant fairness
  and bounded-queue backpressure.
* :mod:`repro_torch.service.engine` — the serve loop driving one
  :class:`repro_torch.api.SpTRSVContext` on one device and one CUDA stream:
  plan-store-backed analyse, in-place value refresh on hot patterns,
  ``service.*`` metrics and ``service.request`` / ``service.batch`` spans
  through :mod:`repro_torch.obs`.
"""
from repro_torch.service.engine import SolveEngine
from repro_torch.service.planstore import PlanStore, options_signature
from repro_torch.service.queue import QueueFull, SolveQueue, SolveRequest, Ticket

__all__ = [
    "PlanStore",
    "QueueFull",
    "SolveEngine",
    "SolveQueue",
    "SolveRequest",
    "Ticket",
    "options_signature",
]
