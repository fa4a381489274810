"""Typed solver options for the session API.

:class:`PlanOptions` is the front-door configuration object: every mode is a
str-enum (invalid values raise ``ValueError`` naming the valid choices at
construction time), raw strings are coerced, and a :class:`SolverConfig`
converts losslessly in both directions.

``sched``/``comm``/``kernel`` also accept ``"auto"``: the context then scores
the candidate combinations with the calibrated cost model, and with
``probe_solves > 0`` times each on the device
(:mod:`repro_torch.api.autotune`), instead of making the caller guess which
execution mode fits the matrix.
"""
from __future__ import annotations

import dataclasses
import enum

from repro_torch.core.partition import STRATEGIES
from repro_torch.core.solver import COMM_MODES, SCHED_MODES, SolverConfig
from repro_torch.kernels.ops import BACKENDS
from repro_torch.verify.report import LEVELS

AUTO = "auto"


def _mode_enum(name: str, values: tuple) -> type:
    """str-Enum over the engine's mode tuple, so the two cannot drift."""
    return enum.Enum(name, {v.upper(): v for v in values}, type=str)


Sched = _mode_enum("Sched", SCHED_MODES + (AUTO,))
Comm = _mode_enum("Comm", COMM_MODES + (AUTO,))
PartitionStrategy = _mode_enum("PartitionStrategy", STRATEGIES)
# "default" = "cuda" on a CUDA device, "reference" on the CPU
KernelBackend = _mode_enum("KernelBackend", ("default",) + BACKENDS + (AUTO,))


def _coerce(enum_cls, value, field: str, *, allow_auto: bool = False):
    """Coerce a raw string (or enum) into ``enum_cls`` with an eager,
    choice-naming error."""
    if value is None and enum_cls is KernelBackend:
        return KernelBackend.DEFAULT
    try:
        member = enum_cls(value.value if isinstance(value, enum.Enum) else str(value))
    except ValueError:
        member = None
    if member is None or (member.value == AUTO and not allow_auto):
        valid = [m.value for m in enum_cls if allow_auto or m.value != AUTO]
        raise ValueError(
            f"invalid {field}: {value!r} (valid choices: {', '.join(valid)})"
        )
    return member


@dataclasses.dataclass(frozen=True)
class PlanOptions:
    """Typed, validated options for one analyse/factorize/solve session.

    ``sched``/``comm``/``kernel`` accept ``"auto"``; the partition strategy
    stays explicit because the partition *is* the analysis (auto candidates
    share one partition, so auto-tuning never re-analyses).
    """

    block_size: int = 32
    sched: Sched = Sched.LEVELSET
    comm: Comm = Comm.ZEROCOPY
    partition: PartitionStrategy = PartitionStrategy.TASKPOOL
    kernel: KernelBackend = KernelBackend.DEFAULT
    tasks_per_device: int = 8
    gemv_group: int = 0
    rhs_hint: int = 1  # expected RHS panel width, feeds the cost model and probes
    # dagpart merge heuristic knobs (see core.partition.merge_levels):
    merge_width: int = 64  # per-device row budget of one merged superstep
    merge_cost: float = 0.0  # narrow-level cost cap; 0 = analytic threshold
    calibrate_cost: bool = False  # price placement with costmodel.calibrate_weights
    probe_solves: int = 0  # >0: time each auto candidate this many times
    # static plan verification level ("basic"/"contracts"/"strict") applied to
    # every plan this session builds; None defers to REPRO_TORCH_VERIFY
    verify: str | None = None

    def __post_init__(self):
        for name, cls in (("sched", Sched), ("comm", Comm), ("kernel", KernelBackend)):
            object.__setattr__(self, name, _coerce(cls, getattr(self, name), name,
                                                   allow_auto=True))
        object.__setattr__(self, "partition",
                           _coerce(PartitionStrategy, self.partition, "partition"))
        for name, lo in (("block_size", 1), ("tasks_per_device", 1), ("rhs_hint", 1),
                         ("probe_solves", 0), ("gemv_group", 0), ("merge_width", 1)):
            if int(getattr(self, name)) < lo:
                raise ValueError(f"{name} must be >= {lo}, got {getattr(self, name)}")
        if float(self.merge_cost) < 0:
            raise ValueError(f"merge_cost must be >= 0, got {self.merge_cost}")
        if self.verify is not None and self.verify not in LEVELS:
            raise ValueError(
                f"invalid verify: {self.verify!r} (valid choices: {', '.join(LEVELS)})"
            )

    @property
    def is_auto(self) -> bool:
        return Sched.AUTO == self.sched or Comm.AUTO == self.comm \
            or KernelBackend.AUTO == self.kernel

    @classmethod
    def auto(cls, **overrides) -> "PlanOptions":
        """All three execution dimensions auto-tuned; probes on by default."""
        overrides.setdefault("sched", Sched.AUTO)
        overrides.setdefault("comm", Comm.AUTO)
        overrides.setdefault("kernel", KernelBackend.AUTO)
        overrides.setdefault("probe_solves", 2)
        return cls(**overrides)

    @classmethod
    def from_config(cls, config: SolverConfig) -> "PlanOptions":
        return cls(
            block_size=config.block_size, sched=config.sched, comm=config.comm,
            partition=config.partition, kernel=config.kernel_backend,
            tasks_per_device=config.tasks_per_device, gemv_group=config.gemv_group,
            rhs_hint=config.rhs_hint, merge_width=config.merge_width,
            merge_cost=config.merge_cost, calibrate_cost=config.calibrate_cost,
        )

    def to_config(self, *, sched: str | None = None, comm: str | None = None,
                  kernel: str | None = None) -> SolverConfig:
        """The engine config these options describe; auto dimensions must be
        supplied by the tuner through the keyword overrides."""
        sched = sched or self.sched.value
        comm = comm or self.comm.value
        kernel = kernel if kernel is not None else self.kernel.value
        if AUTO in (sched, comm, kernel):
            raise ValueError("auto options must be resolved before planning "
                             f"(sched={sched!r}, comm={comm!r}, kernel={kernel!r})")
        return SolverConfig(
            block_size=self.block_size, comm=comm, sched=sched,
            partition=self.partition.value, tasks_per_device=self.tasks_per_device,
            kernel_backend=None if kernel == KernelBackend.DEFAULT.value else kernel,
            gemv_group=self.gemv_group, rhs_hint=self.rhs_hint,
            merge_width=self.merge_width, merge_cost=self.merge_cost,
            calibrate_cost=self.calibrate_cost,
        )


def as_options(options) -> PlanOptions:
    """Accept :class:`PlanOptions`, a :class:`SolverConfig`, or None."""
    if options is None:
        return PlanOptions()
    if isinstance(options, PlanOptions):
        return options
    if isinstance(options, SolverConfig):
        return PlanOptions.from_config(options)
    raise TypeError(f"expected PlanOptions or SolverConfig, got {type(options)!r}")
