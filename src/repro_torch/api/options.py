"""Typed solver options for the session API.

:class:`PlanOptions` is the front-door configuration object: every mode is a
str-enum (invalid values raise ``ValueError`` naming the valid choices at
construction time), raw strings are coerced, and a :class:`SolverConfig`
converts losslessly in both directions.

Auto-tuning (``"auto"`` for ``sched``/``comm``/``kernel``) is not ported
yet: asking for it raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import enum

from repro_torch.core.partition import STRATEGIES
from repro_torch.core.solver import COMM_MODES, SCHED_MODES, SolverConfig
from repro_torch.kernels.ops import BACKENDS

AUTO = "auto"


def _mode_enum(name: str, values: tuple) -> type:
    """str-Enum over the engine's mode tuple, so the two cannot drift."""
    return enum.Enum(name, {v.upper(): v for v in values}, type=str)


Sched = _mode_enum("Sched", SCHED_MODES)
Comm = _mode_enum("Comm", COMM_MODES)
PartitionStrategy = _mode_enum("PartitionStrategy", STRATEGIES)
# "default" = "cuda" on a CUDA device, "reference" on the CPU
KernelBackend = _mode_enum("KernelBackend", ("default",) + BACKENDS)


def _coerce(enum_cls, value, field: str):
    """Coerce a raw string (or enum) into ``enum_cls`` with an eager,
    choice-naming error."""
    if value is None and enum_cls is KernelBackend:
        return KernelBackend.DEFAULT
    raw = value.value if isinstance(value, enum.Enum) else str(value)
    if raw == AUTO and enum_cls is not PartitionStrategy:
        raise NotImplementedError(
            f"{field}='auto': auto-tuning is not ported to the PyTorch/CUDA "
            "package yet (see ROADMAP.md, Queue 1)")
    try:
        return enum_cls(raw)
    except ValueError:
        valid = [m.value for m in enum_cls]
        raise ValueError(
            f"invalid {field}: {value!r} (valid choices: {', '.join(valid)})"
        ) from None


@dataclasses.dataclass(frozen=True)
class PlanOptions:
    """Typed, validated options for one analyse/factorize/solve session."""

    block_size: int = 32
    sched: Sched = Sched.LEVELSET
    comm: Comm = Comm.ZEROCOPY
    partition: PartitionStrategy = PartitionStrategy.TASKPOOL
    kernel: KernelBackend = KernelBackend.DEFAULT
    tasks_per_device: int = 8
    gemv_group: int = 0
    rhs_hint: int = 1  # expected RHS panel width, feeds the partition cost model
    # dagpart merge heuristic knobs (see core.partition.merge_levels):
    merge_width: int = 64  # per-device row budget of one merged superstep
    merge_cost: float = 0.0  # narrow-level cost cap; 0 = analytic threshold

    def __post_init__(self):
        for name, cls in (("sched", Sched), ("comm", Comm),
                          ("partition", PartitionStrategy), ("kernel", KernelBackend)):
            object.__setattr__(self, name, _coerce(cls, getattr(self, name), name))
        for name, lo in (("block_size", 1), ("tasks_per_device", 1),
                         ("rhs_hint", 1), ("gemv_group", 0), ("merge_width", 1)):
            if int(getattr(self, name)) < lo:
                raise ValueError(f"{name} must be >= {lo}, got {getattr(self, name)}")
        if float(self.merge_cost) < 0:
            raise ValueError(f"merge_cost must be >= 0, got {self.merge_cost}")

    @classmethod
    def from_config(cls, config: SolverConfig) -> "PlanOptions":
        return cls(
            block_size=config.block_size, sched=config.sched, comm=config.comm,
            partition=config.partition, kernel=config.kernel_backend,
            tasks_per_device=config.tasks_per_device, gemv_group=config.gemv_group,
            rhs_hint=config.rhs_hint, merge_width=config.merge_width,
            merge_cost=config.merge_cost,
        )

    def to_config(self) -> SolverConfig:
        """The engine config these options describe."""
        kernel = self.kernel.value
        return SolverConfig(
            block_size=self.block_size, comm=self.comm.value, sched=self.sched.value,
            partition=self.partition.value, tasks_per_device=self.tasks_per_device,
            kernel_backend=None if kernel == KernelBackend.DEFAULT.value else kernel,
            gemv_group=self.gemv_group, rhs_hint=self.rhs_hint,
            merge_width=self.merge_width, merge_cost=self.merge_cost,
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
