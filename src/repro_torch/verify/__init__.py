"""Static plan verifier: happens-before race detection over compacted
schedules and a lint of the port's kernel contracts, with no device
execution.

Front door::

    from repro_torch.verify import verify_plan
    report = verify_plan(plan, level="strict")
    report.raise_if_failed()

Levels: ``basic`` (happens-before only), ``contracts`` (+ kernel lint,
the default), ``strict`` (contracts, warnings fail too). Opt in at build
time with ``build_plan(..., verify="strict")`` / ``PlanOptions.verify`` /
``REPRO_TORCH_VERIFY=1`` (env; ``1`` means ``strict``), or at the CLI with
``python -m repro_torch.launch.solve --verify``. The port reads its own
variable (the reference reads ``REPRO_VERIFY``), so one process holding
both packages never switches on both.

Every run emits an ``sptrsv.verify`` trace span and ``verify.*`` metrics
(runs, findings by severity, per-run rule/finding gauges) through
:mod:`repro_torch.obs`.
"""
from __future__ import annotations

import os

from repro_torch.verify.report import (LEVELS, Finding, PlanVerificationError,
                                       RuleSink, VerificationReport)

__all__ = [
    "ENV_VERIFY",
    "Finding",
    "LEVELS",
    "PlanVerificationError",
    "RuleSink",
    "VerificationReport",
    "env_verify_level",
    "verify_plan",
]

ENV_VERIFY = "REPRO_TORCH_VERIFY"


def env_verify_level(default: str | None = None) -> str | None:
    """Verification level requested via ``REPRO_TORCH_VERIFY`` (``None`` = off).

    ``"1"`` (and any other truthy shorthand that is not a level name) means
    ``strict``; ``""``/``"0"`` disable; a level name selects that level.
    """
    raw = os.environ.get(ENV_VERIFY)
    if raw is None:
        return default
    raw = raw.strip().lower()
    if raw in ("", "0", "off", "none", "false"):
        return None
    return raw if raw in LEVELS else "strict"


def verify_plan(plan, level: str = "contracts") -> VerificationReport:
    """Statically verify a :class:`repro_torch.core.solver.Plan`.

    Pure host-side analysis: reconstructs the dependency DAG from the block
    structure and checks every per-device compacted schedule (and, at
    ``contracts``/``strict``, the port's megakernel encodings) against it.
    Never touches a device.
    """
    from repro_torch.obs.metrics import get_registry
    from repro_torch.obs.trace import get_tracer
    from repro_torch.verify.contracts import check_contracts
    from repro_torch.verify.happens_before import check_happens_before

    if level not in LEVELS:
        raise ValueError(
            f"invalid verify level: {level!r} (valid: {', '.join(LEVELS)})")
    with get_tracer().span(
        "sptrsv.verify", level=level, sched=plan.config.sched,
        comm=plan.config.comm, n_devices=plan.n_devices,
        n_levels=plan.n_levels, transpose=plan.transpose,
    ) as span:
        sink = RuleSink()
        check_happens_before(plan, sink)
        if level in ("contracts", "strict"):
            check_contracts(plan, sink)
        report = VerificationReport(
            level=level,
            plan={
                "sched": plan.config.sched, "comm": plan.config.comm,
                "partition": plan.config.partition,
                "kernel_backend": plan.config.kernel_backend,
                "n_devices": plan.n_devices, "n_levels": plan.n_levels,
                "nb": plan.bs.nb, "B": plan.bs.B,
                "transpose": plan.transpose,
            },
            findings=tuple(sink.findings),
            rules_checked=tuple(sink.rules_checked),
        )
        span.set(passed=report.passed, n_rules=len(report.rules_checked),
                 n_errors=len(report.errors),
                 n_warnings=len(report.warnings))
        reg = get_registry()
        reg.counter("verify.runs").inc()
        reg.counter("verify.errors").inc(len(report.errors))
        reg.counter("verify.warnings").inc(len(report.warnings))
        if not report.passed:
            reg.counter("verify.failed").inc()
        reg.gauge("verify.last_rules_checked").set(len(report.rules_checked))
        reg.gauge("verify.last_findings").set(len(report.findings))
    return report
