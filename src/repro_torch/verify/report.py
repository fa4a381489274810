"""Typed findings and the verification report.

Every check of the static plan verifier emits :class:`Finding` records into a
:class:`RuleSink`; :func:`repro_torch.verify.verify_plan` wraps the collected
findings into a :class:`VerificationReport`. Findings are *structured*: a
stable dotted rule id (the catalogue lives in the checker modules' module
docstrings), a severity, and the location — superstep (level) index, device,
and the rows/tiles involved — so tests can assert that a known corruption is
flagged with the exact rule at the exact place, and output stays greppable.
The ids, severities and report layout are the reference package's.

Severity semantics:

* ``error``   — the plan would compute a wrong answer (or crash): a
  happens-before violation, a schedule that drops or duplicates work, a
  kernel-contract breach.
* ``warning`` — the plan is correct but degenerate or wasteful (e.g.
  exchange traffic scheduled over an empty dependency cut). The ``strict``
  verification level promotes warnings to failures.
"""
from __future__ import annotations

import dataclasses

ERROR = "error"
WARNING = "warning"

#: Verification levels, weakest to strongest:
#: ``basic``     — happens-before checks only (schedule correctness),
#: ``contracts`` — basic + the kernel-contract lint,
#: ``strict``    — contracts, with warnings promoted to failures.
LEVELS = ("basic", "contracts", "strict")

# rows/tiles listed per finding are capped (the full count still rides in the
# message) so a pathological plan cannot produce a gigabyte report
MAX_ITEMS = 16


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one location."""

    rule: str  # dotted rule id, e.g. "hb.solve.once"
    severity: str  # ERROR | WARNING
    message: str
    level: int | None = None  # superstep (block level) index, when localized
    device: int | None = None
    rows: tuple = ()  # block rows involved (capped at MAX_ITEMS)
    tiles: tuple = ()  # (dest_row, src_col) tile pairs involved (capped)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["rows"] = list(self.rows)
        d["tiles"] = [list(t) for t in self.tiles]
        return d

    def __str__(self) -> str:
        loc = []
        if self.level is not None:
            loc.append(f"level={self.level}")
        if self.device is not None:
            loc.append(f"device={self.device}")
        if self.rows:
            loc.append(f"rows={list(self.rows)}")
        if self.tiles:
            loc.append(f"tiles={[tuple(t) for t in self.tiles]}")
        where = f" [{', '.join(loc)}]" if loc else ""
        return f"{self.severity.upper()} {self.rule}: {self.message}{where}"


class RuleSink:
    """Collector the checkers emit into: records findings and the full set of
    rule ids that *ran* (so a report can show coverage, not just failures)."""

    def __init__(self) -> None:
        self.findings: list[Finding] = []
        self.rules_checked: list[str] = []

    def check(self, rule: str) -> str:
        """Register that ``rule`` ran (idempotent); returns the id."""
        if rule not in self.rules_checked:
            self.rules_checked.append(rule)
        return rule

    def fail(self, rule: str, message: str, *, severity: str = ERROR,
             level: int | None = None, device: int | None = None,
             rows=(), tiles=()) -> Finding:
        self.check(rule)
        f = Finding(
            rule=rule, severity=severity, message=message, level=level,
            device=device, rows=tuple(int(r) for r in tuple(rows)[:MAX_ITEMS]),
            tiles=tuple((int(a), int(b)) for a, b in tuple(tiles)[:MAX_ITEMS]),
        )
        self.findings.append(f)
        return f


@dataclasses.dataclass(frozen=True)
class VerificationReport:
    """The outcome of one :func:`repro_torch.verify.verify_plan` run."""

    level: str  # requested verification level (one of LEVELS)
    plan: dict  # static summary of the verified plan (mode, sizes)
    findings: tuple  # tuple[Finding, ...] in emission order
    rules_checked: tuple  # tuple[str, ...] every rule that ran

    @property
    def errors(self) -> tuple:
        return tuple(f for f in self.findings if f.severity == ERROR)

    @property
    def warnings(self) -> tuple:
        return tuple(f for f in self.findings if f.severity == WARNING)

    @property
    def passed(self) -> bool:
        """No errors; at ``strict`` level, no warnings either."""
        if self.level == "strict":
            return not self.findings
        return not self.errors

    def by_rule(self, rule: str) -> tuple:
        return tuple(f for f in self.findings if f.rule == rule)

    def summary(self) -> str:
        verdict = "PASS" if self.passed else "FAIL"
        return (f"verify[{self.level}] {verdict}: "
                f"{len(self.rules_checked)} rules, "
                f"{len(self.errors)} errors, {len(self.warnings)} warnings")

    def to_dict(self) -> dict:
        return {
            "level": self.level,
            "passed": self.passed,
            "plan": dict(self.plan),
            "rules_checked": list(self.rules_checked),
            "findings": [f.to_dict() for f in self.findings],
        }

    def raise_if_failed(self) -> "VerificationReport":
        if not self.passed:
            raise PlanVerificationError(self)
        return self


class PlanVerificationError(ValueError):
    """A plan failed static verification; carries the full report."""

    def __init__(self, report: VerificationReport):
        self.report = report
        lines = [report.summary()] + [f"  {f}" for f in report.findings]
        super().__init__("\n".join(lines))
