"""Findings, reports and severity for the plan auditor (a copy of the JAX
package's ``lint/report.py``).

A *finding* is one violated invariant: which pass saw it, how bad it is,
what the evidence was. A *report* collects findings for one audited plan
plus the list of passes that actually ran — "no findings" only means
something when you know which checks were applied.

Severity model (two levels):

* ``error``   — correctness hazard: the plan metadata can produce wrong
  results or alias a wrong bucket.
* ``warning`` — performance / operational hazard.

``--lint`` maps onto reports as: ``off`` never runs passes, ``warn``
logs every finding, ``error`` raises :class:`LintError` when a report is
non-empty (warnings included).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

__all__ = ["Finding", "LintReport", "LintError", "LINT_MODES",
           "SEV_ERROR", "SEV_WARNING"]

LINT_MODES = ("off", "warn", "error")
SEV_ERROR = "error"
SEV_WARNING = "warning"


@dataclass(frozen=True)
class Finding:
    """One violated invariant."""

    pass_name: str      # registry name of the pass that found it
    severity: str       # SEV_ERROR | SEV_WARNING
    message: str        # human-readable statement of the violation
    where: str = ""     # locator: bucket key, op name, arg index, ...

    def as_dict(self) -> Dict[str, str]:
        return {"pass": self.pass_name, "severity": self.severity,
                "message": self.message, "where": self.where}

    def __str__(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.severity}: {self.pass_name}: {self.message}{loc}"


class LintError(RuntimeError):
    """Raised in ``--lint error`` mode when an audit finds anything."""

    def __init__(self, report: "LintReport"):
        self.report = report
        lines = [str(f) for f in report.findings]
        super().__init__(
            f"lint failed with {len(report.findings)} finding(s):\n  "
            + "\n  ".join(lines))


@dataclass
class LintReport:
    """Findings + provenance for one audited subject."""

    subject: str = ""                       # e.g. repr(bucket_key)
    findings: List[Finding] = field(default_factory=list)
    passes_run: List[str] = field(default_factory=list)

    def add(self, pass_name: str, severity: str, message: str,
            where: str = "") -> None:
        self.findings.append(Finding(pass_name, severity, message, where))

    def ran(self, pass_name: str) -> None:
        if pass_name not in self.passes_run:
            self.passes_run.append(pass_name)

    def extend(self, other: "LintReport") -> None:
        self.findings.extend(other.findings)
        for name in other.passes_run:
            self.ran(name)

    # ------------------------------------------------------------------
    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == SEV_ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == SEV_WARNING]

    @property
    def ok(self) -> bool:
        return not self.findings

    def by_pass(self, pass_name: str) -> List[Finding]:
        return [f for f in self.findings if f.pass_name == pass_name]

    # ------------------------------------------------------------------
    def as_dict(self) -> Dict[str, Any]:
        return {"subject": self.subject,
                "passes_run": list(self.passes_run),
                "n_findings": len(self.findings),
                "n_errors": len(self.errors),
                "findings": [f.as_dict() for f in self.findings]}

    def summary(self) -> str:
        if self.ok:
            return (f"clean ({len(self.passes_run)} passes)"
                    + (f" {self.subject}" if self.subject else ""))
        return (f"{len(self.findings)} finding(s) "
                f"({len(self.errors)} error(s)) in "
                f"{len(self.passes_run)} passes"
                + (f" for {self.subject}" if self.subject else ""))

    def raise_if_findings(self) -> None:
        if self.findings:
            raise LintError(self)
