"""Stable diagnostic codes — the subset of ``repro/lint/diagnostics.py``
that the port's front door raises, with the reference's wording, its
severities, and its counting through the flight recorder."""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Sequence

from repro_torch import obs

#: code -> one-line contract, as in the reference's ``CODES``.
CODES = {
    "RP101": "grid shape does not describe the program's spatial rank",
    "RP102": "step count must be an integer >= 1",
    "RP103": "batch must be None or an integer >= 1 (and match at run)",
    "RP105": "kernel shared memory of one CTA exceeds the card's "
             "per-block limit",
    "RP109": "program dtype outside the kernels' supported set",
    "RP110": "device placement invalid for this backend/host",
    "RP111": "plan block rank does not match the program rank",
    "RP112": "plan selector must be \"auto\", \"model\", or a BlockPlan",
}


class Severity(enum.Enum):
    """How fatal a diagnostic is: ERROR fails the pre-flight, WARNING is
    reported and counted, INFO is context."""

    ERROR = "error"
    WARNING = "warning"
    INFO = "info"


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: a stable code, a message, a fix hint and a severity."""

    code: str
    message: str
    hint: str = ""
    severity: Severity = Severity.ERROR

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(f"unknown diagnostic code {self.code!r}")

    @property
    def is_error(self) -> bool:
        return self.severity is Severity.ERROR

    def describe(self) -> str:
        hint = f" (fix: {self.hint})" if self.hint else ""
        return f"{self.code}: {self.message}{hint}"

    def to_json(self) -> dict:
        return {"code": self.code, "severity": self.severity.value,
                "message": self.message, "hint": self.hint}


class DiagnosticError(ValueError):
    """A fatal pre-flight rejection carrying its diagnostics; a
    ``ValueError`` whose message leads with the RP code."""

    def __init__(self, diagnostics: Sequence[Diagnostic]):
        self.diagnostics: List[Diagnostic] = list(diagnostics)
        super().__init__("; ".join(d.describe() for d in self.diagnostics))


def emit(diagnostics: Sequence[Diagnostic], source: str) -> None:
    """Count diagnostics through the flight recorder (no-op when off):
    ``lint.diagnostics`` totals every finding, ``lint.<source>.<severity>``
    and ``lint.code.<code>`` say which checks fire."""
    if not diagnostics:
        return
    rec = obs.active()
    if rec is None:
        return
    rec.count("lint.diagnostics", len(diagnostics))
    for d in diagnostics:
        rec.count(f"lint.{source}.{d.severity.value}")
        rec.count(f"lint.code.{d.code}")


def raise_on_error(diagnostics: Sequence[Diagnostic],
                   source: str = "verify") -> List[Diagnostic]:
    """Emit counters, then raise :class:`DiagnosticError` on any ERROR;
    returns the (possibly warning-only) list otherwise."""
    diags = list(diagnostics)
    emit(diags, source)
    errors = [d for d in diags if d.is_error]
    if errors:
        raise DiagnosticError(errors)
    return diags


def error(code: str, message: str, hint: str = "") -> Diagnostic:
    return Diagnostic(code=code, message=message, hint=hint,
                      severity=Severity.ERROR)


def warning(code: str, message: str, hint: str = "") -> Diagnostic:
    return Diagnostic(code=code, message=message, hint=hint,
                      severity=Severity.WARNING)
