"""Stable diagnostic codes — the subset of ``repro/lint/diagnostics.py``
that the port's front door raises, with the reference's wording."""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

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


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: a stable code, a message and a fix hint."""

    code: str
    message: str
    hint: str = ""

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(f"unknown diagnostic code {self.code!r}")

    def describe(self) -> str:
        hint = f" (fix: {self.hint})" if self.hint else ""
        return f"{self.code}: {self.message}{hint}"


class DiagnosticError(ValueError):
    """A fatal pre-flight rejection carrying its diagnostics; a
    ``ValueError`` whose message leads with the RP code."""

    def __init__(self, diagnostics: Sequence[Diagnostic]):
        self.diagnostics: List[Diagnostic] = list(diagnostics)
        super().__init__("; ".join(d.describe() for d in self.diagnostics))


def error(code: str, message: str, hint: str = "") -> Diagnostic:
    return Diagnostic(code=code, message=message, hint=hint)
