"""repro_torch.lint — the pre-flight checks of the port, with the card's
rules (counterpart of ``repro.lint``).

``RP1xx`` — plan/program legality (:func:`verify`, :func:`check`): the
    reference's checks in its order, with the card's analogues of RP105
    (shared memory per CTA), RP106 (the row pitch the 16-byte row copies
    need) and RP113 (the useful share of the CTA tile).  The front door
    runs :func:`check` after planning.

``RP4xx`` — the dataflow of the padded ring schedule: the proof
    (:func:`verify_dataflow`, always run by the front door) and the NaN
    canary (:func:`sanitize_run`, ``compile(sanitize=True)``), which runs
    the real kernels on the card.

CLI::

    python -m repro_torch.lint dataflow --ndim 2 ...           # the proof
    python -m repro_torch.lint sanitize --ndim 2 ...           # the canary
    python -m repro_torch.lint sanitize --device cpu ...       # on the CPU
    python -m repro_torch.lint codes                           # the codes

The codebase rules (RP3xx) and the artifact audit (RP2xx) read JAX and
XLA; lint this package with ``python -m repro.lint src tests``
(ROADMAP A10).
"""

from __future__ import annotations

from repro_torch.lint.diagnostics import (CODE_INFO, CODES, Diagnostic,
                                          DiagnosticError, Severity, emit,
                                          raise_on_error)
from repro_torch.lint.verify import check, verify
from repro_torch.lint.dataflow import check_dataflow, verify_dataflow
from repro_torch.lint.sanitize import SanitizeReport, sanitize_run

__all__ = [
    "CODE_INFO",
    "CODES",
    "Diagnostic",
    "DiagnosticError",
    "SanitizeReport",
    "Severity",
    "check",
    "check_dataflow",
    "emit",
    "raise_on_error",
    "sanitize_run",
    "verify",
    "verify_dataflow",
]
