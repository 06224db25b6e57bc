"""repro_torch.lint — the pre-flight checks of the port, with the card's
rules (counterpart of ``repro.lint``).

``RP1xx`` — plan/program legality (:func:`verify`, :func:`check`): the
    reference's checks in its order, with the card's analogues of RP105
    (shared memory per CTA), RP106 (the row pitch the 16-byte row copies
    need) and RP113 (the useful share of the CTA tile).  The front door
    runs :func:`check` after planning.

``RP2xx`` — the launch audit (:func:`analyze_launches`, :func:`audit_run`):
    the reference's HLO audit carried over to a run's real buffers, read
    by ``data_ptr`` at each launch (pairs whose shapes, dtypes or devices
    differ or whose memory overlaps, one buffer in two roles, float64),
    and :func:`check_trace_budget` over ``kernels/common.trace_delta``
    (builds, loads, geometry misses and plan resolutions a warm run must
    not redo).

``RP3xx`` — the codebase rules (:func:`lint_paths`, AST-based): legacy
    entry points in the user-facing trees, wall-clock timing of runs with
    no device synchronisation, library loads and C launcher calls outside
    ``kernels/``, device syncs in the launch path, ``pipelined=`` call
    sites.

``RP4xx`` — the dataflow of the padded ring schedule: the proof
    (:func:`verify_dataflow`, always run by the front door) and the NaN
    canary (:func:`sanitize_run`, ``compile(sanitize=True)``), which runs
    the real kernels on the card.

CLI::

    python -m repro_torch.lint src/repro_torch tests          # the rules
    python -m repro_torch.lint audit --ndim 2 ...              # the audit
    python -m repro_torch.lint dataflow --ndim 2 ...           # the proof
    python -m repro_torch.lint sanitize --ndim 2 ...           # the canary
    python -m repro_torch.lint sanitize --device cpu ...       # on the CPU
    python -m repro_torch.lint codes                           # the codes
"""

from __future__ import annotations

from repro_torch.lint.diagnostics import (CODE_INFO, CODES, Diagnostic,
                                          DiagnosticError, Severity, emit,
                                          raise_on_error)
from repro_torch.lint.verify import check, verify
from repro_torch.lint.dataflow import check_dataflow, verify_dataflow
from repro_torch.lint.sanitize import SanitizeReport, sanitize_run
from repro_torch.lint.artifact import (analyze_launches, audit_run,
                                       check_trace_budget, record_launches)
from repro_torch.lint.engine import lint_paths

__all__ = [
    "CODE_INFO",
    "CODES",
    "Diagnostic",
    "DiagnosticError",
    "SanitizeReport",
    "Severity",
    "analyze_launches",
    "audit_run",
    "check",
    "check_dataflow",
    "check_trace_budget",
    "emit",
    "lint_paths",
    "raise_on_error",
    "record_launches",
    "sanitize_run",
    "verify",
    "verify_dataflow",
]
