"""Stable diagnostic codes — counterpart of ``repro/lint/diagnostics.py``
for the codes the port emits, with the reference's wording, its
severities, its per-code registry and its counting through the flight
recorder."""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence

from repro_torch import obs


class Severity(enum.Enum):
    """How fatal a diagnostic is: ERROR fails the pre-flight, WARNING is
    reported and counted, INFO is context."""

    ERROR = "error"
    WARNING = "warning"
    INFO = "info"


@dataclasses.dataclass(frozen=True)
class CodeInfo:
    """Per-code registry entry: the one-line contract, the default
    severity of a finding of this code, and the canonical fix hint
    (``python -m repro_torch.lint codes`` prints all three)."""

    summary: str
    severity: Severity
    hint: str = ""


def _info(summary: str, severity: str = "error", hint: str = "") -> CodeInfo:
    return CodeInfo(summary=summary, severity=Severity(severity), hint=hint)


#: The registry of the codes the port emits: RP1xx plan/program legality
#: (``lint/verify.py`` and the front door), RP2xx the audit of a run's
#: launches (``lint/artifact.py``), RP3xx the codebase rules
#: (``lint/rules.py``), RP4xx the dataflow of the padded ring schedule
#: (``lint/dataflow.py``, ``lint/sanitize.py``).  The summaries are the
#: reference's, except RP105, whose budget on the card is shared memory
#: per CTA, and RP200, the port's own (an audit that saw no launch); the
#: hints say what each rule checks on the card (RP2xx reads a run's
#: buffers, not HLO text; RP302-RP304 read torch, not JAX and Pallas).
CODE_INFO = {
    "RP101": _info("grid shape does not describe the program's spatial rank",
                   hint="give one positive extent per program axis"),
    "RP102": _info("step count must be an integer >= 1",
                   hint="run at least one time step"),
    "RP103": _info("batch must be None or an integer >= 1 (and match at run)",
                   hint="stack independent grids along one leading axis"),
    "RP104": _info("eq. 2 violation: par_time shrinks csize to <= 0 on some "
                   "axis",
                   hint="give every axis a positive block extent, or cut "
                        "par_time"),
    "RP105": _info("kernel shared memory of one CTA exceeds the card's "
                   "per-block limit",
                   hint="shrink par_time or use variant='plain'"),
    "RP106": _info("eq. 6 advisory: streamed window is not lane/sublane "
                   "aligned", "warning",
                   hint="on the card: pick par_time so that the carry row "
                        "pitch is a multiple of 16 bytes (par_time*radius "
                        "even in float32, a multiple of 4 in 16 bits), "
                        "which keeps the 16-byte row copies"),
    "RP107": _info("decomposition infeasible: shard/divisibility/halo bound "
                   "broken",
                   hint="devices=<count> or plan='auto' searches blocking "
                        "and split together"),
    "RP108": _info("wrap-degenerate periodic axis routes through the re-pad "
                   "fallback", "warning",
                   hint="grow the axis, shrink par_time, or pick a dividing "
                        "block"),
    "RP109": _info("program dtype outside the kernels' supported set",
                   hint="use float32, bfloat16 or float16"),
    "RP110": _info("device placement invalid for this backend/host",
                   hint="run on one visible CUDA device, or pass "
                        "device='cpu'"),
    "RP111": _info("plan block rank does not match the program rank",
                   hint="give one output-tile extent per grid axis"),
    "RP112": _info("plan selector must be \"auto\", \"model\", or a "
                   "BlockPlan",
                   hint="use plan='auto' unless pinning a tuned BlockPlan"),
    "RP113": _info("overlap-tax advisory: useful fraction at or below the "
                   "planner floor", "warning",
                   hint="cut par_time: the CTA tile the card runs, not the "
                        "block, sets the overlap"),
    "RP114": _info("conflicting kernel-variant requests: both pipelined= "
                   "and variant= given",
                   hint="pass only variant="),
    # -- RP2xx: the audit of a run's launches (lint/artifact.py) -------------
    "RP200": _info("launch audit recorded no kernel launch (it would pass "
                   "vacuously)",
                   hint="audit a region that launches the kernels: a "
                        "renamed or bypassed launch path must fail loudly"),
    "RP201": _info("input_output_alias pair is shape/dtype-inconsistent",
                   hint="a launch's src and dst: one shape, dtype and "
                        "device (a pre-padded result: the source less its "
                        "halo), disjoint memory"),
    "RP202": _info("unintended f64 promotion in the lowered module",
                   hint="a float64 tensor among a launch's or the result: "
                        "cast taps/constants to the program dtype"),
    "RP203": _info("recompile hazard: trace-count delta exceeds the "
                   "O(1)-compile budget",
                   hint="a warm run must build, load, miss no geometry "
                        "cache and plan nothing: compile once and run"),
    "RP204": _info("donation hazard: one input buffer aliased by multiple "
                   "outputs",
                   hint="one buffer in two roles (a launch's src and dst, "
                        "the caller's grid and the result): copy in"),
    # -- RP3xx: the codebase rules (lint/rules.py) ---------------------------
    "RP300": _info("file cannot be parsed (syntax error)",
                   hint="fix the syntax error (or the lint invocation)"),
    "RP301": _info("legacy stencil entry point outside the shims "
                   "(missing # legacy-ok)",
                   hint="migrate to repro_torch.stencil(...).compile(...)"),
    "RP302": _info("wall-clock timing of .run(...) without "
                   "block_until_ready",
                   hint="on the card: torch.cuda.synchronize() (or an "
                        "event's .synchronize()) before the second clock "
                        "read, or CUDA events"),
    "RP303": _info("direct pl.pallas_call outside src/repro/kernels/",
                   hint="on the card: a library load or C launcher call "
                        "outside src/repro_torch/kernels/; launch through "
                        "kernels/cuda.py"),
    "RP304": _info("Python if/while on a tracer-valued expression in a "
                   "kernel body",
                   hint="on the card: a device sync in the launch path (a "
                        "branch on a tensor's value, .item(), .tolist(), "
                        "bool(tensor)); keep values on the device"),
    "RP305": _info("deprecated pipelined= keyword at a first-party call "
                   "site (use variant=)",
                   hint="replace with variant='pipelined'"),
    "RP401": _info("stale-halo read: a superstep window reaches a cell no "
                   "pad, write, wrap DMA, or boundary_fixup initialized",
                   hint="refresh the ring to the superstep's halo "
                        "(par_time * halo_radius, chunk-deep for temporal) "
                        "and read the windows at ring offset H - h"),
    "RP402": _info("coverage hole: interior cells never written during a "
                   "superstep",
                   hint="output tiles must tile the rounded interior "
                        "exactly (write stride == write tile == block)"),
    "RP403": _info("overlapping (or out-of-interior) writes within one "
                   "superstep",
                   hint="output tiles never overlap; each interior cell is "
                        "written exactly once per superstep"),
    "RP404": _info("ping-pong aliasing lets a superstep read a cell it "
                   "already overwrote",
                   hint="the superstep writes the other buffer of the "
                        "ping-pong pair, never the one its windows read"),
    "RP405": _info("periodic wrap DMA missing or issued after a dependent "
                   "read",
                   hint="refresh the wrap ring (B2, wrap_halo.cu) on the "
                        "same stream before the superstep that reads it"),
}

#: code -> one-line contract (the reference's ``CODES``).
CODES = {code: info.summary for code, info in CODE_INFO.items()}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: a stable code, a message, a fix hint and a severity;
    ``path``/``line`` (1-based) locate a codebase finding."""

    code: str
    message: str
    hint: str = ""
    severity: Severity = Severity.ERROR
    path: Optional[str] = None
    line: Optional[int] = None

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(f"unknown diagnostic code {self.code!r}")

    @property
    def is_error(self) -> bool:
        return self.severity is Severity.ERROR

    def describe(self) -> str:
        loc = ""
        if self.path is not None:
            loc = f"{self.path}:{self.line}: " if self.line is not None \
                else f"{self.path}: "
        hint = f" (fix: {self.hint})" if self.hint else ""
        return f"{loc}{self.code}: {self.message}{hint}"

    def to_json(self) -> dict:
        """The finding as JSON; ``path`` and ``line`` only where it has a
        location."""
        out = {"code": self.code, "severity": self.severity.value,
               "message": self.message, "hint": self.hint}
        if self.path is not None:
            out.update(path=self.path, line=self.line)
        return out


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


def error(code: str, message: str, hint: str = "", **loc) -> Diagnostic:
    return Diagnostic(code=code, message=message, hint=hint,
                      severity=Severity.ERROR, **loc)


def warning(code: str, message: str, hint: str = "", **loc) -> Diagnostic:
    return Diagnostic(code=code, message=message, hint=hint,
                      severity=Severity.WARNING, **loc)
