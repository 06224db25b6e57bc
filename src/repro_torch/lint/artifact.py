"""The launch audit: RP2xx hazards in a run's real buffers — counterpart
of ``repro/lint/artifact.py``.

The reference audits the HLO text of a compiled executable: every
``input_output_aliases`` pair must pair a parameter and an output of one
shape and dtype, no input may be donated twice, and no value may be
promoted to f64.  The port has no HLO; its kernels take raw pointers
(``kernels/cuda.py``), so the same hazards live in the tensors behind
those pointers.  :func:`record_launches` turns on a recording in
``kernels/cuda.Kernel.__call__`` (one check per launch when off) and in
the plain versions' dispatch (``kernels/common.py``), which keeps, for
each launch, the byte range, storage, shape, dtype and device of its
source, destination and operands; :func:`analyze_launches` audits them:

RP200 (error)   — the audit recorded no launch: a bypassed or renamed
                  launch path must not pass vacuously (the port's own
                  code, as RP300 is for a missing tree).
RP201 (error)   — a launch whose ``dst`` and ``src`` differ in dtype or
                  device or in shape (the padded carry's ping-pong pair
                  is one shape; a pre-padded superstep's result is the
                  source less the same even halo on every spatial axis),
                  or whose ranges overlap without being one buffer.
RP204 (error)   — one buffer in two roles: a launch's ``dst`` that is its
                  ``src`` (the wrap refresh, ``dst`` None, is in place by
                  design), a launch that writes the caller's grid, or a
                  result that shares storage with the caller's grid, which
                  the reference's copy-before-donate contract forbids
                  (``repro/kernels/ops.py:130-134``).
RP202           — float64 among the launches' tensors or the result: an
                  error under a non-float64 ``expect_dtype``, a warning
                  with no expectation.

:func:`check_trace_budget` turns a ``kernels/common.trace_delta`` into
RP203 when a region redid what a warm run must not: build or load a
library, miss a launch-geometry cache, or resolve a plan.

CLI: ``python -m repro_torch.lint audit --ndim 2 ... [--device cpu]``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections.abc import Mapping
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import cuda
from repro_torch.lint.diagnostics import Diagnostic, error, warning


@dataclasses.dataclass(frozen=True)
class Buffer:
    """What the audit keeps of a tensor: the bytes it spans
    ``[start, end)``, its storage's address, shape, dtype and device."""

    start: int
    end: int
    storage: int
    shape: Tuple[int, ...]
    dtype: str
    device: str

    @classmethod
    def of(cls, t: torch.Tensor) -> "Buffer":
        span = 0 if t.numel() == 0 else 1 + sum(
            (n - 1) * st for n, st in zip(t.shape, t.stride()))
        start = t.data_ptr()
        return cls(start=start, end=start + span * t.element_size(),
                   storage=t.untyped_storage().data_ptr(),
                   shape=tuple(t.shape), dtype=str(t.dtype).split(".")[-1],
                   device=str(t.device))

    def overlaps(self, other: "Buffer") -> bool:
        return (self.device == other.device and self.start < other.end
                and other.start < self.end)

    def describe(self) -> str:
        return f"{self.dtype}{list(self.shape)} on {self.device}"


@dataclasses.dataclass(frozen=True)
class Launch:
    """One recorded launch: the kernel's name (``kernels/cuda.KERNELS``),
    ``route`` "cuda" (the card's kernel) or "plain" (its plain version),
    its source, its destination (None: the source in place) and its other
    tensor operands (coefficients, tap tables)."""

    kernel: str
    route: str
    src: Buffer
    dst: Optional[Buffer]
    operands: Tuple[Buffer, ...] = ()

    def buffers(self) -> Tuple[Buffer, ...]:
        return (self.src,) + ((self.dst,) if self.dst else ()) \
            + self.operands


class LaunchLog:
    """The launches recorded while :func:`record_launches` is on; each is
    passed on to the enclosing recording (``outer``), if any."""

    def __init__(self, outer: Optional["LaunchLog"] = None):
        self.launches: List[Launch] = []
        self.outer = outer

    def launch(self, kernel: str, *, src, dst, operands=(),
               route: str = "cuda") -> None:
        self.launches.append(Launch(
            kernel=kernel, route=route, src=Buffer.of(src),
            dst=None if dst is None else Buffer.of(dst),
            operands=tuple(Buffer.of(t) for t in operands
                           if isinstance(t, torch.Tensor))))
        if self.outer is not None:
            self.outer.launch(kernel, src=src, dst=dst, operands=operands,
                              route=route)


@contextlib.contextmanager
def record_launches() -> Iterator[LaunchLog]:
    """Record every kernel launch and plain-version launch in the block
    (process-wide; a recording inside another passes its launches on)."""
    log = LaunchLog(outer=cuda.AUDIT)
    cuda.AUDIT = log
    try:
        yield log
    finally:
        cuda.AUDIT = log.outer


def _shapes_pair(src: Tuple[int, ...], dst: Tuple[int, ...]) -> bool:
    """``dst`` is ``src`` (the carry's ping-pong pair), or ``src`` less one
    even halo on every trailing axis past equal leading (batch) axes (a
    pre-padded superstep's rounded grid)."""
    if len(src) != len(dst):
        return False
    diffs = [s - d for s, d in zip(src, dst)]
    if not any(diffs):
        return True
    lead = next(i for i, d in enumerate(diffs) if d)
    rest = set(diffs[lead:])
    return len(rest) == 1 and min(rest) > 0 and min(rest) % 2 == 0 \
        and not any(diffs[:lead])


def _tensors(values) -> List[torch.Tensor]:
    if isinstance(values, torch.Tensor):
        return [values]
    return [t for t in values if isinstance(t, torch.Tensor)]


def analyze_launches(launches: Sequence[Launch], *,
                     expect_dtype: Optional[str] = None,
                     inputs=(), results=()) -> List[Diagnostic]:
    """Audit recorded launches, and ``results`` against the caller's
    ``inputs`` (tensors, or a tensor); returns every RP2xx finding (see
    the module docstring)."""
    out: List[Diagnostic] = []
    if not launches:
        out.append(error(
            "RP200", "the audit recorded no kernel launch",
            hint="audit a region that launches the kernels (steps >= 1, "
                 "inside record_launches()); a bypassed launch path must "
                 "fail loudly"))
    given = [Buffer.of(t) for t in _tensors(inputs)]
    got = [Buffer.of(t) for t in _tensors(results)]
    for i, la in enumerate(launches):
        where = f"launch {i} ({la.kernel}, {la.route})"
        d, s = la.dst, la.src
        if d is not None:
            if (d.dtype, d.device) != (s.dtype, s.device) \
                    or not _shapes_pair(s.shape, d.shape):
                out.append(error(
                    "RP201",
                    f"{where}: dst {d.describe()} does not pair with src "
                    f"{s.describe()}",
                    hint="the carry's ping-pong pair is one shape, dtype "
                         "and device; a pre-padded result is the source "
                         "less its halo"))
            elif d.start == s.start and d.storage == s.storage:
                out.append(error(
                    "RP204",
                    f"{where}: dst is src ({s.describe()} at "
                    f"{s.start:#x}): one buffer in two roles",
                    hint="a superstep writes the other buffer of the "
                         "ping-pong pair, never the one it reads"))
            elif d.overlaps(s):
                out.append(error(
                    "RP201",
                    f"{where}: dst [{d.start:#x}, {d.end:#x}) overlaps src "
                    f"[{s.start:#x}, {s.end:#x})",
                    hint="keep the two buffers of the pair disjoint"))
        written = d if d is not None else s
        for g in given:
            if written.overlaps(g):
                out.append(error(
                    "RP204",
                    f"{where} writes the caller's grid "
                    f"({g.describe()}): the run must copy it into its "
                    f"carry first",
                    hint="never consume the caller's buffer; copy it in"))
    for r in got:
        for g in given:
            if r.overlaps(g) or (r.storage == g.storage and r.storage):
                out.append(error(
                    "RP204",
                    f"the result {r.describe()} shares storage with the "
                    f"caller's grid {g.describe()}",
                    hint="return a new tensor; the caller keeps its grid"))
    wide = [b for la in launches for b in la.buffers()] + got
    wide = [b for b in wide if b.dtype == "float64"]
    if wide:
        msg = (f"{len(wide)} float64 tensor(s) among the launches and the "
               f"result (first: {wide[0].describe()})"
               + (f" but the program dtype is {expect_dtype}"
                  if expect_dtype else ""))
        hint = ("a float64 grid or coefficient doubles every byte the "
                "kernels move; cast to the program dtype")
        if expect_dtype is None:
            out.append(warning("RP202", msg, hint=hint))
        elif expect_dtype != "float64":
            out.append(error("RP202", msg, hint=hint))
    return out


def audit_run(fn, *inputs, expect_dtype: Optional[str] = None):
    """``fn(*inputs)`` with its launches recorded; returns ``(result,
    diagnostics)``, the diagnostics those of :func:`analyze_launches`
    with ``inputs`` as the caller's tensors."""
    with record_launches() as log:
        result = fn(*inputs)
    results = result if isinstance(result, (tuple, list)) else (result,)
    return result, analyze_launches(log.launches, expect_dtype=expect_dtype,
                                    inputs=inputs, results=results)


#: The counters of ``kernels/common.trace_counts`` a warm run must never
#: move: library builds and loads, launch-geometry cache misses and the
#: executor's plan resolutions.
RUN_TRACE_FAMILIES = ("library_builds", "library_loads", "wrap_geometry",
                      "queued_geometry", "streamed_geometry",
                      "plan_resolutions")


def check_trace_budget(delta, budget: int, *,
                       context: str = "run",
                       families: Tuple[str, ...] = RUN_TRACE_FAMILIES
                       ) -> List[Diagnostic]:
    """RP203 when a trace-count delta breaks the warm-run contract.

    ``delta`` is a bare int or the mapping ``kernels.common.trace_delta``
    returns, of which the counters in ``families`` are summed; ``budget``
    is how many the region may add (a warm loop: 0).  The reference's
    signature and rule.
    """
    if isinstance(delta, Mapping):
        delta = sum(delta.get(name, 0) for name in families)
    if delta <= budget:
        return []
    return [error(
        "RP203",
        f"{context} redid {delta} build(s), load(s), geometry miss(es) or "
        f"plan resolution(s) against a budget of {budget} — every one is "
        f"host work a warm run must not repeat",
        hint="compile once and run the executable; a Python value that "
             "changes per call (shape, step count, coefficients) misses "
             "the caches")]
