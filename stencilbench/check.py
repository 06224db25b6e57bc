"""The comparison that decides ``correct``.

An *answer* is what the timed path produced for one call or one request:
the grid it was given, the grid it returned and the steps between them.
After the window the configuration's plain reference advances each
checked answer's input by the same steps, in the precision the
configuration's ``check.reference_dtype`` names, and the answer is
judged by

    rel_err = max |program - reference| / max |reference|

over every cell.  The run's number is the largest ``rel_err`` of its
answers; it is held to the configuration's ``check.max_rel_err``.  Every
answer due in the window must also have come: ``missing`` counts those
that never did, and its limit is 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch


@dataclasses.dataclass
class Answer:
    """One answer to judge: ``source()`` gives the input grid (drawn again
    from the seed, or a kept reference), ``output`` the program's result
    (None where the control computes it), ``center``/``taps`` the
    coefficients as the benchmark drew them."""

    label: str
    source: Callable[[], torch.Tensor]
    output: Optional[torch.Tensor]
    steps: int
    center: float
    taps: List[float]


def _worse(a: float, b: float) -> float:
    """The larger of two readings, a NaN counting as infinite."""
    return max(float("inf") if math.isnan(a) else a,
               float("inf") if math.isnan(b) else b)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|, both taken in float64 on the
    device in blocks of the leading axis, so no float64 copy of a whole
    grid is made.  A NaN or a shape that differs reads infinite."""
    if got.shape != want.shape:
        return float("inf")
    rows = max(1, want.shape[0] * 2**26 // max(want.numel(), 1))
    worst = scale = 0.0
    for a, b in zip(got.split(rows), want.split(rows)):
        b64 = b.to(torch.float64)
        worst = _worse(worst, float((a.to(torch.float64) - b64).abs().max()))
        scale = _worse(scale, float(b64.abs().max()))
    if math.isinf(worst) or math.isinf(scale):
        return float("inf")
    if scale == 0.0:
        return 0.0 if worst == 0.0 else float("inf")
    return worst / scale


def precision(config: dict, key: str) -> torch.dtype:
    """A precision the configuration's ``check`` names: ``reference_dtype``
    (the reference's) or ``control_dtype`` (the control's)."""
    return getattr(torch, config["check"][key])


def judge(answers: List[Answer], desc: dict, reference,
          dtype: torch.dtype = torch.float32,
          program_dtype: Optional[torch.dtype] = None) -> Dict[str, object]:
    """Each answer against the reference advanced in ``dtype``; returns
    the worst ``rel_err`` and one entry per answer.  ``program_dtype``
    stands the reference in that precision in the program's place (the
    control)."""
    per = []
    worst = 0.0
    for a in answers:
        src = a.source()
        want = reference.advance(desc, a.center, a.taps, src, a.steps, dtype)
        got = a.output
        if program_dtype is not None:
            got = reference.advance(desc, a.center, a.taps, src, a.steps,
                                    program_dtype)
        del src
        err = rel_err(got, want)
        del want, got
        per.append((a.label, err))
        worst = _worse(worst, err)
    return {"max_rel_err": worst, "answers": per}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number compared at or under its limit (a NaN never is)."""
    return all(numbers[k] <= limits[k] for k in limits)
