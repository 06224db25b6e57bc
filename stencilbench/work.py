"""The work a stencil run does, counted from its description alone.

This is the benchmark's own copy of the arithmetic, so that a change to
the program cannot move the yardstick: the tap sets in their canonical
order, the operations a cell update executes, the bytes a call must move
at the least, and the data-sheet peaks they are held against.

A program description is the ``program`` object of a configuration file:
``ndim``, ``radius``, ``shape`` (star, box, diamond), ``boundary`` (clamp,
periodic, constant), ``boundary_value`` and ``dtype``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

Offset = Tuple[int, ...]

DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}

#: Data-sheet peaks by the name ``torch.cuda.get_device_name()`` gives:
#: FP32 outside the tensor cores (an FMA counted as two operations) and
#: HBM bandwidth.  NVIDIA H100 SXM5 80 GB, at its 700 W limit.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops_per_s": 67e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def star_taps(ndim: int, radius: int) -> Tuple[Offset, ...]:
    """Star taps, direction-major in (W, E, S, N[, B, A]) order and
    distance ascending within a direction; X is the last axis."""
    last = ndim - 1
    directions = [(last, -1), (last, 1), (last - 1, -1), (last - 1, 1)]
    if ndim == 3:
        directions += [(0, -1), (0, 1)]
    taps = []
    for axis, sign in directions:
        for dist in range(1, radius + 1):
            off = [0] * ndim
            off[axis] = sign * dist
            taps.append(tuple(off))
    return tuple(taps)


def _cube(ndim: int, radius: int):
    rng = range(-radius, radius + 1)
    if ndim == 2:
        return [(y, x) for y in rng for x in rng]
    return [(z, y, x) for z in rng for y in rng for x in rng]


def neighbor_taps(desc: dict) -> Tuple[Offset, ...]:
    """The non-centre taps of a description, in the order its coefficients
    are given: stars as :func:`star_taps`; boxes (Chebyshev norm) and
    diamonds (L1 norm) by (norm, offset)."""
    ndim, radius, shape = desc["ndim"], desc["radius"], desc["shape"]
    if shape == "star":
        return star_taps(ndim, radius)
    if shape == "box":
        norm = lambda o: max(abs(c) for c in o)  # noqa: E731
    elif shape == "diamond":
        norm = lambda o: sum(abs(c) for c in o)  # noqa: E731
    else:
        raise ValueError(f"unknown stencil shape {shape!r}")
    offs = [o for o in _cube(ndim, radius) if 0 < norm(o) <= radius]
    return tuple(sorted(offs, key=lambda o: (norm(o), o)))


def flops_per_cell(desc: dict) -> int:
    """Operations one cell update executes: a multiply per tap (the centre
    included) and an add per neighbour tap.  33 for the 2D radius-4 star,
    49 for the 3D one."""
    n = len(neighbor_taps(desc))
    return (n + 1) + n


def cell_bytes(desc: dict) -> int:
    return DTYPE_BYTES[desc["dtype"]]


def cell_steps(grid: Sequence[int], steps: int, batch: int = 1) -> int:
    """Cell updates of one call: every cell of every grid, every step."""
    return batch * math.prod(grid) * steps


def call_bytes(desc: dict, grid: Sequence[int], batch: int = 1) -> int:
    """The least bytes a call moves: one read of each input grid and one
    write of each output grid, whatever the kernels fuse or re-read."""
    return 2 * batch * math.prod(grid) * cell_bytes(desc)


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """The data-sheet peaks of a card by its name, or None where the table
    has none (a roofline is then not reported)."""
    return PEAKS.get(device_name)


def bound_seconds(flops: float, nbytes: float,
                  peak: Dict[str, float]) -> float:
    """The least time the card could take: the larger of the operations
    at the FP32 peak and the bytes at the HBM peak."""
    return max(flops / peak["fp32_flops_per_s"],
               nbytes / peak["hbm_bytes_per_s"])
