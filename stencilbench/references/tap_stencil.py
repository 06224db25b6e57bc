"""The plain reference of a tap-set stencil, in plain PyTorch.

One step pads the grid by the radius under the program's boundary
(``F.pad``: replicate for clamp, circular for periodic, the boundary value
for constant), then sums the centre and every neighbour tap over shifted
views of the padded grid:

    out[c] = centre * g[c] + sum_k taps[k] * g[boundary(c + offset_k)]

with the offsets of ``stencilbench.work.neighbor_taps``.  It knows no
blocking, no fusion of steps and no batching; the coefficients come as
host floats from the benchmark's own draw.  It imports nothing of the
program.  ``dtype`` sets the precision of the grid and of every product
and sum (the control computes in bfloat16).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from stencilbench import work

_MODES = {"clamp": "replicate", "periodic": "circular", "constant": "constant"}


def _pad(desc: dict, g: torch.Tensor) -> torch.Tensor:
    r, nd = desc["radius"], desc["ndim"]
    mode = _MODES[desc["boundary"]]
    x = g[None, None]
    kw = {"value": float(desc.get("boundary_value", 0.0))} \
        if mode == "constant" else {}
    return F.pad(x, (r, r) * nd, mode=mode, **kw)[0, 0]


def step(desc: dict, center: float, taps: Sequence[float],
         g: torch.Tensor) -> torch.Tensor:
    """One step of an unbatched grid, in ``g``'s dtype."""
    r = desc["radius"]
    p = _pad(desc, g)
    shape = g.shape

    def view(off):
        return p[tuple(slice(r + o, r + o + n) for o, n in zip(off, shape))]

    acc = g * center
    for c, off in zip(taps, work.neighbor_taps(desc)):
        acc.add_(view(off), alpha=c)
    return acc


def advance(desc: dict, center: float, taps: Sequence[float],
            grid: torch.Tensor, steps: int,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``steps`` steps of one grid, computed in ``dtype`` on the grid's
    device; the result in ``dtype``."""
    if len(taps) != len(work.neighbor_taps(desc)):
        raise ValueError(f"{len(taps)} tap coefficients for "
                         f"{len(work.neighbor_taps(desc))} taps")
    g = grid.to(dtype)
    if dtype != torch.float32:
        # the coefficients rounded to the precision they multiply in
        center = float(torch.tensor(center).to(dtype))
        taps = [float(v) for v in torch.tensor(list(taps)).to(dtype)]
    with torch.no_grad():
        for _ in range(steps):
            g = step(desc, center, taps, g)
    return g
