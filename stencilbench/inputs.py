"""Inputs made from the seed: grids and coefficients.

Every draw happens on the device the run uses, with a ``torch.Generator``
of that device, one call per grid.  Each grid has a generator of its own,
seeded from ``(seed, stream, index)``, so any one of them can be drawn
again after the window without keeping it.

Two coefficient draws:

* :func:`seeded_coeffs` — per-tap weights from the seed, for a caller
  that hands its own coefficients to ``repro_torch.stencil(program,
  coeffs)``;
* :func:`program_default_coeffs` — the benchmark's copy of the draw the
  port makes when it is handed none (``StencilProgram.default_coeffs()``,
  seed 0), for a caller that cannot pass coefficients, such as the
  stencil server.  The reference gets this copy, never the port's tensors.

Both give a centre of 0.5 and neighbour weights in [0.2, 1) scaled to sum
to 0.5, so every step is a convex combination: stable at any length.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from stencilbench import work

_MASK = (1 << 63) - 1
_STREAMS = {"grid": 1, "coeffs": 2, "sample": 3}


def derived_seed(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit generator seed for one stream and index of a run's seed
    (any whole number, negative or beyond 64 bits included)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + _STREAMS[stream] * 0xBF58476D1CE4E5B9
         + index * 0x94D049BB133111EB) & _MASK
    x ^= x >> 31
    return (x * 0xD6E8FEB86659FD93) & _MASK


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def dtype_of(desc: dict) -> torch.dtype:
    """The torch dtype a program description states."""
    return getattr(torch, desc["dtype"])


def grid(shape: Sequence[int], seed: int, index: int, device,
         dtype=torch.float32) -> torch.Tensor:
    """Grid ``index`` of a run: uniform in [-1, 1), drawn in float32 on
    ``device`` and rounded to ``dtype``, so every dtype gets the same
    field."""
    g = _generator(device, derived_seed(seed, "grid", index))
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    out.uniform_(-1.0, 1.0, generator=g)
    return out if dtype == torch.float32 else out.to(dtype)


def seeded_coeffs(desc: dict, seed: int, device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(centre, taps) on ``device`` in the program's dtype: taps uniform
    in [0.2, 1) from the seed, scaled to sum to 0.5; centre 0.5."""
    n = len(work.neighbor_taps(desc))
    g = _generator(device, derived_seed(seed, "coeffs"))
    raw = torch.empty(n, dtype=torch.float64, device=device)
    raw.uniform_(0.2, 1.0, generator=g)
    dtype = getattr(torch, desc["dtype"])
    taps = (raw / (2.0 * raw.sum())).to(dtype)
    center = torch.tensor(0.5, dtype=dtype, device=device)
    return center, taps


def program_default_coeffs(desc: dict) -> Tuple[float, List[float]]:
    """The port's draw for a program handed no coefficients, as host
    floats: ``RandomState(0)``; a star draws (2 * ndim, radius) weights
    and flattens them direction-major, other shapes one per tap; the
    centre is 0.5.  The taps are cast to the program's dtype and scaled
    to sum to 0.5 in it; in bfloat16, which numpy lacks, the draw is
    rounded through float32, summed in order with a rounding after every
    add, and divided in float32 (:func:`_bfloat16_taps`)."""
    if desc.get("coeff_sharing", "pertap") != "pertap":
        raise ValueError("the copied default draw is per-tap only")
    rng = np.random.RandomState(0)
    if desc["shape"] == "star":
        raw = rng.uniform(0.2, 1.0, size=(2 * desc["ndim"], desc["radius"]))
        raw = raw.ravel()
    else:
        raw = rng.uniform(0.2, 1.0, size=(len(work.neighbor_taps(desc)),))
    if desc["dtype"] == "bfloat16":
        return 0.5, _bfloat16_taps(raw)
    raw = raw.astype(desc["dtype"])
    raw = raw / (2.0 * raw.sum())
    return 0.5, [float(v) for v in raw]


def _bfloat16_taps(raw: np.ndarray) -> List[float]:
    b = torch.from_numpy(raw.astype(np.float32)).to(torch.bfloat16)
    total = b[0]
    for v in b[1:]:
        total = total + v
    return (b.float() / (2.0 * total.float())).tolist()
