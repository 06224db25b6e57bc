"""2D superstep over a pre-padded grid — counterpart of
``repro/kernels/stencil2d.py``.

``boundary_pad`` the grid by the plan's halo plus the round-up to the
block, one pre-padded superstep (``common.superstep_call``: B5, or B6 for
"pipelined"), and the true region back.  Takes the legacy
(``StencilSpec``, ``StencilCoeffs``) pair or (``StencilProgram``,
``ProgramCoeffs``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.blocking import BlockPlan, normalize_variant
from repro_torch.core.program import (ProgramCoeffs, StencilProgram,
                                      as_program, normalize_coeffs)
from repro_torch.kernels import common


def stencil2d_superstep(grid: torch.Tensor, program: StencilProgram,
                        coeffs: ProgramCoeffs, plan: BlockPlan, *,
                        pipelined: bool = False,
                        variant: Optional[str] = None) -> torch.Tensor:
    """Advance a 2D grid ``(H, W)``, or a batch of them, by
    ``plan.par_time`` steps in one launch; ``variant`` picks "plain" or
    "pipelined" (a single superstep has no temporal chunk to fuse);
    ``None`` defers to the deprecated ``pipelined`` bool.  Takes the legacy
    (``StencilSpec``, ``StencilCoeffs``) pair too."""
    pipe = normalize_variant(variant, pipelined) == "pipelined"
    program = as_program(program)
    coeffs = normalize_coeffs(program, coeffs)
    if program.ndim != 2 or grid.ndim - 2 not in (0, 1):
        raise ValueError("stencil2d_superstep requires a 2D program and a "
                         "2D (or batched 3D) grid")
    return common.pad_superstep(grid, coeffs.center, coeffs.taps,
                                program=program, plan=plan,
                                variant="pipelined" if pipe else "plain")
