"""Run entry point of the kernels — counterpart of ``repro/kernels/ops.py``."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.blocking import BlockPlan, normalize_variant
from repro_torch.core.program import ProgramCoeffs, StencilProgram
from repro_torch.kernels import common


def _stencil_run(grid: torch.Tensor, program: StencilProgram,
                 coeffs: ProgramCoeffs, plan: BlockPlan, steps: int, *,
                 variant: Optional[str] = None) -> torch.Tensor:
    """Advance ``steps`` time steps: ``steps // par_time`` full supersteps,
    then one superstep of the remainder.  ``grid`` may carry a leading
    batch axis; it is never written.  ``steps == 0`` returns ``grid``."""
    if steps < 0:
        raise ValueError("steps must be >= 0")
    v = normalize_variant(variant)
    nb = common.batch_dims(program, grid.ndim)
    if steps == 0:
        return grid
    full, rem = divmod(steps, plan.par_time)
    return common.run_call(grid, coeffs.center, coeffs.taps, full,
                           program=program, plan=plan,
                           true_shape=tuple(grid.shape[nb:]), rem=rem,
                           variant=v)
