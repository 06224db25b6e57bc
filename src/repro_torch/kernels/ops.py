"""Entry points of the kernels — counterpart of ``repro/kernels/ops.py``.

``stencil_superstep`` advances a grid by one superstep of ``par_time``
steps through the pre-padded superstep (``stencil2d``/``stencil3d``);
``_stencil_run`` advances any number of steps through the fused run
executor (``common.run_call``) or, with ``fused=False``, the eager chain of
pre-padded supersteps.  Both take a leading batch axis and
``variant="plain" | "pipelined" | "temporal"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.blocking import (BlockPlan, TEMPORAL_CHUNK,
                                       normalize_variant)
from repro_torch.core.program import ProgramCoeffs, StencilProgram
from repro_torch.kernels import common
from repro_torch.kernels.stencil2d import stencil2d_superstep
from repro_torch.kernels.stencil3d import stencil3d_superstep


def stencil_superstep(grid: torch.Tensor, program: StencilProgram,
                      coeffs: ProgramCoeffs, plan: BlockPlan, *,
                      variant: Optional[str] = None) -> torch.Tensor:
    """One superstep of ``plan.par_time`` steps; ``grid`` is not written."""
    v = normalize_variant(variant)
    # The reference's own semantics, not a fallback: a single superstep
    # cannot amortize a chunk, so the temporal variant's superstep IS the
    # plain kernel (repro/kernels/ops.py:stencil_superstep).
    if v == "temporal":
        v = "plain"
    step = stencil2d_superstep if program.ndim == 2 else stencil3d_superstep
    return step(grid, program, coeffs, plan, variant=v)


def _stencil_run(grid: torch.Tensor, program: StencilProgram,
                 coeffs: ProgramCoeffs, plan: BlockPlan, steps: int, *,
                 variant: Optional[str] = None,
                 fused: bool = True) -> torch.Tensor:
    """Advance ``steps`` time steps: ``steps // period`` full launches, then
    one superstep of the remainder, the period being ``par_time`` or, under
    "temporal", ``par_time * TEMPORAL_CHUNK``.  ``grid`` may carry a
    leading batch axis; it is never written.  ``steps == 0`` returns
    ``grid``.  ``fused=False`` runs the eager chain of pre-padded
    supersteps instead of the padded carry (for temporal, each chunk is
    the chunk-deep plan through the plain kernel, as in the reference)."""
    if steps < 0:
        raise ValueError("steps must be >= 0")
    v = normalize_variant(variant)
    nb = common.batch_dims(program, grid.ndim)
    if steps == 0:
        return grid
    period = plan.par_time * (TEMPORAL_CHUNK if v == "temporal" else 1)
    full, rem = divmod(steps, period)
    if not fused:
        step_plan = common.deep_plan(plan) if v == "temporal" else plan
        for _ in range(full):
            grid = stencil_superstep(grid, program, coeffs, step_plan,
                                     variant=v)
        if rem:
            grid = stencil_superstep(
                grid, program, coeffs,
                dataclasses.replace(plan, par_time=rem), variant=v)
        return grid
    return common.run_call(grid, coeffs.center, coeffs.taps, full,
                           program=program, plan=plan,
                           true_shape=tuple(grid.shape[nb:]), rem=rem,
                           variant=v)
