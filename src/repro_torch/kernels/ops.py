"""Entry points of the kernels — counterpart of ``repro/kernels/ops.py``.

``stencil_superstep`` advances a grid by one superstep of ``par_time``
steps through the pre-padded superstep (``stencil2d``/``stencil3d``);
``_stencil_run`` advances any number of steps through the fused run
executor (``common.run_call``) or, with ``fused=False``, the eager chain of
pre-padded supersteps.  Both take a leading batch axis and
``variant="plain" | "pipelined" | "temporal"``; the deprecated
``pipelined=True`` bool maps to ``variant="pipelined"``.

Both accept the legacy (``StencilSpec``, ``StencilCoeffs``) pair or
(``StencilProgram``, ``ProgramCoeffs``).

``stencil_run`` is the deprecated front end of ``_stencil_run``: it warns
and dispatches into the same ``_stencil_run`` and ``run_call`` as
``repro_torch.stencil(program).compile(...).run(grid)``, so its result
equals the front door's.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

from repro_torch.core.blocking import (BlockPlan, TEMPORAL_CHUNK,
                                       normalize_variant)
from repro_torch.core.program import (ProgramCoeffs, StencilProgram,
                                      as_program, normalize_coeffs)
from repro_torch.kernels import common
from repro_torch.kernels.stencil2d import stencil2d_superstep
from repro_torch.kernels.stencil3d import stencil3d_superstep


def stencil_superstep(grid: torch.Tensor, program: StencilProgram,
                      coeffs: ProgramCoeffs, plan: BlockPlan, *,
                      pipelined: bool = False,
                      variant: Optional[str] = None) -> torch.Tensor:
    """One superstep of ``plan.par_time`` steps; ``grid`` is not written."""
    v = normalize_variant(variant, pipelined)
    # The reference's own semantics, not a fallback: a single superstep
    # cannot amortize a chunk, so the temporal variant's superstep IS the
    # plain kernel (repro/kernels/ops.py:stencil_superstep).
    if v == "temporal":
        v = "plain"
    program = as_program(program)
    step = stencil2d_superstep if program.ndim == 2 else stencil3d_superstep
    return step(grid, program, coeffs, plan, variant=v)


def stencil_run(grid: torch.Tensor, program: StencilProgram,
                coeffs: ProgramCoeffs, plan: BlockPlan, steps: int, *,
                pipelined: bool = False,
                variant: Optional[str] = None,
                fused: bool = True) -> torch.Tensor:
    """Deprecated front end of :func:`_stencil_run`; use
    ``repro_torch.stencil(program, coeffs=...).compile(grid_shape,
    steps=...).run(grid)``, which dispatches to the same executor."""
    warnings.warn(
        "kernels.ops.stencil_run is deprecated; use "
        "repro_torch.stencil(program, coeffs=...).compile(grid_shape, "
        "steps=...).run(grid)",
        DeprecationWarning, stacklevel=2)
    return _stencil_run(grid, program, coeffs, plan, steps,
                        pipelined=pipelined,  # legacy-ok
                        variant=variant, fused=fused)


def _stencil_run(grid, program: StencilProgram,
                 coeffs: ProgramCoeffs, plan: BlockPlan, steps: int, *,
                 pipelined: bool = False,
                 variant: Optional[str] = None,
                 fused: bool = True) -> torch.Tensor:
    """Advance ``steps`` time steps: ``steps // period`` full launches, then
    one superstep of the remainder, the period being ``par_time`` or, under
    "temporal", ``par_time * TEMPORAL_CHUNK``.  ``grid`` may carry a
    leading batch axis, or be a batch given as a sequence of equal-shaped
    grids, which the padded carry takes row by row (every other path
    stacks it first); it is never written.  ``steps == 0`` returns
    ``grid`` (a sequence stacked).  ``fused=False`` runs the eager chain of
    pre-padded supersteps instead of the padded carry (for temporal, each
    chunk is the chunk-deep plan through the plain kernel, as in the
    reference)."""
    if steps < 0:
        raise ValueError("steps must be >= 0")
    v = normalize_variant(variant, pipelined)
    program = as_program(program)
    coeffs = normalize_coeffs(program, coeffs)
    rows = not isinstance(grid, torch.Tensor)
    if rows:
        grid = tuple(grid)
        if not grid:
            raise ValueError("a batch given as a sequence needs a grid")
        common.batch_dims(program, grid[0].ndim + 1)
        true_shape = tuple(grid[0].shape)
    else:
        nb = common.batch_dims(program, grid.ndim)
        true_shape = tuple(grid.shape[nb:])
    if steps == 0 or not fused:
        grid = torch.stack(grid) if rows else grid
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
                           true_shape=true_shape, rem=rem, variant=v)
