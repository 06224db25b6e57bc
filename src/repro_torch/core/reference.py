"""The port's own oracle — counterpart of the jnp oracle in
``repro/core/reference.py``.

Deliberately naive: boundary-pad the whole grid, apply the tap-set update,
repeat.  No blocking of any kind.  It runs on any device and in any float
dtype (float64 for exact checks), and a leading batch axis passes through.
"""

from __future__ import annotations

import torch

from repro_torch.core.codegen import boundary_pad, tap_interior_update
from repro_torch.core.program import ProgramCoeffs, StencilProgram


def program_step(program: StencilProgram, coeffs: ProgramCoeffs,
                 grid: torch.Tensor) -> torch.Tensor:
    """One time step with the program's boundary; output shape == input."""
    r = program.halo_radius
    nb = grid.ndim - program.ndim
    padded = boundary_pad(program, grid, [(0, 0)] * nb
                          + [(r, r)] * program.ndim)
    return tap_interior_update(program, coeffs, padded)


def program_nsteps(program: StencilProgram, coeffs: ProgramCoeffs,
                   grid: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` time steps, the straightforward iteration (paper eq. 3)."""
    for _ in range(steps):
        grid = program_step(program, coeffs, grid)
    return grid
