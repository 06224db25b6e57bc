"""The port's own oracle — counterpart of the jnp oracle in
``repro/core/reference.py``.

Deliberately naive: boundary-pad the whole grid, apply the tap-set update,
repeat.  No blocking of any kind.  It runs on any device and in any float
dtype (float64 for exact checks), and a leading batch axis passes through.
``stencil_step``/``stencil_nsteps``/``stencil_nsteps_unrolled`` take the
legacy (``StencilSpec``, ``StencilCoeffs``) pair.
"""

from __future__ import annotations

import torch

from repro_torch.core.codegen import program_update
from repro_torch.core.program import (ProgramCoeffs, StencilProgram,
                                      as_program, normalize_coeffs,
                                      torch_dtype)


def program_step(program: StencilProgram, coeffs: ProgramCoeffs,
                 grid: torch.Tensor) -> torch.Tensor:
    """One time step with the program's boundary; output shape == input."""
    return program_update(program, coeffs, grid)


def program_nsteps(program: StencilProgram, coeffs: ProgramCoeffs,
                   grid: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` time steps, the straightforward iteration (paper eq. 3)."""
    for _ in range(steps):
        grid = program_step(program, coeffs, grid)
    return grid


# ---- legacy star wrappers ----------------------------------------------------

def stencil_step(spec, coeffs, grid: torch.Tensor) -> torch.Tensor:
    """One time step of a legacy spec; output shape == input shape."""
    prog = as_program(spec)
    return program_step(prog, normalize_coeffs(prog, coeffs), grid)


def stencil_nsteps(spec, coeffs, grid: torch.Tensor,
                   steps: int) -> torch.Tensor:
    """``steps`` time steps of a legacy spec (paper eq. 3)."""
    prog = as_program(spec)
    return program_nsteps(prog, normalize_coeffs(prog, coeffs), grid, steps)


stencil_nsteps_unrolled = stencil_nsteps


def random_grid(spec, shape, seed: int = 0) -> torch.Tensor:
    """A CPU grid uniform in [-1, 1) in the spec's (or program's) dtype,
    drawn from a torch generator seeded with ``seed``.  The values are not
    the reference's (a JAX PRNG draw); carry a grid across with numpy
    where both must see the same one."""
    gen = torch.Generator().manual_seed(seed)
    g = torch.rand(tuple(shape), generator=gen, dtype=torch.float64)
    return (2.0 * g - 1.0).to(torch_dtype(spec.dtype))
