"""The port's own oracles — counterpart of ``repro/core/reference.py``.

Two independent oracles, as in the reference:

* ``program_step`` / ``program_nsteps`` — torch, deliberately naive:
  boundary-pad the whole grid, apply the tap-set update, repeat.  No
  blocking of any kind.  They run on any device and in any float dtype
  (float64 for exact checks), and a leading batch axis passes through.
  ``stencil_step``/``stencil_nsteps``/``stencil_nsteps_unrolled`` take the
  legacy (``StencilSpec``, ``StencilCoeffs``) pair.
* ``numpy_program_step`` / ``numpy_program_nsteps`` — numpy, float64,
  gather-based: each neighbour read is index arithmetic (clip, modulo or a
  validity mask per boundary mode), sharing no code path with the torch
  oracle or the kernels.  They take tensors (any device or dtype) or
  arrays and return ``np.ndarray``.
"""

from __future__ import annotations

import numpy as np
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


#: The reference's Python-unrolled oracle; :func:`program_nsteps` is a
#: Python loop already, so the two are one function here.
program_nsteps_unrolled = program_nsteps


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


# ---- numpy oracle (independent implementation) -----------------------------

def _float64(x) -> np.ndarray:
    """``x`` (a tensor on any device and in any dtype, or array-like) as a
    float64 array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def _np_neighbor(g: np.ndarray, off, boundary: str, value: float):
    """Gather the ``off``-shifted neighbour field of ``g`` under a boundary.

    Per displaced axis, the source index vector is clipped (clamp),
    wrapped (periodic) or clipped and masked (constant), and ``np.take``
    reads along that axis; out-of-domain reads under ``constant`` become
    ``value`` at the end.
    """
    out = g
    valid = None
    for ax, o in enumerate(off):
        if o == 0:
            continue
        n = g.shape[ax]
        idx = np.arange(n) + o
        if boundary == "periodic":
            idx = idx % n
        elif boundary == "clamp":
            idx = np.clip(idx, 0, n - 1)
        else:  # constant
            bad = (idx < 0) | (idx >= n)
            idx = np.clip(idx, 0, n - 1)
            bshape = [1] * g.ndim
            bshape[ax] = n
            bad = bad.reshape(bshape)
            valid = ~bad if valid is None else (valid & ~bad)
        out = np.take(out, idx, axis=ax)
    if boundary == "constant" and valid is not None:
        out = np.where(valid, out, np.asarray(value, dtype=out.dtype))
    return out


def numpy_program_step(program: StencilProgram, coeffs,
                       grid) -> np.ndarray:
    """One stencil step in float64 numpy, gather-based (module doc)."""
    prog = as_program(program)
    c = normalize_coeffs(prog, coeffs)
    g = _float64(grid)
    center = float(_float64(c.center))
    taps = _float64(c.taps)
    acc = center * g
    for k, off in enumerate(prog.neighbor_taps):
        acc = acc + taps[k] * _np_neighbor(g, off, prog.boundary,
                                           prog.boundary_value)
    return acc


def numpy_program_nsteps(program: StencilProgram, coeffs, grid,
                         steps: int) -> np.ndarray:
    """``steps`` steps of :func:`numpy_program_step`, in float64."""
    g = _float64(grid)
    for _ in range(steps):
        g = numpy_program_step(program, coeffs, g)
    return g
