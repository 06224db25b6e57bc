"""Tap-set update builders on tensors — counterpart of ``repro/core/codegen.py``.

* ``boundary_pad`` pads a grid by the program's boundary mode.  Clamp and
  periodic pads are index gathers (clipped or wrapped source indices per
  axis): ``F.pad``'s circular mode refuses a pad wider than the axis, and
  its replicate mode wants a batched rank, while a gather takes any width
  and rank.  Constant pads go through ``F.pad``.
* ``tap_interior_update`` applies one stencil step to the interior of a
  halo-carrying block: one shifted view per tap, accumulated center first
  and then in canonical tap order, never reassociated.  It works on the
  last ``program.ndim`` axes, so a leading batch axis passes through.
* ``program_update`` is one full-grid step: pad by the halo, then the
  interior update.  ``multi_step_interior`` chains ``steps`` interior
  updates on a block that carries their halo (paper §III.A).  ``interior_update``/``clamped_update`` take the
  legacy (``StencilSpec``, ``StencilCoeffs``) pair.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.program import (ProgramCoeffs, StencilProgram,
                                      as_program, normalize_coeffs)

PadWidth = Union[int, Sequence[Tuple[int, int]]]


def boundary_pad(program: StencilProgram, grid: torch.Tensor,
                 pad_width: PadWidth) -> torch.Tensor:
    """Pad ``grid`` by the program's boundary mode.

    ``pad_width`` follows ``jnp.pad``: one int for every axis, or one
    ``(lo, hi)`` pair per axis of ``grid``.  clamp -> edge replication,
    periodic -> wraparound (any number of laps), constant ->
    ``program.boundary_value``.
    """
    if isinstance(pad_width, int):
        pads = [(pad_width, pad_width)] * grid.ndim
    else:
        pads = [tuple(p) for p in pad_width]
    if len(pads) != grid.ndim:
        raise ValueError(f"pad_width has {len(pads)} axes, grid has "
                         f"{grid.ndim}")
    if program.boundary == "constant":
        flat = [w for lo_hi in reversed(pads) for w in lo_hi]
        return F.pad(grid, flat, mode="constant",
                     value=program.boundary_value)
    out = grid
    for ax, (lo, hi) in enumerate(pads):
        if lo == 0 and hi == 0:
            continue
        n = grid.shape[ax]
        idx = torch.arange(-lo, n + hi, device=grid.device)
        idx = idx.remainder(n) if program.boundary == "periodic" \
            else idx.clamp(0, n - 1)
        out = out.index_select(ax, idx)
    return out


def tap_interior_update(program: StencilProgram, coeffs: ProgramCoeffs,
                        a: torch.Tensor) -> torch.Tensor:
    """One stencil application on the interior of a halo-carrying block.

    The last ``program.ndim`` axes of ``a`` are spatial; the result is
    smaller by ``2 * halo_radius`` on each of them.  One multiply per tap
    and one add per neighbor tap, in canonical order.
    """
    r = program.halo_radius
    nd = program.ndim
    out_sizes = [s - 2 * r for s in a.shape[-nd:]]
    if any(s <= 0 for s in out_sizes):
        raise ValueError(f"block {tuple(a.shape)} too small for halo "
                         f"radius {r}")

    def view(off):
        return a[(Ellipsis,) + tuple(slice(r + o, r + o + n)
                                     for o, n in zip(off, out_sizes))]

    acc = coeffs.center * view((0,) * nd)
    for k, off in enumerate(program.neighbor_taps):
        acc = acc + coeffs.taps[k] * view(off)
    return acc


def program_update(program: StencilProgram, coeffs: ProgramCoeffs,
                   grid: torch.Tensor) -> torch.Tensor:
    """One full-grid step under the program's boundary; the output has the
    grid's shape (a leading batch axis passes through)."""
    r = program.halo_radius
    nb = grid.ndim - program.ndim
    padded = boundary_pad(program, grid, [(0, 0)] * nb
                          + [(r, r)] * program.ndim)
    return tap_interior_update(program, coeffs, padded)


def multi_step_interior(program, coeffs, a: torch.Tensor,
                        steps: int) -> torch.Tensor:
    """``steps`` stencil applications on a halo-carrying block.

    ``a`` carries a halo of ``steps * halo_radius`` per side; the result
    shrinks by ``2 * steps * halo_radius`` per spatial axis.  This is the
    overlapped temporal-blocking pattern (paper §III.A): the valid region
    shrinks by the halo radius per time step, and the shrinkage is the
    redundant-compute halo.  Takes a program or a legacy spec, and its
    coefficients in either form.
    """
    prog = as_program(program)
    c = normalize_coeffs(prog, coeffs)
    for _ in range(steps):
        a = tap_interior_update(prog, c, a)
    return a


# ---- legacy StencilSpec entry points (deprecated aliases) ------------------

def interior_update(spec, coeffs, a: torch.Tensor) -> torch.Tensor:
    """Legacy star entry point: lifts (spec, StencilCoeffs) into the IR;
    the same arithmetic in the same order as the program's."""
    prog = as_program(spec)
    return tap_interior_update(prog, normalize_coeffs(prog, coeffs), a)


def clamped_update(spec, coeffs, grid: torch.Tensor) -> torch.Tensor:
    """Legacy full-grid step (the paper's clamp, §IV.B, unless the spec
    names another boundary)."""
    prog = as_program(spec)
    return program_update(prog, normalize_coeffs(prog, coeffs), grid)
