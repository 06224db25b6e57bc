"""Stencil specification — the paper's radius-parameterized star stencil,
in PyTorch (counterpart of ``repro/core/spec.py``).

DEPRECATED in favour of :mod:`repro_torch.core.program`: ``StencilSpec``
survives as a thin alias for the star-shaped subset of ``StencilProgram``,
and its Table I characteristics derive from the program's tap set.

Coefficient convention (paper eq. 1, the worst case with no sharing):

    f_c^{t+1} = c_c * f_c^t
              + sum_{i=1..rad} sum_{dir in directions} c[dir, i] * f_{dir, i}^t

with ``directions`` = (west, east, south, north) in 2D and also (below,
above) in 3D, so a cell update costs ``8*rad + 1`` FLOP in 2D and
``12*rad + 1`` in 3D (paper Table I).  Grids are (Y, X) in 2D and
(Z, Y, X) in 3D, X minor.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.program import (ProgramCoeffs, StencilProgram,  # noqa: F401
                                      _bf16_taps, torch_dtype)


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    """Static description of a star-shaped stencil (deprecated alias of a
    star :class:`~repro_torch.core.program.StencilProgram`).

    Attributes:
      ndim:     2 or 3.
      radius:   stencil radius (the paper studies 1..4).
      dtype:    grid dtype name (float32, bfloat16 or float16).
      boundary: "clamp" (the paper's, the default), "periodic" or
                "constant".
    """

    ndim: int
    radius: int
    dtype: str = "float32"
    boundary: str = "clamp"

    def __post_init__(self):
        warnings.warn(
            "StencilSpec is a deprecated alias; construct a "
            "repro_torch.StencilProgram (shape='star') and run it through "
            "repro_torch.stencil(program, coeffs=...).compile(grid_shape, "
            "steps=...).run(grid)",
            DeprecationWarning, stacklevel=3)
        if self.ndim not in (2, 3):
            raise ValueError(f"ndim must be 2 or 3, got {self.ndim}")
        if self.radius < 1:
            raise ValueError(f"radius must be >= 1, got {self.radius}")
        self.to_program()

    def to_program(self) -> StencilProgram:
        """Lift into the IR (star taps, this spec's boundary)."""
        return StencilProgram(ndim=self.ndim, radius=self.radius,
                              shape="star", boundary=self.boundary,
                              dtype=self.dtype)

    # ---- paper Table I characteristics (derived from the tap set) ----------

    @property
    def num_directions(self) -> int:
        return 2 * self.ndim

    @property
    def halo_radius(self) -> int:
        return self.to_program().halo_radius

    @property
    def flops_per_cell(self) -> int:
        """8*rad+1 (2D) or 12*rad+1 (3D), paper Table I."""
        return self.to_program().flops_per_cell

    @property
    def flops_per_cell_shared(self) -> int:
        """(2*ndim+1)*rad + 1: one multiply per distance shell (paper
        §IV.A/§V.A)."""
        return self.to_program().flops_per_cell_shared

    @property
    def muls_per_cell(self) -> int:
        return self.to_program().muls_per_cell

    @property
    def adds_per_cell(self) -> int:
        return self.to_program().adds_per_cell

    @property
    def bytes_per_cell(self) -> int:
        """One read + one write at full on-chip reuse (paper Table I)."""
        return self.to_program().bytes_per_cell

    @property
    def flop_per_byte(self) -> float:
        return self.flops_per_cell / self.bytes_per_cell

    # ---- coefficients ------------------------------------------------------

    def _coeffs(self, raw: np.ndarray) -> "StencilCoeffs":
        """``raw / (2 * raw.sum())`` in the spec's dtype, as the reference
        divides in place; bfloat16 through :func:`_bf16_taps` (numpy
        cannot name it), whose float32 quotient rounds once to bfloat16
        as the reference's in-place division does."""
        if self.dtype == "bfloat16":
            neighbors = _bf16_taps(raw.ravel()).to(torch.bfloat16)
            return StencilCoeffs(
                center=torch.tensor(0.5, dtype=torch.bfloat16),
                neighbors=neighbors.reshape(raw.shape))
        raw = raw.astype(self.dtype)
        raw /= 2.0 * raw.sum()
        return StencilCoeffs(
            center=torch.from_numpy(np.asarray(0.5, dtype=self.dtype)),
            neighbors=torch.from_numpy(raw))

    def default_coeffs(self, seed: int = 0) -> "StencilCoeffs":
        """Distinct coefficients per direction and distance (the paper's
        worst case), scaled so their magnitudes sum to 1/2 beside a center
        of 1/2.  The reference's ``RandomState(seed)`` stream, so the
        values equal its values bit for bit."""
        rng = np.random.RandomState(seed)
        draw = "float64" if self.dtype == "bfloat16" else self.dtype
        raw = rng.uniform(0.2, 1.0, size=(self.num_directions, self.radius))
        return self._coeffs(raw.astype(draw))

    def shared_coeffs(self, seed: int = 0) -> "StencilCoeffs":
        """Distance-shared coefficients (every direction row equal), in the
        same (directions, radius) layout, so the same kernels apply."""
        rng = np.random.RandomState(seed)
        draw = "float64" if self.dtype == "bfloat16" else self.dtype
        row = rng.uniform(0.2, 1.0, size=(1, self.radius)).astype(draw)
        return self._coeffs(np.tile(row, (self.num_directions, 1)))


@dataclasses.dataclass
class StencilCoeffs:
    """Runtime coefficient tensors.

    ``neighbors`` has shape (2*ndim, radius); its rows are (west, east,
    south, north[, below, above]) = (-x, +x, -y, +y[, -z, +z]).
    """

    center: torch.Tensor
    neighbors: torch.Tensor

    def astype(self, dtype) -> "StencilCoeffs":
        """Both tensors in ``dtype`` (a torch dtype or a dtype name)."""
        t = torch_dtype(dtype) if isinstance(dtype, str) else dtype
        return StencilCoeffs(self.center.to(t), self.neighbors.to(t))

    def as_tuple(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self.center, self.neighbors)


#: Direction indices into ``StencilCoeffs.neighbors`` rows.
WEST, EAST, SOUTH, NORTH, BELOW, ABOVE = range(6)


def axis_for_direction(ndim: int, direction: int) -> Tuple[int, int]:
    """(array axis, sign) of a direction index: west/east move along X
    (the last axis), south/north along Y, below/above along Z."""
    last = ndim - 1
    table_2d = {
        WEST: (last, -1),
        EAST: (last, +1),
        SOUTH: (last - 1, -1),
        NORTH: (last - 1, +1),
    }
    if direction in table_2d:
        return table_2d[direction]
    if ndim == 3 and direction in (BELOW, ABOVE):
        return (0, -1 if direction == BELOW else +1)
    raise ValueError(f"direction {direction} invalid for ndim={ndim}")
