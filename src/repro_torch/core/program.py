"""StencilProgram — the frontend IR, in PyTorch.

Counterpart of ``repro/core/program.py``.  A stencil is an explicit tap set
(integer offset vectors plus one coefficient each) from which the halo
depth, the FLOP count and the boundary handling all derive.

Families (radius-parametric):

* ``star``     — taps on the axes only, ``±d·e_a`` for d = 1..radius.
* ``box``      — every offset with Chebyshev norm <= radius.
* ``diamond``  — every offset with L1 norm <= radius.

Boundaries: ``clamp`` (nearest border cell), ``periodic`` (wrap) and
``constant`` (``boundary_value``).

Tap order is canonical because summation order is part of the semantics
and is never reassociated: ``star`` is direction-major in (W, E, S, N[, B,
A]) order with distances ascending; ``box``/``diamond`` are ordered by
(shell distance, lexicographic offset).  Grids are (Y, X) in 2D and
(Z, Y, X) in 3D, X minor.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

Offset = Tuple[int, ...]

SHAPES = ("star", "box", "diamond")
BOUNDARIES = ("clamp", "periodic", "constant")
SHARING = ("pertap", "distance")
#: The grid dtypes of the kernels, by the program's ``dtype`` name: numpy
#: cannot name bfloat16, so sizes and casts read this table.
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a program's ``dtype`` name (a name the kernels
    take, or any other that torch knows, such as float64)."""
    if name in DTYPES:
        return DTYPES[name]
    t = getattr(torch, str(name), None)
    if not isinstance(t, torch.dtype):
        raise ValueError(f"dtype {name!r} names no torch dtype")
    return t


def dtype_bytes(name: str) -> int:
    """Bytes per cell of a program's ``dtype`` name."""
    return torch_dtype(name).itemsize


@functools.lru_cache(maxsize=None)
def _star_taps(ndim: int, radius: int) -> Tuple[Offset, ...]:
    """(W, E, S, N[, B, A]) × distance ascending."""
    last = ndim - 1
    axes_signs = [(last, -1), (last, +1), (last - 1, -1), (last - 1, +1)]
    if ndim == 3:
        axes_signs += [(0, -1), (0, +1)]
    taps = []
    for axis, sign in axes_signs:
        for dist in range(1, radius + 1):
            off = [0] * ndim
            off[axis] = sign * dist
            taps.append(tuple(off))
    return tuple(taps)


def _shell_sorted(offsets, norm) -> Tuple[Offset, ...]:
    return tuple(sorted(offsets, key=lambda o: (norm(o), o)))


@functools.lru_cache(maxsize=None)
def _box_taps(ndim: int, radius: int) -> Tuple[Offset, ...]:
    rng = range(-radius, radius + 1)
    if ndim == 2:
        offs = [(y, x) for y in rng for x in rng if (y, x) != (0, 0)]
    else:
        offs = [(z, y, x) for z in rng for y in rng for x in rng
                if (z, y, x) != (0, 0, 0)]
    return _shell_sorted(offs, lambda o: max(abs(c) for c in o))


@functools.lru_cache(maxsize=None)
def _diamond_taps(ndim: int, radius: int) -> Tuple[Offset, ...]:
    rng = range(-radius, radius + 1)
    if ndim == 2:
        offs = [(y, x) for y in rng for x in rng
                if 0 < abs(y) + abs(x) <= radius]
    else:
        offs = [(z, y, x) for z in rng for y in rng for x in rng
                if 0 < abs(z) + abs(y) + abs(x) <= radius]
    return _shell_sorted(offs, lambda o: sum(abs(c) for c in o))


_TAP_BUILDERS = {"star": _star_taps, "box": _box_taps, "diamond": _diamond_taps}


def tap_distance(shape: str, off: Offset) -> int:
    """Distance shell of a tap: L1 for diamond, Chebyshev otherwise."""
    if shape == "diamond":
        return sum(abs(c) for c in off)
    return max(abs(c) for c in off)


@dataclasses.dataclass(frozen=True)
class StencilProgram:
    """Shape/boundary-parametric stencil description (same fields as the
    reference, so ``dataclasses.asdict`` of either side compares equal)."""

    ndim: int
    radius: int
    shape: str = "star"
    boundary: str = "clamp"
    boundary_value: float = 0.0
    coeff_sharing: str = "pertap"
    dtype: str = "float32"

    def __post_init__(self):
        if self.ndim not in (2, 3):
            raise ValueError(f"ndim must be 2 or 3, got {self.ndim}")
        if self.radius < 1:
            raise ValueError(f"radius must be >= 1, got {self.radius}")
        if self.shape not in SHAPES:
            raise ValueError(f"shape must be one of {SHAPES}, got {self.shape}")
        if self.boundary not in BOUNDARIES:
            raise ValueError(
                f"boundary must be one of {BOUNDARIES}, got {self.boundary}")
        if self.coeff_sharing not in SHARING:
            raise ValueError(
                f"coeff_sharing must be one of {SHARING}, got"
                f" {self.coeff_sharing}")

    @classmethod
    def from_spec(cls, spec) -> "StencilProgram":
        """Lift a legacy ``StencilSpec`` (a star) into the IR."""
        return cls(ndim=spec.ndim, radius=spec.radius, shape="star",
                   boundary=getattr(spec, "boundary", "clamp"),
                   dtype=spec.dtype)

    @property
    def neighbor_taps(self) -> Tuple[Offset, ...]:
        """Canonically ordered non-center taps (see module docstring)."""
        return _TAP_BUILDERS[self.shape](self.ndim, self.radius)

    @property
    def num_neighbor_taps(self) -> int:
        return len(self.neighbor_taps)

    @property
    def num_taps(self) -> int:
        return self.num_neighbor_taps + 1

    @property
    def tap_groups(self) -> Tuple[int, ...]:
        """Per-tap distance-shell index (0-based), for coefficient sharing."""
        return tuple(tap_distance(self.shape, o) - 1
                     for o in self.neighbor_taps)

    @property
    def num_shells(self) -> int:
        return max(self.tap_groups) + 1 if self.neighbor_taps else 0

    @property
    def halo_radius(self) -> int:
        """Per-axis halo one application needs (== radius for all families)."""
        return max(max(abs(c) for c in o) for o in self.neighbor_taps)

    @property
    def muls_per_cell(self) -> int:
        return self.num_neighbor_taps + 1

    @property
    def adds_per_cell(self) -> int:
        return self.num_neighbor_taps

    @property
    def flops_per_cell(self) -> int:
        """One multiply per tap and one add per neighbor tap, as executed."""
        return self.muls_per_cell + self.adds_per_cell

    @property
    def flops_per_cell_shared(self) -> int:
        """FLOPs if the multiplies of a shared distance shell were collapsed
        (paper §IV.A): an add per neighbor tap, a multiply per shell and
        the center's.  Informational: no kernel collapses them."""
        return self.num_neighbor_taps + self.num_shells + 1

    @property
    def bytes_per_cell(self) -> int:
        """One read + one write at full on-chip reuse (paper Table I)."""
        return 2 * dtype_bytes(self.dtype)

    @property
    def flop_per_byte(self) -> float:
        return self.flops_per_cell / self.bytes_per_cell

    def default_coeffs(self, seed: int = 0) -> "ProgramCoeffs":
        """Per-tap coefficients whose magnitudes sum to 1 (constant grids
        are fixed points).  Draws the same ``RandomState`` stream as the
        reference, so both packages get identical values and dtypes for a
        seed: ``center`` in the grid's dtype, ``taps`` too but for
        bfloat16, where the reference's numpy promotes them to float32
        (:func:`_bf16_taps`)."""
        rng = np.random.RandomState(seed)
        n = self.num_neighbor_taps
        # bfloat16 draws in float64 here and rounds in _bf16_taps
        draw = "float64" if self.dtype == "bfloat16" else self.dtype
        if self.coeff_sharing == "distance":
            shell = rng.uniform(0.2, 1.0,
                                size=(self.num_shells,)).astype(draw)
            raw = shell[np.asarray(self.tap_groups)]
        elif self.shape == "star":
            # legacy draw shape: (2*ndim, radius), direction-major flatten
            raw = rng.uniform(0.2, 1.0, size=(2 * self.ndim, self.radius))
            raw = raw.astype(draw).ravel()
        else:
            raw = rng.uniform(0.2, 1.0, size=(n,)).astype(draw)
        if self.dtype == "bfloat16":
            return ProgramCoeffs(
                center=torch.tensor(0.5, dtype=torch.bfloat16),
                taps=_bf16_taps(raw))
        raw = raw / (2.0 * raw.sum())
        center = np.asarray(0.5, dtype=self.dtype)
        return ProgramCoeffs(center=torch.from_numpy(center),
                             taps=torch.from_numpy(np.ascontiguousarray(raw)))

    def coeffs_from_shells(self, center, shell_values) -> "ProgramCoeffs":
        """Expand per-shell coefficients (one per distance shell,
        :attr:`tap_groups`) to the full tap vector."""
        shell_values = torch.as_tensor(shell_values)
        idx = torch.as_tensor(self.tap_groups, dtype=torch.long,
                              device=shell_values.device)
        return ProgramCoeffs(center=torch.as_tensor(center),
                             taps=shell_values[idx])

    def coeffs_from_legacy(self, legacy) -> "ProgramCoeffs":
        """Legacy ``StencilCoeffs`` (directions x radius) in tap order: for
        a star the canonical order is the direction-major flatten of that
        layout."""
        if self.shape != "star":
            raise ValueError("legacy StencilCoeffs only describe star taps")
        return ProgramCoeffs(center=legacy.center,
                             taps=legacy.neighbors.reshape(-1))


def _bf16_taps(raw: np.ndarray) -> torch.Tensor:
    """The reference's ``raw / (2.0 * raw.sum())`` on ``raw`` cast to
    bfloat16 (``ml_dtypes``): the draw rounded through float32 to
    bfloat16, summed in order with a rounding to bfloat16 after every add,
    then ``2.0 * sum`` and the division in float32, the dtype numpy
    promotes a bfloat16 array and a Python float to."""
    b = torch.from_numpy(raw.astype(np.float32)).to(torch.bfloat16)
    total = b[0]
    for v in b[1:]:
        total = total + v
    return b.float() / (2.0 * total.float())


@dataclasses.dataclass
class ProgramCoeffs:
    """Runtime coefficients: ``taps[k]`` pairs with
    ``program.neighbor_taps[k]``; ``center`` is the (0,…,0) tap."""

    center: torch.Tensor
    taps: torch.Tensor

    def to(self, device) -> "ProgramCoeffs":
        return ProgramCoeffs(self.center.to(device), self.taps.to(device))

    def astype(self, dtype) -> "ProgramCoeffs":
        """Both tensors cast to ``dtype`` (a torch dtype or its name)."""
        if isinstance(dtype, str):
            dtype = torch_dtype(dtype)
        return ProgramCoeffs(self.center.to(dtype), self.taps.to(dtype))

    def as_tuple(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self.center, self.taps)


def as_program(spec_or_program) -> StencilProgram:
    """A ``StencilProgram`` as it is, a legacy ``StencilSpec`` lifted."""
    if isinstance(spec_or_program, StencilProgram):
        return spec_or_program
    return StencilProgram.from_spec(spec_or_program)


def normalize_coeffs(program: StencilProgram, coeffs) -> ProgramCoeffs:
    """``ProgramCoeffs`` as they are, legacy ``StencilCoeffs`` in tap
    order."""
    if isinstance(coeffs, ProgramCoeffs):
        return coeffs
    return program.coeffs_from_legacy(coeffs)
