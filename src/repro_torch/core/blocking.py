"""Spatial + temporal blocking plans — counterpart of ``repro/core/blocking.py``.

Paper eq. 2, unchanged: a block that goes through ``par_time`` fused time
steps loses ``par_time * radius`` of valid output per side.

There is no planner here.  The reference's planner sizes blocks against a
TPU's VMEM; on the H100 the CUDA kernels pick their own CTA tile from the
shared-memory limit (``kernels/cuda.py``), and ``BlockPlan.block_shape``
only fixes the padded layout (the round-up of the grid, and so the ring
depth and wrap geometry), exactly as in the reference.  What one CTA needs
is ``BlockPlan.smem_bytes_for``, the counterpart of the reference's
``vmem_bytes_for``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from repro_torch.core.program import StencilProgram

#: Kernel-variant names shared with the reference.
VARIANTS = ("plain", "pipelined", "temporal")

#: Supersteps fused per temporal-variant launch (the chunk depth).
TEMPORAL_CHUNK = 4


def normalize_variant(variant=None) -> str:
    """``None`` -> "plain"; a known variant name passes; anything else
    raises."""
    if variant is None:
        return "plain"
    if variant not in VARIANTS:
        raise ValueError(
            f"unknown kernel variant {variant!r}; expected one of {VARIANTS}")
    return variant


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """A blocking configuration (same fields as the reference's).

    spec:        the ``StencilProgram``.
    block_shape: the output tile of the reference's grid step (csize).
    par_time:    time steps fused per superstep.
    """

    spec: StencilProgram
    block_shape: Tuple[int, ...]
    par_time: int

    @property
    def program(self) -> StencilProgram:
        return self.spec

    @property
    def itemsize(self) -> int:
        return np.dtype(self.spec.dtype).itemsize

    @property
    def halo(self) -> int:
        return self.par_time * self.spec.halo_radius

    @property
    def padded_shape(self) -> Tuple[int, ...]:
        return tuple(b + 2 * self.halo for b in self.block_shape)

    def hbm_bytes_per_block(self) -> int:
        read = math.prod(self.padded_shape) * self.itemsize
        write = math.prod(self.block_shape) * self.itemsize
        return read + write

    def run_bytes_per_superstep(self, grid_shape: Tuple[int, ...],
                                variant: str = "plain") -> int:
        """Device-memory bytes one superstep of the reference's executor
        moves: every block's halo'd window read plus its tile write, plus
        one pass over each of the two ping-pong padded buffers.  The
        temporal variant charges one chunk-deep launch over the
        ``TEMPORAL_CHUNK`` supersteps it advances."""
        if normalize_variant(variant) == "temporal":
            deep = dataclasses.replace(
                self, par_time=self.par_time * TEMPORAL_CHUNK)
            return deep.run_bytes_per_superstep(grid_shape) // TEMPORAL_CHUNK
        nblocks = math.prod(
            round_up(g, b) // b
            for g, b in zip(grid_shape, self.block_shape))
        padded_carry = math.prod(
            round_up(g, b) + 2 * self.halo
            for g, b in zip(grid_shape, self.block_shape))
        return nblocks * self.hbm_bytes_per_block() \
            + 2 * padded_carry * self.itemsize

    def smem_bytes_for(self, tile: Tuple[int, ...],
                       variant: str = "plain") -> int:
        """Dynamic shared memory of one CTA of the port's superstep kernel
        computing output tile ``tile`` under ``variant``.

        One halo'd window (``tile + 2*halo`` per axis), a second when the
        fused steps ping-pong, one more for the pipelined kernels'
        prefetch, and the coefficient and offset tables (4 bytes each per
        tap, center included).  The temporal kernel fuses
        ``TEMPORAL_CHUNK * par_time`` steps, so its window is deepened by
        the chunk's halo; that deep window also bounds the temporal run's
        other launches (a shallower remainder, or the wrap-degenerate
        fallback's pre-padded superstep with the chunk-deep plan).
        """
        v = normalize_variant(variant)
        steps = self.par_time * (TEMPORAL_CHUNK if v == "temporal" else 1)
        halo = steps * self.spec.halo_radius
        window = math.prod(t + 2 * halo for t in tile)
        windows = (2 if steps > 1 else 1) + (1 if v == "pipelined" else 0)
        return self.itemsize * windows * window + 8 * self.spec.num_taps

    def flops_per_block(self) -> int:
        """Sum over the shrinking valid regions of each fused time step."""
        r = self.spec.halo_radius
        total = 0
        for t in range(self.par_time):
            sizes = [p - 2 * (t + 1) * r for p in self.padded_shape]
            total += math.prod(sizes) * self.spec.flops_per_cell
        return total
