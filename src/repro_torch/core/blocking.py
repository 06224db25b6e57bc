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


#: The superstep kernels of the port, by the name ``kernels/cuda.py``
#: counts their launches under (B1, B3, B4, B5, B6).
KERNELS = ("padded_superstep", "temporal_superstep", "padded_pipelined",
           "superstep", "pipelined_superstep")
#: The kernels that stream a column tile plane by plane
#: (``csrc/streamed_superstep.cu``); the others hold a whole window.
STREAMED_KERNELS = ("temporal_superstep", "padded_pipelined")
#: Planes per group of a streamed CTA, by grid rank: the planes one
#: thread computes per in-plane cell (``csrc/streamed_superstep.cu``).
COLUMN_PLANES = {2: 4, 3: 2}


def check_kernel(kernel: str) -> str:
    if kernel not in KERNELS:
        raise ValueError(f"unknown superstep kernel {kernel!r}; expected "
                         f"one of {KERNELS}")
    return kernel


@dataclasses.dataclass(frozen=True)
class StreamedRings:
    """Shared-memory layout of one streamed CTA (``csrc/
    streamed_superstep.cu``): ``steps`` stages, ring ``s`` holding planes
    of stage ``s``'s output (ring 0: the planes loaded from the source)
    clipped to that stage's in-plane region, ``radius`` fewer cells per
    side per stage on each blocked axis (``ry`` is 0 on a 2D grid's dummy
    y), rows a multiple of 4 floats apart (for 16-byte copies).  Each
    iteration adds ``group`` planes per stage, so a ring holds
    ``2r + group`` planes, and the loaded ring ``group`` more: the next
    group's copy is in flight while the current one computes."""

    steps: int
    radius: int
    ry: int
    plane: Tuple[int, int]
    group: int
    depth0: int
    depth: int

    @property
    def pitch(self) -> int:
        return self.stage_plane(0)[1]

    def stage_plane(self, s: int) -> Tuple[int, int]:
        """(rows, pitch) of ring ``s``."""
        return (self.plane[0] - 2 * s * self.ry,
                round_up(self.plane[1] - 2 * s * self.radius, 4))

    @property
    def ring_planes(self) -> int:
        return self.depth0 + (self.steps - 1) * self.depth

    def ring_cells(self) -> int:
        return sum((self.depth0 if s == 0 else self.depth) * math.prod(
            self.stage_plane(s)) for s in range(self.steps))

    def bytes(self, ntaps: int, itemsize: int = 4) -> int:
        """The rings, a tap-offset table per ring (a row of ``ntaps``
        offsets per ring phase) and the coefficients."""
        return itemsize * self.ring_cells() + \
            4 * ntaps * (self.ring_planes + 1)


def streamed_rings(ndim: int, radius: int, steps: int,
                   tile: Tuple[int, ...]) -> StreamedRings:
    """The :class:`StreamedRings` of a streamed CTA with in-plane column
    tile ``tile`` (``(tx,)`` in 2D, ``(ty, tx)`` in 3D)."""
    if len(tile) != ndim - 1 or min(tile) < 1:
        raise ValueError(f"a streamed {ndim}D tile has {ndim - 1} positive "
                         f"in-plane extents (got {tile})")
    h = steps * radius
    plane = (1, tile[0] + 2 * h) if ndim == 2 else \
        (tile[0] + 2 * h, tile[1] + 2 * h)
    group = COLUMN_PLANES[ndim]
    depth = 2 * radius + group
    return StreamedRings(steps=steps, radius=radius,
                         ry=0 if ndim == 2 else radius, plane=plane,
                         group=group, depth0=depth + group, depth=depth)


def streamed_smem_bytes(ndim: int, radius: int, ntaps: int, steps: int,
                        tile: Tuple[int, ...], itemsize: int = 4) -> int:
    return streamed_rings(ndim, radius, steps, tile).bytes(
        ntaps, itemsize)


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

    def kernel_steps(self, kernel: str) -> int:
        """Time steps one launch of ``kernel`` fuses under this plan: the
        chunk's ``TEMPORAL_CHUNK * par_time`` for the temporal kernel,
        ``par_time`` for every other."""
        check_kernel(kernel)
        chunk = TEMPORAL_CHUNK if kernel == "temporal_superstep" else 1
        return self.par_time * chunk

    def smem_bytes_for(self, tile: Tuple[int, ...],
                       kernel: str = "padded_superstep") -> int:
        """Dynamic shared memory of one CTA of ``kernel`` (a name of
        :data:`KERNELS`) at CTA tile ``tile`` under this plan.

        The window kernels (B1 ``padded_superstep``, B5 ``superstep``, B6
        ``pipelined_superstep``) take an output tile per grid axis and
        hold one halo'd window (``tile + 2*halo`` per axis), a second when
        the fused steps ping-pong, one more for B6's prefetch, and the
        coefficient and offset tables (4 bytes each per tap).  The streamed
        kernels (B3 ``temporal_superstep``, B4 ``padded_pipelined``) take
        an in-plane column tile and hold plane rings
        (:func:`streamed_smem_bytes`).
        """
        steps = self.kernel_steps(kernel)
        if kernel in STREAMED_KERNELS:
            return streamed_smem_bytes(
                self.spec.ndim, self.spec.halo_radius, self.spec.num_taps,
                steps, tile, itemsize=self.itemsize)
        halo = steps * self.spec.halo_radius
        window = math.prod(t + 2 * halo for t in tile)
        windows = (2 if steps > 1 else 1) + (
            1 if kernel == "pipelined_superstep" else 0)
        return self.itemsize * windows * window + 8 * self.spec.num_taps

    def flops_per_block(self) -> int:
        """Sum over the shrinking valid regions of each fused time step."""
        r = self.spec.halo_radius
        total = 0
        for t in range(self.par_time):
            sizes = [p - 2 * (t + 1) * r for p in self.padded_shape]
            total += math.prod(sizes) * self.spec.flops_per_cell
        return total
