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
#: The kernels that run ``csrc/queued_superstep.cu``'s register queues for
#: a star within :data:`QUEUE_STEPS` (B1, B5, B6) and the streamed kernel
#: (``csrc/streamed_superstep.cu``) for every other tap set, as B3 and B4
#: always do.  Every kernel takes an in-plane column tile.
QUEUED_KERNELS = ("padded_superstep", "superstep", "pipelined_superstep")
#: Planes per group of a streamed CTA, by grid rank: the planes one
#: thread computes per in-plane cell (``csrc/streamed_superstep.cu``).
COLUMN_PLANES = {2: 4, 3: 2}
#: Fused steps the register-queue path takes for a star, by grid rank and
#: radius: a thread's queues (``3r`` values per stage and cell, x4 cells)
#: and its strip's taps stay within 128 registers without spilling
#: (``queued_superstep.cu:choose_queue`` instantiates these; a 3D star of
#: radius 4 at 2 steps spilled 168 bytes).
QUEUE_STEPS = {2: {1: 4, 2: 3, 3: 2, 4: 2}, 3: {1: 4, 2: 3, 3: 2, 4: 1}}
#: Queue values per cell a thread keeps in registers over all stages: each
#: stage's queue holds ``3r`` planes (a group of ``r`` computed in a step
#: and ``r`` on either side); a star with ``steps*3r > QUEUE_REGS`` leaves
#: stage 0's values in the loaded ring instead.
QUEUE_REGS = 14
#: Threads of a queued CTA (each owns a strip of 4 x cells).
QUEUE_THREADS = 256
#: Bytes of stage-0 planes a queued CTA keeps in flight (at least one and
#: at most 8 groups ahead): about 16 KB a CTA, 32 KB an SM.
QUEUE_INFLIGHT = 16384


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


def queue_path(program: StencilProgram, steps: int) -> bool:
    """Whether ``steps`` fused steps of ``program`` take the register-queue
    path of ``csrc/queued_superstep.cu`` (a star of radius 1..4 and at
    most :data:`QUEUE_STEPS` steps)."""
    return program.shape == "star" and \
        steps <= QUEUE_STEPS[program.ndim].get(program.halo_radius, 0)


def kernel_body(program: StencilProgram, kernel: str, steps: int) -> str:
    """The body that runs ``steps`` fused steps of ``program`` for
    ``kernel``: "queue" (B1, B5, B6 with a star within
    :data:`QUEUE_STEPS`: the register queues of
    ``csrc/queued_superstep.cu``) or "streamed" (B3, B4, and B1, B5, B6
    otherwise: ``csrc/streamed_superstep.cu``, on the padded carry or in
    its pre-padded mode).  Shared memory, the tile pick and RP105 all size
    a kernel by it."""
    check_kernel(kernel)
    if kernel in QUEUED_KERNELS and queue_path(program, steps):
        return "queue"
    return "streamed"


@dataclasses.dataclass(frozen=True)
class QueuedPlanes:
    """Shared-memory layout of one CTA of ``csrc/queued_superstep.cu`` at
    in-plane column tile ``tile`` (``(tx,)`` in 2D, ``(ty, tx)`` in 3D).

    Planes have the stage-0 extent (tile + 2h per blocked axis, one row in
    2D), rows :attr:`pitch` floats apart (the stage-0 extent rounded to 4
    floats plus 12: room for the 4..7-float shift that aligns a shared row
    with its source row, and the strips' 16-byte reads past it).  Stage-0
    planes arrive in groups of :attr:`group` = ``r`` planes, one barrier a
    group, into a ring of :attr:`groups` groups: those read behind the
    current group (the centre planes of stage 1, ``r`` back, or all its
    streamed-axis taps, ``2r`` back), the current one and :attr:`ahead` in
    flight.  Each later stage holds two groups of centre planes.  Then a
    guard of 16 floats and an 8-byte mbarrier per loaded group."""

    ndim: int
    radius: int
    steps: int
    tile: Tuple[int, ...]

    @property
    def extent(self) -> Tuple[int, int]:
        h = self.steps * self.radius
        if self.ndim == 2:
            return 1, self.tile[0] + 2 * h
        return self.tile[0] + 2 * h, self.tile[1] + 2 * h

    @property
    def pitch(self) -> int:
        return round_up(self.extent[1], 4) + 12

    @property
    def plane(self) -> int:
        return self.extent[0] * self.pitch

    @property
    def group(self) -> int:
        return self.radius

    @property
    def ahead(self) -> int:
        """Groups in flight: :data:`QUEUE_INFLIGHT` bytes, 1 to 8."""
        return min(8, max(1, -(-QUEUE_INFLIGHT //
                               (4 * self.group * self.plane))))

    @property
    def stage0_in_registers(self) -> bool:
        return self.steps * 3 * self.radius <= QUEUE_REGS

    @property
    def groups(self) -> int:
        r, b = self.radius, self.group
        back = r if self.stage0_in_registers else 2 * r
        return -(-back // b) + 1 + self.ahead

    @property
    def depth0(self) -> int:
        """Loaded planes."""
        return self.groups * self.group

    @property
    def planes(self) -> int:
        return self.depth0 + (self.steps - 1) * 2 * self.group

    def bytes(self) -> int:
        return 4 * (self.plane * self.planes + 16) + 8 * self.groups

    def strips(self, pad: int) -> Tuple[int, int, int]:
        """(rows, strips per row, first strip) of the threads at x shift
        ``pad``: strips of 4 cells at 16-byte aligned shared columns over
        the stage-1 region."""
        r = self.radius
        E1, E2 = self.extent
        rows = E1 - (0 if self.ndim == 2 else 2 * r)
        first = (r + pad) // 4
        return rows, (E2 - r + pad + 3) // 4 - first, first

    @property
    def cost(self) -> float:
        """Cells loaded and computed per output cell.  Loaded: the stage-0
        extent.  Computed: every thread's strip in each stage (a warp
        issues for its idle lanes too), at the widest x shift."""
        E1, E2 = self.extent
        computed = self.steps * 4 * max(
            rows * nx for rows, nx, _ in
            (self.strips(pad) for pad in range(4, 8)))
        return (E1 * E2 + computed) / math.prod(self.tile)

    @property
    def threads_fit(self) -> bool:
        """Every x shift leaves at most one strip per thread."""
        return all(rows * nx <= QUEUE_THREADS for rows, nx, _ in
                   (self.strips(pad) for pad in range(4, 8)))


def queued_planes(program: StencilProgram, steps: int,
                  tile: Tuple[int, ...]) -> QueuedPlanes:
    nd = program.ndim
    tile = tuple(int(t) for t in tile)
    if len(tile) != nd - 1 or min(tile) < 1:
        raise ValueError(f"a queued {nd}D tile has {nd - 1} positive "
                         f"in-plane extents (got {tile})")
    return QueuedPlanes(ndim=nd, radius=program.halo_radius, steps=steps,
                        tile=tile)


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
        :data:`KERNELS`) at in-plane column tile ``tile`` under this plan,
        for the body it runs (:meth:`body`): the :class:`QueuedPlanes` of
        the register queues, or the plane rings of the streamed kernel
        (:func:`streamed_smem_bytes`)."""
        steps = self.kernel_steps(kernel)
        if self.body(kernel) == "streamed":
            return streamed_smem_bytes(
                self.spec.ndim, self.spec.halo_radius, self.spec.num_taps,
                steps, tile, itemsize=self.itemsize)
        return queued_planes(self.spec, steps, tile).bytes()

    def body(self, kernel: str) -> str:
        """:func:`kernel_body` of ``kernel`` under this plan."""
        return kernel_body(self.spec, kernel, self.kernel_steps(kernel))

    def flops_per_block(self) -> int:
        """Sum over the shrinking valid regions of each fused time step."""
        r = self.spec.halo_radius
        total = 0
        for t in range(self.par_time):
            sizes = [p - 2 * (t + 1) * r for p in self.padded_shape]
            total += math.prod(sizes) * self.spec.flops_per_cell
        return total
