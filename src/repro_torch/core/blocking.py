"""Spatial + temporal blocking plans and the H100 planner — counterpart of
``repro/core/blocking.py``.

Paper eq. 2, unchanged: a block that goes through ``par_time`` fused time
steps loses ``par_time * radius`` of valid output per side.

The reference's planner sizes blocks against a TPU's VMEM.  On the H100
the CUDA kernels pick their own CTA tile from the shared-memory limit
(``kernels/cuda.py``), and ``BlockPlan.block_shape`` only fixes the padded
layout (the round-up of the grid, and so the ring depth and wrap
geometry), exactly as in the reference.  What one CTA needs is
``BlockPlan.smem_bytes_for``, the counterpart of the reference's
``vmem_bytes_for``.  So the planner here (:func:`estimate`,
:func:`plan_blocking`) prices what moves time on the card: ``par_time``,
the variant, and the body and CTA tile each kernel runs at them.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import List, Optional, Sequence, Tuple

from repro_torch.analysis.hw import GpuChip, H100_SXM
from repro_torch.core import h100_calibration as cal
from repro_torch.core.program import StencilProgram, as_program, dtype_bytes

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
#: The padded-carry superstep kernel of each variant, by the name
#: ``kernels/cuda.py`` counts its launches under.
CARRY_KERNELS = {"plain": "padded_superstep",
                 "temporal": "temporal_superstep",
                 "pipelined": "padded_pipelined"}
#: Planes per group of a streamed CTA, by grid rank: the planes one
#: thread computes per in-plane cell (``csrc/streamed_superstep.cu``).
COLUMN_PLANES = {2: 4, 3: 2}
#: Fused steps the register-queue path takes for a star, by grid rank and
#: radius, in every grid dtype: a thread's queues (``3r`` values per stage
#: and cell, x4 cells: four floats, or two 16-bit pairs) and its strip's
#: taps stay within 128 registers without spilling
#: (``queued_superstep.cu:choose_queue`` instantiates these; a 3D star of
#: radius 4 at 2 steps spilled 168 bytes in float32).
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
#: Bytes of one vector copy of the kernels (``cp.async``, ``cp.async.bulk``
#: rows, the wrap refresh): rows and pitches align to it.
VEC_BYTES = 16


def vec_cells(cell_bytes: int) -> int:
    """Cells of one 16-byte copy: 4 in float32, 8 in 16 bits
    (``csrc/elem.cuh:kVecCells``)."""
    return VEC_BYTES // cell_bytes


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
    y), rows a multiple of 16 bytes apart (for 16-byte copies: 4 cells in
    float32, 8 in 16 bits; ``itemsize`` is the grid's bytes per cell).
    Each iteration adds ``group`` planes per stage, so a ring holds
    ``2r + group`` planes, and the loaded ring ``group`` more: the next
    group's copy is in flight while the current one computes."""

    steps: int
    radius: int
    ry: int
    plane: Tuple[int, int]
    group: int
    depth0: int
    depth: int
    itemsize: int = 4

    @property
    def pitch(self) -> int:
        return self.stage_plane(0)[1]

    def stage_plane(self, s: int) -> Tuple[int, int]:
        """(rows, pitch) of ring ``s``."""
        return (self.plane[0] - 2 * s * self.ry,
                round_up(self.plane[1] - 2 * s * self.radius,
                         vec_cells(self.itemsize)))

    @property
    def ring_planes(self) -> int:
        return self.depth0 + (self.steps - 1) * self.depth

    def ring_cells(self) -> int:
        return sum((self.depth0 if s == 0 else self.depth) * math.prod(
            self.stage_plane(s)) for s in range(self.steps))

    def bytes(self, ntaps: int) -> int:
        """The rings, a tap-offset table per ring (a row of ``ntaps``
        offsets per ring phase) and the coefficients (floats)."""
        return self.itemsize * self.ring_cells() + \
            4 * ntaps * (self.ring_planes + 1)


def streamed_rings(ndim: int, radius: int, steps: int,
                   tile: Tuple[int, ...], itemsize: int = 4
                   ) -> StreamedRings:
    """The :class:`StreamedRings` of a streamed CTA with in-plane column
    tile ``tile`` (``(tx,)`` in 2D, ``(ty, tx)`` in 3D) on a grid of
    ``itemsize`` bytes per cell."""
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
                         group=group, depth0=depth + group, depth=depth,
                         itemsize=itemsize)


def streamed_smem_bytes(ndim: int, radius: int, ntaps: int, steps: int,
                        tile: Tuple[int, ...], itemsize: int = 4) -> int:
    return streamed_rings(ndim, radius, steps, tile, itemsize).bytes(ntaps)


def queue_path(program: StencilProgram, steps: int) -> bool:
    """Whether ``steps`` fused steps of ``program`` take the register-queue
    path of ``csrc/queued_superstep.cu`` (a star of radius 1..4 and at
    most :data:`QUEUE_STEPS` steps, in every grid dtype)."""
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
    2D), rows :attr:`pitch` cells apart (the stage-0 extent rounded to
    ``A`` = :attr:`vec` cells, the cells of 16 bytes, plus ``3A``: room
    for the ``A..2A-1``-cell shift that aligns a shared row with its
    source row, and the strips' reads past it).  Stage-0
    planes arrive in groups of :attr:`group` = ``r`` planes, one barrier a
    group, into a ring of :attr:`groups` groups: those read behind the
    current group (the centre planes of stage 1, ``r`` back, or all its
    streamed-axis taps, ``2r`` back), the current one and :attr:`ahead` in
    flight.  Each later stage holds two groups of centre planes.  Then a
    guard of 16 cells and an 8-byte mbarrier per loaded group.  Cells are
    ``itemsize`` bytes (the grid's dtype)."""

    ndim: int
    radius: int
    steps: int
    tile: Tuple[int, ...]
    itemsize: int = 4

    @property
    def vec(self) -> int:
        """Cells of one 16-byte copy."""
        return vec_cells(self.itemsize)

    @property
    def pads(self) -> range:
        """The x shifts a row can take (``queued.x_shift``)."""
        return range(self.vec, 2 * self.vec)

    @property
    def extent(self) -> Tuple[int, int]:
        h = self.steps * self.radius
        if self.ndim == 2:
            return 1, self.tile[0] + 2 * h
        return self.tile[0] + 2 * h, self.tile[1] + 2 * h

    @property
    def pitch(self) -> int:
        return round_up(self.extent[1], self.vec) + 3 * self.vec

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
                               (self.itemsize * self.group *
                                self.plane))))

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
        return self.itemsize * (self.plane * self.planes + 16) + \
            8 * self.groups

    def strips(self, pad: int) -> Tuple[int, int, int]:
        """(rows, strips per row, first strip) of the threads at x shift
        ``pad``: strips of 4 cells at 4-cell aligned shared columns over
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
            (self.strips(pad) for pad in self.pads))
        return (E1 * E2 + computed) / math.prod(self.tile)

    @property
    def threads_fit(self) -> bool:
        """Every x shift leaves at most one strip per thread."""
        return all(rows * nx <= QUEUE_THREADS for rows, nx, _ in
                   (self.strips(pad) for pad in self.pads))


def queued_planes(program: StencilProgram, steps: int,
                  tile: Tuple[int, ...]) -> QueuedPlanes:
    nd = program.ndim
    tile = tuple(int(t) for t in tile)
    if len(tile) != nd - 1 or min(tile) < 1:
        raise ValueError(f"a queued {nd}D tile has {nd - 1} positive "
                         f"in-plane extents (got {tile})")
    return QueuedPlanes(ndim=nd, radius=program.halo_radius, steps=steps,
                        tile=tile, itemsize=dtype_bytes(program.dtype))


def normalize_variant(variant=None, pipelined: bool = False) -> str:
    """One rule for the ``pipelined: bool`` -> ``variant: str`` migration,
    the reference's: a known variant name passes, a bool (the deprecated
    knob) maps True -> "pipelined" and False -> "plain", ``None`` defers
    to ``pipelined``; anything else raises."""
    if variant is None:
        variant = bool(pipelined)
    if variant is True:
        return "pipelined"
    if variant is False:
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

    spec:        the ``StencilProgram``; a legacy ``StencilSpec`` is lifted
                 into its program here, so a legacy plan equals the front
                 door's and every planner and kernel reads one IR.
    block_shape: the output tile of the reference's grid step (csize).
    par_time:    time steps fused per superstep.
    """

    spec: StencilProgram
    block_shape: Tuple[int, ...]
    par_time: int

    def __post_init__(self):
        if not isinstance(self.spec, StencilProgram):
            object.__setattr__(self, "spec", as_program(self.spec))

    @property
    def program(self) -> StencilProgram:
        return self.spec

    @property
    def itemsize(self) -> int:
        return dtype_bytes(self.spec.dtype)

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


# ---- the H100 planner ---------------------------------------------------------
#
# One superstep launch of ``kernel`` over ``cells`` output cells costs
#
#   cells * max(bytes / hbm_bytes_per_s, flops / (peak_fp32_flops / 2))
#         / efficiency + LAUNCH_S
#
# where bytes are the cells the body loads per output cell (its CTA tile's
# halo'd in-plane extent) plus the one it writes, and flops the cells it
# computes per output cell (every stage over its shrinking region, idle
# lanes included) times ``flops_per_cell``: the body's own cost
# (``QueuedPlanes.cost``, ``streamed.column_cost``) at the tile
# ``kernels/cuda.pick_tile`` takes under ``chip.smem_optin``.  The divisor
# of the peak is halved because the kernels keep mul and add apart, with
# no FMA, to equal their plain versions bit for bit.  ``efficiency`` is
# the share of that bound the launcher reached on the card
# (``core/h100_calibration.py``): measured per launcher, tap set and
# fused steps by ``tools/planner_calibration.py``; for steps not measured
# the nearest measured ones, for a tap set not measured the median of its
# launcher and grid rank.  It holds what the bound cannot see: the
# instruction mix of each instantiation, its occupancy, its copies.  The
# carry kernels compute the true cells only, so a block's round-up waste
# shows in the run executor's fills of the padded pair.  A run adds one
# launch per wrap refresh and those fills and copies
# (``kernels/common.run_call``) at ``COPY_EFFICIENCY`` of the memory rate.

#: Useful-work floor: a launch whose output cell updates are this share of
#: the cells it computes or less never wins (the reference's value).
MIN_USEFUL_FRACTION = 0.25


def launcher(plan: BlockPlan, kernel: str) -> str:
    """Which launcher runs ``kernel`` under ``plan``: "queue" (the
    register queues), "streamed" (the streamed kernel's one-shot grid: B3,
    and B1 for other tap sets) or "persistent" (its persistent CTAs: B4).
    The calibration is keyed by it."""
    if plan.body(kernel) == "queue":
        return "queue"
    return "persistent" if kernel == "padded_pipelined" else "streamed"


def efficiency(plan: BlockPlan, kernel: str) -> float:
    """The measured share of the bound of one launch of ``kernel`` under
    ``plan`` (``core/h100_calibration.py``)."""
    prog = plan.spec
    return _efficiency((launcher(plan, kernel), prog.shape, prog.ndim,
                        prog.radius, plan.kernel_steps(kernel),
                        plan.itemsize))


@functools.lru_cache(maxsize=None)
def _efficiency(key) -> float:
    """The row of ``key``; for fused steps not measured, the row of the
    nearest measured steps of the same launcher, tap set and bytes per
    cell (the fewer on a tie); for a tap set not measured, the median of
    its launcher at that many bytes per cell.  A 16-bit launch never takes
    a float32 row: its kernels run other instructions (16-bit pairs) on
    half the bytes."""
    if key in cal.EFFICIENCY:
        return cal.EFFICIENCY[key]
    near = [k for k in cal.EFFICIENCY
            if k[:4] == key[:4] and k[5] == key[5]]
    if near:
        return cal.EFFICIENCY[min(near, key=lambda k: (abs(k[4] - key[4]),
                                                       k[4]))]
    return cal.LAUNCHER_EFFICIENCY[(key[0], key[2], key[5])]


@dataclasses.dataclass(frozen=True)
class PlanEstimate:
    """The model's price of one superstep of ``plan`` under ``variant``
    (for "temporal" one chunk of ``TEMPORAL_CHUNK`` supersteps): the body
    and CTA tile its kernel runs, its compute and memory time per block of
    output cells, and the useful cell updates per second that gives, with
    no launch cost (:func:`superstep_seconds` adds it for a grid)."""

    plan: BlockPlan
    variant: str
    kernel: str
    body: str
    tile: Tuple[int, ...]
    compute_s_per_block: float
    hbm_s_per_block: float
    gcells_per_s: float        # useful cell updates/s
    gflops_per_s: float        # useful FLOP/s (no redundancy counted)
    bound: str                 # "compute" | "memory"
    useful_fraction: float     # output cell updates / computed cells


def launch_work(plan: BlockPlan, kernel: str, chip: GpuChip = H100_SXM
                ) -> Tuple[Tuple[int, ...], float, float, float]:
    """``(tile, bytes, flops, useful_fraction)`` of one launch of
    ``kernel`` under ``plan``, per output cell: the CTA tile it takes
    under ``chip.smem_optin``; the cells its body loads there plus the
    one it writes, in bytes; the cells it computes times
    ``flops_per_cell``; and its output cell updates over the cells it
    computes.  Raises (as the launch would) when no tile fits."""
    # local: kernels/ imports this module
    from repro_torch.kernels import cuda, streamed
    prog = plan.spec
    steps = plan.kernel_steps(kernel)
    tile = cuda.pick_tile(plan, kernel, chip.smem_optin)
    if plan.body(kernel) == "queue":
        planes = queued_planes(prog, steps, tile)
        loaded = math.prod(planes.extent) / math.prod(tile)
        computed = planes.cost - loaded
    else:
        h = steps * prog.halo_radius
        loaded = math.prod(t + 2 * h for t in tile) / math.prod(tile)
        computed = streamed.column_cost(prog.ndim, prog.halo_radius, steps,
                                        tile) - loaded
    return (tile, (loaded + 1) * plan.itemsize,
            computed * prog.flops_per_cell, steps / computed)


def _launch_terms(plan: BlockPlan, kernel: str, chip: GpuChip):
    """Compute and memory seconds per output cell of one launch."""
    tile, moved, flops, useful = launch_work(plan, kernel, chip)
    eff = efficiency(plan, kernel)
    t_ops = flops / (chip.peak_fp32_flops / 2) / eff
    t_mem = moved / chip.hbm_bytes_per_s / eff
    return tile, useful, t_ops, t_mem


def launch_seconds(plan: BlockPlan, kernel: str, cells: int,
                   chip: GpuChip = H100_SXM) -> float:
    """The model's time of one launch of ``kernel`` under ``plan`` over
    ``cells`` output cells."""
    _, _, t_ops, t_mem = _launch_terms(plan, kernel, chip)
    return cells * max(t_ops, t_mem) + cal.LAUNCH_S


def estimate(plan: BlockPlan, chip: GpuChip = H100_SXM,
             variant: Optional[str] = None) -> PlanEstimate:
    """The H100 model of one superstep of ``plan`` under ``variant``
    (see the comment above :data:`MIN_USEFUL_FRACTION`), launch cost
    left out."""
    v = normalize_variant(variant)
    kernel = CARRY_KERNELS[v]
    tile, useful, t_ops, t_mem = _launch_terms(plan, kernel, chip)
    block = math.prod(plan.block_shape)
    steps = plan.kernel_steps(kernel)
    gcells = steps / max(t_ops, t_mem) / 1e9
    return PlanEstimate(
        plan=plan, variant=v, kernel=kernel, body=plan.body(kernel),
        tile=tile, compute_s_per_block=block * t_ops,
        hbm_s_per_block=block * t_mem, gcells_per_s=gcells,
        gflops_per_s=gcells * plan.spec.flops_per_cell,
        bound="compute" if t_ops >= t_mem else "memory",
        useful_fraction=useful)


def _launch_cells(kernel: str, plan: BlockPlan, grid_shape, batch: int
                  ) -> int:
    """Output cells one launch computes: the carry kernels the true cells,
    the pre-padded ones (B5, B6) every cell of the rounded grid."""
    if kernel in CARRY_KERNELS.values():
        return batch * math.prod(grid_shape)
    return batch * math.prod(round_up(g, b)
                             for g, b in zip(grid_shape, plan.block_shape))


def _launches_seconds(plan: BlockPlan, grid_shape: Tuple[int, ...],
                      steps: int, chip: GpuChip, variant: str, batch: int):
    """The launches of a fused run of ``steps`` (``kernels/common.
    run_launches``), a wrap refresh before each superstep when periodic
    or, for a wrap-degenerate layout, the re-pad copies of each; and the
    schedule."""
    # local: kernels/ imports this module
    from repro_torch.kernels import common
    sched = common.ring_schedule(plan.spec, plan, tuple(grid_shape), steps,
                                 variant=variant)
    t = 0.0
    supersteps = 0
    for kernel, _, kplan, count in common.run_launches(sched):
        t += count * launch_seconds(
            kplan, kernel, _launch_cells(kernel, kplan, grid_shape, batch),
            chip)
        supersteps += count
    if sched.fallback:
        t += supersteps * 4 * batch * math.prod(grid_shape) \
            * plan.itemsize / (chip.hbm_bytes_per_s * cal.COPY_EFFICIENCY)
    elif sched.layout.wrap_axes:
        t += supersteps * cal.LAUNCH_S
    return t, sched


def superstep_seconds(plan: BlockPlan, grid_shape: Tuple[int, ...],
                      chip: GpuChip = H100_SXM,
                      variant: Optional[str] = None, batch: int = 1
                      ) -> float:
    """The model's time of one steady-state superstep (a chunk for
    "temporal") of a run on ``grid_shape``: its launch, and its wrap
    refresh or re-pad copies."""
    v = normalize_variant(variant)
    period = plan.kernel_steps(CARRY_KERNELS[v])
    return _launches_seconds(plan, grid_shape, period, chip, v, batch)[0]


def run_seconds(plan: BlockPlan, grid_shape: Tuple[int, ...], steps: int,
                chip: GpuChip = H100_SXM, variant: Optional[str] = None,
                batch: int = 1) -> float:
    """The model's wall time of a fused run of ``steps`` on
    ``grid_shape``: its launches (the remainder's too) with their wrap
    refreshes, and the run executor's fills of the padded pair (where the
    round-up waste shows), copy in and slice out; a wrap-degenerate run
    re-pads every superstep instead."""
    v = normalize_variant(variant)
    t, sched = _launches_seconds(plan, grid_shape, steps, chip, v, batch)
    if sched.fallback:
        return t
    moved = 2 * batch * math.prod(sched.layout.padded_shape) \
        + 4 * batch * math.prod(grid_shape)
    return t + moved * plan.itemsize / (chip.hbm_bytes_per_s *
                                        cal.COPY_EFFICIENCY)


def grid_useful_fraction(grid_shape: Optional[Tuple[int, ...]],
                         block_shape: Tuple[int, ...]) -> float:
    """Share of the rounded grid's cells that are true cells (1.0 = no
    round-up waste; 1.0 when the grid is unknown)."""
    if grid_shape is None:
        return 1.0
    frac = 1.0
    for g, b in zip(grid_shape, block_shape):
        frac *= g / round_up(g, b)
    return frac


#: The paper configurations' blocks (``configs/``), candidates on every
#: grid of their rank.
CONFIG_BLOCKS = {2: ((1024, 1024),), 3: ((32, 64, 704), (32, 128, 1024))}


def candidate_blocks(ndim: int, grid_shape: Optional[Tuple[int, ...]] = None
                     ) -> Tuple[Tuple[int, ...], ...]:
    """Block candidates: the grid's extents, halves and quarters per axis
    (when the grid is known) and the configurations' own blocks, largest
    first.  A block only rounds the padded layout here, so a candidate
    differs from another only by its round-up waste, and of the blocks
    that round the grid alike only the largest is kept."""
    blocks = sorted(CONFIG_BLOCKS[ndim], reverse=True)
    if grid_shape is None:
        return tuple(blocks)
    if len(grid_shape) != ndim:
        raise ValueError(f"grid_shape {tuple(grid_shape)} is not {ndim}-D")
    blocks = sorted(set(blocks).union(itertools.product(*(
        {-(-int(g) // f) for f in (1, 2, 4)} for g in grid_shape))),
        reverse=True)
    rounded = {}
    for b in blocks:
        rounded.setdefault(tuple(round_up(g, x)
                                 for g, x in zip(grid_shape, b)), b)
    return tuple(rounded.values())


def candidate_plans(spec: StencilProgram, chip: GpuChip = H100_SXM,
                    max_par_time: int = 64,
                    block_candidates: Optional[
                        Sequence[Tuple[int, ...]]] = None,
                    variant: Optional[str] = None,
                    grid_shape: Optional[Tuple[int, ...]] = None,
                    steps: Optional[int] = None,
                    pipelined: bool = False) -> List[BlockPlan]:
    """Plans over ``block_candidates`` (default :func:`candidate_blocks`)
    and ``par_time`` 1..``max_par_time`` whose kernels all fit a CTA tile
    in ``chip.smem_optin`` for any step count (``lint/verify.
    smem_diagnostics`` with ``steps=None``; given ``grid_shape`` and
    ``steps``, for that run too: a wrap-degenerate layout runs other
    kernels) and keep more than :data:`MIN_USEFUL_FRACTION` of their
    computed cells as output.  Neither depends on the block, and both
    only grow worse with ``par_time``, so the first that fails ends it.
    ``spec`` may be a legacy ``StencilSpec``, and ``pipelined`` is the
    deprecated bool spelling of ``variant`` (:func:`normalize_variant`)."""
    # local: lint/ imports this module
    from repro_torch.lint.verify import smem_diagnostics
    spec = as_program(spec)
    v = normalize_variant(variant, pipelined)
    if block_candidates is None:
        block_candidates = candidate_blocks(spec.ndim, grid_shape)
    kernel = CARRY_KERNELS[v]
    plans = []
    for pt in range(1, max_par_time + 1):
        probes = [BlockPlan(spec=spec, block_shape=tuple(bs), par_time=pt)
                  for bs in block_candidates]
        if not probes or smem_diagnostics(probes[0], v, chip) or \
                launch_work(probes[0], kernel, chip)[3] \
                <= MIN_USEFUL_FRACTION:
            break
        plans += [p for p in probes if grid_shape is None or steps is None
                  or not smem_diagnostics(p, v, chip,
                                          grid_shape=tuple(grid_shape),
                                          steps=steps)]
    return plans


def plan_rate(plan: BlockPlan, chip: GpuChip = H100_SXM,
              variant: Optional[str] = None,
              grid_shape: Optional[Tuple[int, ...]] = None) -> float:
    """Useful cell updates per second the model predicts for a
    steady-state superstep: with ``grid_shape``, of a run on that grid
    (launch and wrap refresh charged), else of the kernel alone."""
    if grid_shape is None:
        return estimate(plan, chip, variant).gcells_per_s * 1e9
    v = normalize_variant(variant)
    steps = plan.kernel_steps(CARRY_KERNELS[v])
    return math.prod(grid_shape) * steps / superstep_seconds(
        plan, tuple(grid_shape), chip, v)


def plan_blocking(spec: StencilProgram, chip: GpuChip = H100_SXM,
                  grid_shape: Optional[Tuple[int, ...]] = None,
                  max_par_time: int = 64,
                  variant: Optional[str] = None,
                  steps: Optional[int] = None,
                  pipelined: bool = False) -> PlanEstimate:
    """The model's best plan of :func:`candidate_plans` for ``variant``:
    the highest :func:`plan_rate` on ``grid_shape`` (if given), then the
    least round-up waste, then the smaller ``par_time``, then the larger
    block.  ``steps`` (with
    ``grid_shape``) also requires the run of that many steps to fit.
    Deterministic: the model is arithmetic on ``chip``'s figures.
    ``spec`` and ``pipelined`` as :func:`candidate_plans` takes them."""
    spec = as_program(spec)
    v = normalize_variant(variant, pipelined)
    best = None
    for plan in candidate_plans(spec, chip, max_par_time=max_par_time,
                                variant=v, grid_shape=grid_shape,
                                steps=steps):
        key = (plan_rate(plan, chip, v, grid_shape),
               grid_useful_fraction(grid_shape, plan.block_shape),
               -plan.par_time, plan.block_shape)
        if best is None or key > best[0]:
            best = (key, plan)
    if best is None:
        raise ValueError(f"no blocking plan of {spec} under variant {v!r} "
                         f"fits a CTA tile of {chip.name} with more than "
                         f"{MIN_USEFUL_FRACTION} of the cells it computes "
                         f"useful")
    return estimate(best[1], chip, v)
