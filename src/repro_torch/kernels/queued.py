"""Geometry of the register-queued superstep kernels
(``csrc/queued_superstep.cu``).

B1 (``padded_superstep``: the padded carry), B5 (``superstep``) and B6
(``pipelined_superstep``: a grid ``boundary_pad`` already padded) walk a
column tile plane by plane along the streamed axis, as the streamed
kernels do (axes (streamed, y, x); a 2D grid streams along y and has a
dummy y of extent 1 and radius 0).  A work item is a column tile of
in-plane output cells and a segment ``[a, e)`` of output planes; its
stage 0 is the source planes ``[a - h, e + h)`` (``h = T*r``).  For a
star of radius ``r <= 4`` and ``T <= QUEUE_STEPS[ndim][r]`` fused steps
each thread keeps ``3r`` values per stage and cell in registers; every
other tap set runs the streamed kernel (``kernels/streamed.py``).  The
shared memory is :class:`repro_torch.core.blocking.QueuedPlanes`.
Everything here is host arithmetic, so the CPU tests check it.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.blocking import (QUEUE_THREADS, QueuedPlanes,
                                       queue_path, queued_planes, vec_cells)
from repro_torch.core.program import dtype_bytes
from repro_torch.kernels import streamed

#: In-plane tile candidates: x a multiple of 8 (a strip's 4-cell reads
#: need x origins on 4-cell boundaries), y only in 3D.
QUEUED_TX = tuple(range(32, 1025, 8))
QUEUED_TY = (1, 2, 4, 6, 8, 10, 12, 14, 16, 20, 24, 32)
#: Work items a launch aims for before segments shorten: about eight
#: waves of two CTAs per SM on 132 SMs, so that the last wave's tail
#: stays a few percent (the ``2h`` planes each segment loads twice cost
#: less: 2D r4 at tile (992,), segments of 128 rows against 269 took 6%
#: less time in ``tools/streamed_tile_sweep.py`` on an H100 80GB HBM3 at
#: 700 W).
TARGET_ITEMS = 2048
#: What one bulk row copy costs beside its cells, in cells, for the tile
#: pick, fitted to ``tools/streamed_tile_sweep.py`` on an H100 80GB HBM3 at
#: 700 W: at 3d_r4_paper B1 and B6 ran fastest at (12, 64) and (10, 96),
#: 20 and 18 rows a plane, against (20, 40), 28 rows, whose cell cost is
#: 5% lower.
ROW_COPY_CELLS = 64
#: Shared memory the card keeps back per CTA (the second CTA on an SM
#: needs twice this beside its planes).
CTA_RESERVED = 1024


def x_shift(src_off_x: int, halo_x: int, itemsize: int = 4) -> int:
    """Shared column of stage-0 column 0: ``A..2A-1`` for ``A`` the cells
    of 16 bytes (4..7 in float32, 8..15 in 16 bits), so that a row's
    source cells and its shared cells have the same 16-byte alignment."""
    a = vec_cells(itemsize)
    return a + (src_off_x - halo_x) % a


@dataclasses.dataclass(frozen=True)
class QueuedGeometry:
    """One launch of ``csrc/queued_superstep.cu`` in (streamed, y, x)
    axes.  ``src_off``/``dst_off`` are the source/output index of local
    coordinate 0; ``origin`` its global coordinate (the shard offsets:
    the boundary acts outside ``[0, true)`` in global coordinates).
    ``carry`` marks the padded carry (the t = 0 boundary applied on load),
    ``persistent`` a grid of resident CTAs that walk the work items;
    ``itemsize`` is the grid's bytes per cell (the library it runs)."""

    ndim: int
    steps: int
    radius: int
    true: Tuple[int, int, int]
    src: Tuple[int, int, int]
    src_off: Tuple[int, int, int]
    dst: Tuple[int, int, int]
    dst_off: Tuple[int, int, int]
    written: Tuple[int, int, int]
    origin: Tuple[int, int, int]
    tile: Tuple[int, int]
    segment: int
    batch: int
    carry: bool
    persistent: bool
    itemsize: int = 4

    @property
    def sharded(self) -> bool:
        """A mesh shard's carry (origin or global extent not the local
        ones): the sharded instantiation, which maps the t = 0 boundary on
        load at global coordinates; a single device's carry keeps the one
        that maps it at local coordinates."""
        return self.carry and (any(self.origin)
                               or self.true != self.written)

    @property
    def radii(self) -> Tuple[int, int, int]:
        r = self.radius
        return (r, 0 if self.ndim == 2 else r, r)

    @property
    def halo(self) -> Tuple[int, int, int]:
        return tuple(self.steps * r for r in self.radii)

    @property
    def planes(self) -> QueuedPlanes:
        in_plane = (self.tile[1],) if self.ndim == 2 else self.tile
        return QueuedPlanes(ndim=self.ndim, radius=self.radius,
                            steps=self.steps, tile=in_plane,
                            itemsize=self.itemsize)

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one CTA (the launcher refuses a
        geometry whose own count differs)."""
        return self.planes.bytes()

    @property
    def pad(self) -> int:
        return x_shift(self.src_off[2], self.halo[2], self.itemsize)

    @property
    def strips(self) -> Tuple[int, int, int]:
        """(rows, strips per row, first strip) of the threads."""
        return self.planes.strips(self.pad)

    @property
    def segments(self) -> int:
        return -(-self.written[0] // self.segment)

    @property
    def tiles(self) -> Tuple[int, int]:
        return (-(-self.written[1] // self.tile[0]),
                -(-self.written[2] // self.tile[1]))

    @property
    def total(self) -> int:
        """Work items: batch x segments x column tiles."""
        return self.batch * self.segments * math.prod(self.tiles)

    def segment_bounds(self, k: int) -> Tuple[int, int]:
        a = k * self.segment
        return a, min(a + self.segment, self.written[0])

    def array(self) -> List[int]:
        """The host geometry array of ``queued_superstep.cu:Field``."""
        planes = self.planes
        rows = (self.true, self.src, self.src_off, self.dst, self.dst_off,
                self.written, self.origin, self.radii,
                (self.segment, self.tile[0], self.tile[1]),
                (self.steps, planes.group, planes.ahead),
                (int(self.carry), int(self.persistent), int(self.sharded)),
                (planes.bytes(), 0, 0))
        return [int(v) for row in rows for v in row]


def _candidates(ndim: int):
    return [(tx,) for tx in QUEUED_TX] if ndim == 2 else \
        list(itertools.product(QUEUED_TY, QUEUED_TX))


@functools.lru_cache(maxsize=None)
def _fits(ndim, radius, steps, smem_limit, itemsize):
    planes = [QueuedPlanes(ndim=ndim, radius=radius, steps=steps, tile=t,
                           itemsize=itemsize)
              for t in _candidates(ndim)]
    usable = [p for p in planes if p.threads_fit]
    return usable, [p for p in usable if p.bytes() <= smem_limit]


def smallest_queued_tile(program, steps: int) -> Tuple[int, ...]:
    """The usable candidate with the least shared memory."""
    usable, _ = _fits(program.ndim, program.halo_radius, steps, 1 << 62,
                      dtype_bytes(program.dtype))
    return min(usable, key=lambda p: p.bytes()).tile


@functools.lru_cache(maxsize=None)
def pick_queued_tile(program, steps: int,
                     smem_limit: int) -> Tuple[int, ...]:
    """In-plane column tile: the least ``QueuedPlanes.cost`` plus
    :data:`ROW_COPY_CELLS` per loaded row over the tile's cells (then the
    widest x) among the candidates whose threads cover the stage-1 region
    and whose shared memory leaves room for two CTAs per SM; if none
    does, among those that fit ``smem_limit``.  The register budget
    (``__launch_bounds__(256, 2)``) allows two CTAs per SM, so a tile that
    allows only one halves the warps that hide the copies and barriers."""
    nd, r = program.ndim, program.halo_radius
    _, fits = _fits(nd, r, steps, smem_limit, dtype_bytes(program.dtype))
    if not fits:
        small = smallest_queued_tile(program, steps)
        need = queued_planes(program, steps, small).bytes()
        raise ValueError(
            f"no CTA tile fits: the smallest queued column tile, {small}, "
            f"needs {need} bytes of shared memory for {steps} fused steps "
            f"of radius {r}, the card allows {smem_limit}")
    two = [p for p in fits if p.bytes() <= smem_limit // 2 - CTA_RESERVED]

    def cost(p):
        rows = p.extent[0] * ROW_COPY_CELLS / math.prod(p.tile)
        return (p.cost + rows, -p.tile[-1])

    best = min(two or fits, key=cost)
    return best.tile


def _geometry(program, steps, *, true, src, src_off, dst, dst_off, written,
              origin, batch, smem_limit, tile, segment, carry, persistent
              ) -> QueuedGeometry:
    nd = program.ndim
    if not queue_path(program, steps):
        raise ValueError(f"a {program.shape} of radius {program.radius} at "
                         f"{steps} steps has no register-queue form: it "
                         f"runs on the streamed kernel")
    if tile is None:
        tile = pick_queued_tile(program, steps, smem_limit)
    tile = tuple(int(t) for t in tile)
    if len(tile) != nd - 1 or min(tile) < 1 or tile[-1] % 4:
        raise ValueError(f"a queued {nd}D column tile has {nd - 1} "
                         f"positive extents, x a multiple of 4 (got {tile})")
    tile2 = (1, tile[0]) if nd == 2 else tile
    columns = batch * (-(-written[1] // tile2[0])) * \
        (-(-written[2] // tile2[1]))
    if segment is None:
        segment = streamed.segment_length(
            written[0], columns, steps * program.halo_radius, TARGET_ITEMS)
    if segment < 1:
        raise ValueError(f"segment must be >= 1 (got {segment})")
    geo = QueuedGeometry(
        ndim=nd, steps=steps, radius=program.halo_radius, true=true, src=src,
        src_off=src_off, dst=dst, dst_off=dst_off, written=written,
        origin=origin, tile=tile2, segment=int(segment), batch=batch,
        carry=carry, persistent=persistent,
        itemsize=dtype_bytes(program.dtype))
    rows, nx, _ = geo.strips
    if rows * nx > QUEUE_THREADS:
        raise ValueError(f"column tile {tile} needs {rows * nx} strips, a "
                         f"queued CTA has {QUEUE_THREADS} threads")
    return geo


@functools.lru_cache(maxsize=256)
def carry_geometry(program, steps: int, layout, *, batch: int,
                   smem_limit: int, tile: Optional[Tuple[int, ...]] = None,
                   segment: Optional[int] = None,
                   origin: Optional[Tuple[int, ...]] = None,
                   true_shape: Optional[Tuple[int, ...]] = None
                   ) -> QueuedGeometry:
    """B1: ``steps`` fused steps of the padded carry ``layout``
    (``common.PaddedLayout``), read at ring offset ``H - h`` and written
    into the other carry buffer at ``H``, true cells only, on the register
    queues; a one-shot grid (persistent CTAs measured slower,
    ``PERF.md``).  ``origin`` and ``true_shape`` place a mesh shard in the
    global grid (:attr:`QueuedGeometry.sharded`); the tile and segment
    picks read the local extent."""
    nd = program.ndim
    h = steps * program.halo_radius
    H = layout.halo
    if h > H:
        raise ValueError(f"a {steps}-step window needs a ring of {h}, the "
                         f"layout has {H}")
    o3, true = streamed.shard_rows(nd, layout, origin, true_shape)
    n = streamed.axes3(nd, layout.local_shape)
    P = streamed.axes3(nd, layout.padded_shape)
    off = (H, 0, H) if nd == 2 else (H, H, H)
    return _geometry(program, steps, true=true, src=P, src_off=off, dst=P,
                     dst_off=off, written=n, origin=o3, batch=batch,
                     smem_limit=smem_limit, tile=tile, segment=segment,
                     carry=True, persistent=False)


@functools.lru_cache(maxsize=256)
def prepadded_geometry(program, steps: int, spatial: Sequence[int],
                       true_shape: Sequence[int],
                       offsets: Sequence[int], *, batch: int,
                       smem_limit: int, persistent: bool,
                       tile: Optional[Tuple[int, ...]] = None,
                       segment: Optional[int] = None) -> QueuedGeometry:
    """B5 (one-shot grid) and B6 (``persistent``): ``steps`` fused steps
    of a grid ``boundary_pad`` padded by ``h`` (``spatial`` its padded
    extent), written into a separate grid of the rounded extent, every
    cell; ``offsets`` is the shard origin in the global ``true_shape``."""
    nd = program.ndim
    h = steps * program.halo_radius
    rounded = tuple(int(s) - 2 * h for s in spatial)
    if any(s < 1 for s in rounded):
        raise ValueError(f"padded grid {tuple(spatial)} is not larger than "
                         f"twice the halo {h}")
    if len(offsets) != nd or min(offsets) < 0:
        raise ValueError(f"shard offsets {tuple(offsets)} are {nd} "
                         f"coordinates >= 0")
    R = streamed.axes3(nd, rounded)
    off = (h, 0, h) if nd == 2 else (h, h, h)
    return _geometry(program, steps, true=streamed.axes3(nd, true_shape),
                     src=streamed.axes3(nd, spatial), src_off=off, dst=R,
                     dst_off=(0, 0, 0), written=R,
                     origin=tuple(offsets) if nd == 3 else
                     (offsets[0], 0, offsets[1]), batch=batch,
                     smem_limit=smem_limit, tile=tile, segment=segment,
                     carry=False, persistent=persistent)
