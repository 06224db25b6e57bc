"""Geometry of the streamed superstep kernels (``csrc/streamed_superstep.cu``).

B3 (``temporal_superstep``) and B4 (``padded_pipelined``), and B1 for tap
sets without register queues, advance the padded carry by ``T`` fused
steps without holding a whole halo'd window (:func:`carry_geometry`); B5
and B6 run the same tap sets on a grid ``boundary_pad`` already padded
(:func:`prepadded_geometry`).
Axes are (streamed, y, x): a 3D grid streams along z and blocks (y, x); a
2D grid streams along y and blocks x (its y slot is a dummy of extent 1
and radius 0).  One CTA owns

* a column tile of ``tile`` in-plane output cells (``(1, tx)`` in 2D,
  ``(ty, tx)`` in 3D, ragged at the grid's end), and
* a segment ``[a, e)`` of at most ``segment`` output planes along the
  streamed axis (the last one ragged),

and walks the segment plane group by plane group.  Stage 0 loads planes
``[a - h, e + h)`` of the source (``h = T*r``); stage ``s`` computes planes
``[a - (T-s)*r, e + (T-s)*r)`` over an in-plane region that shrinks by
``r`` per side per stage, and stage ``T`` writes ``[a, e)`` into the
output.  Neighbouring segments overlap by ``h`` on each side and share
nothing.  Everything here is host arithmetic, so the CPU tests check it.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import List, Optional, Tuple

from repro_torch.core.blocking import (StreamedRings, streamed_rings,
                                       streamed_smem_bytes)
from repro_torch.core.program import dtype_bytes

#: In-plane column-tile candidates: x (contiguous) a multiple of 32 so a
#: warp reads whole 128-byte rows; y only in 3D.
STREAMED_TX = tuple(range(32, 1025, 32))
STREAMED_TY = (1, 2, 4, 8, 16, 32)
#: Work items (column tiles x segments x batch) a launch aims for before
#: the segments get shorter than the whole streamed extent.
TARGET_ITEMS = 2048
#: Tap sets the kernel has fixed-offset instantiations for, by the code
#: of ``streamed_superstep.cu:Shape``: (shape, ndim) -> largest radius.
FIXED_TAPS = {("star", 2): 4, ("star", 3): 4, ("box", 2): 2, ("box", 3): 1}
SHAPE_CODES = {"star": 1, "box": 2}
#: Threads of one streamed CTA: a 2D pass gives each a column.
THREADS = 256


def axes3(ndim: int, values) -> Tuple[int, int, int]:
    """(streamed, y, x) of per-axis grid ``values``: a 2D grid's y slot
    is 1."""
    v = tuple(int(x) for x in values)
    return (v[0], 1, v[1]) if ndim == 2 else v


@dataclasses.dataclass(frozen=True)
class StreamedGeometry:
    """One streamed launch, in (streamed, y, x) axes.  ``src_off`` /
    ``dst_off`` are the source/output index of local coordinate 0 (the
    ring depth ``H`` of the carry; ``h`` and 0 pre-padded), ``origin`` its
    global coordinate (the shard offsets: the boundary acts outside
    ``[0, true)`` in global coordinates; 0 for the carry).  ``fixed`` is
    the code of a tap set the kernel takes at fixed offsets with
    coefficients in registers (:data:`FIXED_TAPS`), or 0 for the
    offset-table path.  ``prepadded`` loads the source as it is, without
    the carry's t = 0 boundary mapping.  ``itemsize`` is the grid's bytes
    per cell (the library it runs)."""

    ndim: int
    steps: int
    radius: int
    true: Tuple[int, int, int]
    src: Tuple[int, int, int]
    src_off: Tuple[int, int, int]
    dst: Tuple[int, int, int]
    dst_off: Tuple[int, int, int]
    written: Tuple[int, int, int]
    tile: Tuple[int, int]
    segment: int
    batch: int
    ntaps: int
    fixed: int = 0
    origin: Tuple[int, int, int] = (0, 0, 0)
    prepadded: bool = False
    itemsize: int = 4

    @property
    def sharded(self) -> bool:
        """A mesh shard's carry (origin or global extent not the local
        ones): the kernel's sharded instantiation, which maps the t = 0
        boundary at global coordinates.  A single device's carry keeps the
        instantiation whose origin is 0 at compile time."""
        return not self.prepadded and (any(self.origin)
                                       or self.true != self.written)

    @property
    def radii(self) -> Tuple[int, int, int]:
        """Shrink per stage on each axis (0 on a 2D grid's dummy y)."""
        r = self.radius
        return (r, 0 if self.ndim == 2 else r, r)

    @property
    def halo(self) -> Tuple[int, int, int]:
        return tuple(self.steps * r for r in self.radii)

    @property
    def rings(self) -> StreamedRings:
        in_plane = (self.tile[1],) if self.ndim == 2 else self.tile
        return streamed_rings(self.ndim, self.radius, self.steps, in_plane,
                              self.itemsize)

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one CTA: the rings, their tap-offset
        tables and the coefficients (the launcher refuses a geometry whose
        own count differs)."""
        return self.rings.bytes(self.ntaps)

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

    def stage_planes(self, a: int, e: int, s: int) -> Tuple[int, int]:
        """Planes ``[lo, hi)`` stage ``s`` (0 = loaded, ``steps`` = the
        output) holds for the segment ``[a, e)``."""
        grow = (self.steps - s) * self.radius
        return a - grow, e + grow

    def stage_extent(self, s: int) -> Tuple[int, int]:
        """In-plane extent of stage ``s``'s region: the stage-0 plane less
        ``r`` per side per stage (stage ``steps``: the column tile)."""
        plane = self.rings.plane
        _, ry, rx = self.radii
        return plane[0] - 2 * s * ry, plane[1] - 2 * s * rx

    def iterations(self, a: int, e: int) -> int:
        """Plane groups a CTA walks for segment ``[a, e)``: stage ``s``
        emits group ``i``'s planes ``[a - h + i*B - s*r, ... + B)``, so the
        output's last plane ``e - 1`` is due after this many groups."""
        return -(-(e - a + 2 * self.halo[0]) // self.rings.group)

    def array(self) -> List[int]:
        """The host geometry array of ``streamed_superstep.cu:Field``."""
        rows = (self.true, self.src, self.src_off, self.dst, self.dst_off,
                self.written, self.origin, self.radii,
                (self.segment, self.tile[0], self.tile[1]),
                (self.rings.group, self.steps, self.smem_bytes),
                (self.fixed, int(self.prepadded), int(self.sharded)))
        return [int(v) for row in rows for v in row]


def column_cost(ndim: int, radius: int, steps: int,
                tile: Tuple[int, ...]) -> float:
    """Cells loaded and computed per output cell, summed over the stages:
    each stage's in-plane region over the column tile's cells.  A 2D
    stage computes in passes of :data:`THREADS` columns, so its region
    counts rounded up to whole passes."""
    h = steps * radius
    total = 0
    for s in range(steps + 1):
        grow = 2 * (h - s * radius)
        cells = math.prod(t + grow for t in tile)
        if ndim == 2 and s > 0:
            cells = -(-cells // THREADS) * THREADS
        total += cells
    return total / math.prod(tile)


def _candidates(ndim: int):
    return [(tx,) for tx in STREAMED_TX] if ndim == 2 else \
        list(itertools.product(STREAMED_TY, STREAMED_TX))


def streamed_need(program, steps: int, tile: Tuple[int, ...]) -> int:
    """Shared memory of one streamed CTA at in-plane tile ``tile``."""
    return streamed_smem_bytes(program.ndim, program.halo_radius,
                               program.num_taps, steps, tile,
                               dtype_bytes(program.dtype))


@functools.lru_cache(maxsize=None)
def smallest_streamed_tile(program, steps: int) -> Tuple[int, ...]:
    """The in-plane candidate with the least shared memory (not always
    the narrowest: a narrow plane groups more planes per iteration)."""
    return min(_candidates(program.ndim),
               key=lambda t: streamed_need(program, steps, t))


@functools.lru_cache(maxsize=None)
def pick_streamed_tile(program, steps: int,
                       smem_limit: int) -> Tuple[int, ...]:
    """In-plane column tile of a streamed launch: the least
    :func:`column_cost` (then the widest x) among the candidates whose
    rings fit ``smem_limit``.  Raises when none fits, which is when
    :func:`smallest_streamed_tile` does not."""
    nd, r = program.ndim, program.halo_radius
    fits = [t for t in _candidates(nd)
            if streamed_need(program, steps, t) <= smem_limit]
    if not fits:
        small = smallest_streamed_tile(program, steps)
        raise ValueError(
            f"no CTA tile fits: the smallest streamed column tile, {small}, "
            f"needs {streamed_need(program, steps, small)} bytes of "
            f"shared memory for {steps} fused steps of radius {r} ({steps} "
            f"plane rings), the card allows {smem_limit}")
    return min(fits, key=lambda t: (column_cost(nd, r, steps, t), -t[-1]))


def segment_length(planes: int, columns: int, halo: int,
                   target: int = TARGET_ITEMS) -> int:
    """Output planes per segment: the whole streamed extent when the
    column tiles alone give ``target`` work items, else short enough to
    reach it, but not below ``2*halo`` (the overlap each segment pays
    twice)."""
    segs = max(1, -(-target // max(1, columns)))
    length = -(-planes // segs)
    return max(1, min(planes, max(length, 2 * halo)))


def _geometry(program, steps, *, true, src, src_off, dst, dst_off,
              written, origin, batch, smem_limit, tile, segment,
              prepadded) -> StreamedGeometry:
    nd = program.ndim
    if tile is None:
        tile = pick_streamed_tile(program, steps, smem_limit)
    tile = tuple(int(t) for t in tile)
    if len(tile) != nd - 1 or min(tile) < 1:
        raise ValueError(f"a streamed {nd}D column tile has {nd - 1} "
                         f"positive extents (got {tile})")
    tile2 = (1, tile[0]) if nd == 2 else tile
    columns = batch * (-(-written[1] // tile2[0])) * \
        (-(-written[2] // tile2[1]))
    if segment is None:
        segment = segment_length(written[0], columns,
                                 steps * program.halo_radius)
    if segment < 1:
        raise ValueError(f"segment must be >= 1 (got {segment})")
    return StreamedGeometry(
        ndim=nd, steps=steps, radius=program.halo_radius, true=true,
        src=src, src_off=src_off, dst=dst, dst_off=dst_off, written=written,
        tile=tile2, segment=int(segment), batch=batch,
        ntaps=program.num_taps, fixed=fixed_code(program), origin=origin,
        prepadded=prepadded, itemsize=dtype_bytes(program.dtype))


def shard_rows(nd: int, layout, origin, true_shape):
    """``(origin, true)`` rows of a carry in (streamed, y, x) axes: a mesh
    shard's origin and the global extent, or 0 and the local extent on
    one device.  Raises where they do not place the local extent inside
    the global grid."""
    true = layout.local_shape if true_shape is None else tuple(true_shape)
    offs = (0,) * nd if origin is None else tuple(int(o) for o in origin)
    if len(offs) != nd or len(true) != nd or any(
            o < 0 or o + n > t
            for o, n, t in zip(offs, layout.local_shape, true)):
        raise ValueError(f"shard origin {offs} does not place the local "
                         f"extent {layout.local_shape} inside the global "
                         f"grid {true}")
    o3 = (offs[0], 0, offs[1]) if nd == 2 else offs
    return o3, axes3(nd, true)


@functools.lru_cache(maxsize=256)
def carry_geometry(program, steps: int, layout, *, batch: int,
                   smem_limit: int,
                   tile: Optional[Tuple[int, ...]] = None,
                   segment: Optional[int] = None,
                   origin: Optional[Tuple[int, ...]] = None,
                   true_shape: Optional[Tuple[int, ...]] = None
                   ) -> StreamedGeometry:
    """The geometry of a streamed superstep of the padded carry ``layout``
    (``common.PaddedLayout``): ``steps`` fused steps read at ring offset
    ``H`` and written into the other carry buffer at ``H``, true cells
    only.  ``tile`` (in-plane, as :func:`pick_streamed_tile` returns it)
    and ``segment`` override the picks, which read the local extent.
    ``origin`` and ``true_shape`` place a mesh shard in the global grid
    (:attr:`StreamedGeometry.sharded`)."""
    nd = program.ndim
    H = layout.halo
    if steps * program.halo_radius > H:
        raise ValueError(f"a {steps}-step window needs a ring of "
                         f"{steps * program.halo_radius}, the layout has {H}")
    o3, true = shard_rows(nd, layout, origin, true_shape)
    n = axes3(nd, layout.local_shape)
    P = axes3(nd, layout.padded_shape)
    off = (H, 0, H) if nd == 2 else (H, H, H)
    return _geometry(program, steps, true=true, src=P, src_off=off, dst=P,
                     dst_off=off, written=n, origin=o3, batch=batch,
                     smem_limit=smem_limit, tile=tile, segment=segment,
                     prepadded=False)


@functools.lru_cache(maxsize=256)
def prepadded_geometry(program, steps: int, spatial: Tuple[int, ...],
                       true_shape: Tuple[int, ...], offsets: Tuple[int, ...],
                       *, batch: int, smem_limit: int,
                       tile: Optional[Tuple[int, ...]] = None,
                       segment: Optional[int] = None) -> StreamedGeometry:
    """B5 and B6 for tap sets without register queues: ``steps`` fused
    steps of a grid ``boundary_pad`` padded by ``h`` (``spatial`` its
    padded extent), copied as it is, written into a separate grid of the
    rounded extent, every cell; ``offsets`` is the shard origin in the
    global ``true_shape`` (fixups between steps act outside it)."""
    nd = program.ndim
    h = steps * program.halo_radius
    rounded = tuple(int(s) - 2 * h for s in spatial)
    if any(s < 1 for s in rounded):
        raise ValueError(f"padded grid {tuple(spatial)} is not larger than "
                         f"twice the halo {h}")
    if len(offsets) != nd or min(offsets) < 0:
        raise ValueError(f"shard offsets {tuple(offsets)} are {nd} "
                         f"coordinates >= 0")
    R = axes3(nd, rounded)
    return _geometry(program, steps, true=axes3(nd, true_shape),
                     src=axes3(nd, spatial),
                     src_off=(h, 0, h) if nd == 2 else (h, h, h), dst=R,
                     dst_off=(0, 0, 0), written=R,
                     origin=(offsets[0], 0, offsets[1]) if nd == 2
                     else tuple(offsets), batch=batch,
                     smem_limit=smem_limit, tile=tile, segment=segment,
                     prepadded=True)


def fixed_code(program) -> int:
    """The kernel's fixed tap-set code for ``program``, or 0."""
    top = FIXED_TAPS.get((program.shape, program.ndim), 0)
    return SHAPE_CODES[program.shape] if program.radius <= top else 0


def streamed_taps(program) -> List[Tuple[int, int, int]]:
    """``((0,0,0),) + neighbor_taps`` as (streamed, y, x) rows: a 2D tap
    (dy, dx) becomes (dy, 0, dx)."""
    rows = [(0, 0, 0)]
    for o in program.neighbor_taps:
        rows.append((o[0], 0, o[1]) if program.ndim == 2 else tuple(o))
    return rows
