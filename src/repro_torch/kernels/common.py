"""The padded-carry fused executor — counterpart of ``repro/kernels/common.py``.

The run keeps its carry in halo-extended (padded) layout: a ping-pong pair
of buffers, each superstep reading halo'd windows from one and writing the
advanced interior into the other.  The boundary ring is healed by
O(surface) work: a t=0 ``boundary_fixup`` of every loaded window for
clamp/constant, a wrap refresh of the source's ring for periodic.

The kernels of a superstep, each with a plain PyTorch version here:

* ``padded_superstep`` (reference ``build_padded_superstep_kernel``; with
  ``variant="temporal"`` ``build_temporal_kernel``, with "pipelined"
  ``build_padded_pipelined_kernel``): window load at ring offset ``H - h``,
  t=0 fixup, ``par_time`` tap updates over a shrinking region with fixups
  between, tile write.  All three share ``padded_superstep_plain``; on the
  card they stream planes through the window instead of holding it
  (``csrc/queued_superstep.cu``, ``csrc/streamed_superstep.cu``).
* ``refresh_wrap_halo`` (reference ``_refresh_wrap_halo``): same-buffer
  periodic ring copies following ``wrap_copies``, axis by axis (on the
  card their composition, every wrap axis in one launch).
* ``superstep_call`` (reference ``build_superstep_kernel``, with
  "pipelined" ``build_pipelined_kernel``): the pre-padded superstep over
  a grid ``boundary_pad`` already padded, returning the rounded grid.
  Plain version ``superstep_plain``.

Each dispatches on where the tensor lies: a CUDA tensor launches the
hand-written kernel (``kernels/cuda.py``), a CPU tensor takes the plain
version, and any other device raises.  Each runs inside a
``launch.<key>`` span (``repro_torch.obs``), the key the kernel's in
``cuda.KERNELS``, on the card and on the CPU alike; inside it a superstep
launch opens ``superstep.steps.<T>``, T the steps it fuses, and its cell
updates count as ``superstep.cell_steps``.  ``run_call``'s pad-in,
superstep loop and slice-out run inside ``run_call.pad_in``,
``run_call.supersteps`` and ``run_call.slice_out``, and the bytes they
move count as ``run_call.copy_bytes``.

A grid is float32, bfloat16 or float16 (the program's ``dtype``), and so
is the carry.  The coefficients are cast to the grid's dtype at each
entry (:func:`grid_coeffs`), as the reference's kernels cast them
(``repro/kernels/common.py:336-337``, ``:968-969``): a 16-bit grid's plain
version then rounds after every multiply and add on exactly the values
the kernel's coefficient bank holds.

On a mesh (``core/distributed.py``) each shard keeps such a carry of its
local extent; ``ring_schedule(decomp=)`` records the exchange strips of
:func:`exchange_copies` beside the wrap copies, and ``padded_superstep``
takes the shard's ``offsets`` and the ``global_shape``, so that the
fixups act only outside the global grid (the sharded instantiations of
B1 and B4 on the card).

Cells of the round-up slack ``[H+n, H+rounded)`` never feed a true cell:
clamp/constant fixups overwrite window positions >= n, and the periodic
refresh rewrites ``[H+n, P)`` before every superstep.  So what a superstep
leaves there is unspecified (the CUDA kernel computes only true cells, the
plain version the whole rounded grid), and results compare on the true
interior, plus the refreshed ring for periodic.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import math
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.core.blocking import (CARRY_KERNELS, BlockPlan,
                                       TEMPORAL_CHUNK, normalize_variant,
                                       round_up)
from repro_torch.core.codegen import boundary_pad, tap_interior_update
from repro_torch.core.program import ProgramCoeffs, StencilProgram
from repro_torch.kernels import build, cuda, queued, streamed


# ---- what a warm run must never redo (RP203) ------------------------------------

_TRACE_COUNTS: Dict[str, int] = collections.Counter()
#: The derived counters' readings at the last :func:`reset_trace_counts`.
_TRACE_BASE: Dict[str, int] = {}
_TRACE_LOCK = threading.Lock()


def note_trace(name: str) -> None:
    """Count one resolution that a warm run must not repeat (the
    executor's ``plan_resolutions``)."""
    with _TRACE_LOCK:
        _TRACE_COUNTS[name] += 1


def _misses(*cached) -> int:
    return sum(fn.cache_info().misses for fn in cached)


def _derived_counts() -> Dict[str, int]:
    """The counters read off the build and the geometry caches."""
    return dict(
        library_builds=build.COUNTS["builds"],
        library_loads=build.COUNTS["loads"],
        wrap_geometry=_misses(cuda.wrap_boxes, cuda._wrap_launch),
        queued_geometry=_misses(queued.carry_geometry,
                                queued.prepadded_geometry),
        streamed_geometry=_misses(streamed.carry_geometry,
                                  streamed.prepadded_geometry))


def trace_counts() -> Dict[str, int]:
    """The port's counterpart of the reference's retrace counters: what a
    warm run of a compiled executable must never do again, counted since
    the last :func:`reset_trace_counts`.

    library_builds, library_loads  ``nvcc`` runs and ``ctypes`` loads
                                   (``kernels/build.py``);
    wrap_geometry                  misses of ``cuda.wrap_boxes`` and of the
                                   cached wrap-launch rows on the device;
    queued_geometry,               misses of the queued and streamed
    streamed_geometry              launch-geometry caches;
    plan_resolutions               the executor's plan resolutions (one per
                                   ``compile``).
    """
    with _TRACE_LOCK:
        counts = dict(_TRACE_COUNTS)
        counts.update({k: v - _TRACE_BASE.get(k, 0)
                       for k, v in _derived_counts().items()})
    counts.setdefault("plan_resolutions", 0)
    return counts


def trace_count(name: str) -> int:
    """One counter of :func:`trace_counts` (0 for a name never counted).

    The reference's ``trace_count("run_call")`` counts the executables a
    run built: a warm run of a compiled executable adds none.  The port
    builds no executable per run; what a run resolves anew is its launch
    geometry, so ``queued_geometry``, ``streamed_geometry`` and
    ``wrap_geometry`` answer that question: a warm run adds to none of
    them (nor to ``library_builds``/``library_loads``), while a run on
    the card adds one miss for each launch geometry (superstep depth,
    layout, batch) that no run has resolved before, as a new remainder or
    batch rank does.  On the CPU the plain versions resolve no geometry,
    so every counter but ``plan_resolutions`` stays 0 there.
    """
    return trace_counts().get(name, 0)


def reset_trace_counts() -> None:
    """Zero every counter of :func:`trace_counts`.  The counters read off
    the build and the geometry caches keep a baseline instead: a reset
    clears no cache and forces no rebuild."""
    with _TRACE_LOCK:
        _TRACE_COUNTS.clear()
        _TRACE_BASE.clear()
        _TRACE_BASE.update(_derived_counts())


def trace_delta(before: Dict[str, int]) -> Dict[str, int]:
    """The counters of :func:`trace_counts` that moved since ``before``
    (a ``trace_counts()`` snapshot), by how much;
    ``repro_torch.lint.check_trace_budget`` turns a non-zero warm delta
    into RP203."""
    after = trace_counts()
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def _audit_plain(name: str, src: torch.Tensor,
                 dst: Optional[torch.Tensor],
                 *operands: torch.Tensor) -> None:
    """Record a plain version's launch in the launch audit when it is on
    (``lint/artifact.record_launches``), under the kernel's name."""
    if cuda.AUDIT is not None:
        cuda.AUDIT.launch(name, src=src, dst=dst, operands=operands,
                          route="plain")


def grid_coeffs(center: torch.Tensor, taps: torch.Tensor,
                grid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``center`` and ``taps`` in ``grid``'s dtype on its device.  Torch
    takes a 0-dim tensor as a scalar at its own precision, so without the
    cast a float32 coefficient would multiply a 16-bit grid unrounded."""
    return (center.to(grid.device, grid.dtype),
            taps.to(grid.device, grid.dtype))


def batch_dims(program: StencilProgram, grid_ndim: int) -> int:
    """Number of leading batch axes on a grid: 0 (unbatched) or 1."""
    nb = grid_ndim - program.ndim
    if nb not in (0, 1):
        raise ValueError(
            f"grid rank {grid_ndim} does not match a {program.ndim}-D "
            f"program (expected {program.ndim} or {program.ndim + 1} with "
            f"a batch axis)")
    return nb


def boundary_fixup(program: StencilProgram, cur: torch.Tensor,
                   starts: Sequence[int],
                   true_shape: Tuple[int, ...]) -> torch.Tensor:
    """Restore boundary semantics on out-of-grid positions of a window.

    ``starts[d]`` is the global coordinate of ``cur``'s origin along
    spatial axis d (the last ``program.ndim`` axes).  clamp copies the
    border slab, axis by axis in increasing d, each axis reading the
    already-fixed result (so corners take the corner cell); constant fills
    ``boundary_value``; periodic is a no-op (the wrapped halo evolves under
    the same update as the grid).
    """
    if program.boundary == "periodic":
        return cur
    nb = cur.ndim - program.ndim
    for d in range(program.ndim):
        ax = nb + d
        size = cur.shape[ax]
        n = true_shape[d]
        if starts[d] >= 0 and starts[d] + size <= n:
            continue                       # window inside the grid
        shape = [1] * cur.ndim
        shape[ax] = size
        pos = (starts[d] + torch.arange(size, device=cur.device)).reshape(
            shape)
        if program.boundary == "constant":
            cur = torch.where((pos < 0) | (pos > n - 1),
                              program.boundary_value, cur)
            continue
        left = cur.narrow(ax, min(max(-starts[d], 0), size - 1), 1)
        right = cur.narrow(ax, min(max(n - 1 - starts[d], 0), size - 1), 1)
        cur = torch.where(pos < 0, left, cur)
        cur = torch.where(pos > n - 1, right, cur)
    return cur


def _fused_steps(program: StencilProgram, coeffs: ProgramCoeffs,
                 cur: torch.Tensor, starts: Sequence[int],
                 true_shape: Tuple[int, ...], steps: int) -> torch.Tensor:
    """``steps`` tap updates over a shrinking window whose origin sits at
    global ``starts``, with boundary fixups between the steps."""
    r = program.halo_radius
    for t in range(1, steps + 1):
        cur = tap_interior_update(program, coeffs, cur)
        if t < steps:
            cur = boundary_fixup(program, cur, [s + t * r for s in starts],
                                 true_shape)
    return cur


# ---- padded layout and ring schedule -----------------------------------------


@dataclasses.dataclass(frozen=True)
class PaddedLayout:
    """Geometry of the persistent halo-extended carry buffer.

    Each spatial axis is rounded up to a block multiple and extended by the
    ring depth ``halo`` (H) on both sides.  ``wrap_axes`` lists the axes
    whose ring a periodic refresh rewrites before every superstep.
    """

    halo: int
    local_shape: Tuple[int, ...]
    rounded: Tuple[int, ...]
    wrap_axes: Tuple[int, ...] = ()

    @property
    def padded_shape(self) -> Tuple[int, ...]:
        return tuple(r + 2 * self.halo for r in self.rounded)

    def wrap_degenerate(self) -> bool:
        """True when a wrap axis is too small for one-lap ring copies: the
        lo ring copies ``halo`` true cells and the hi region
        ``rounded - n + halo``; either exceeding ``n`` needs the re-pad
        fallback."""
        for d in self.wrap_axes:
            n = self.local_shape[d]
            if self.halo > n or self.rounded[d] - n + self.halo > n:
                return True
        return False


@dataclasses.dataclass(frozen=True)
class RingCopy:
    """One O(surface) halo copy along ``axis`` in padded coordinates;
    ``src``/``dst`` are half-open intervals, every other axis spans its
    full padded extent."""

    kind: str
    axis: int
    src: Tuple[int, int]
    dst: Tuple[int, int]

    @property
    def width(self) -> int:
        return self.dst[1] - self.dst[0]


def wrap_copies(layout: PaddedLayout) -> Tuple[RingCopy, ...]:
    """The periodic refresh schedule: per wrap axis, in axis order, the lo
    ring ``[0, H)`` from the last H true cells ``[n, n+H)``, then the hi
    region ``[H+n, P)`` from the first ``W = P-H-n`` true cells."""
    H = layout.halo
    P = layout.padded_shape
    copies = []
    for d in layout.wrap_axes:
        n = layout.local_shape[d]
        W = P[d] - H - n
        copies.append(RingCopy("wrap", d, (n, n + H), (0, H)))
        copies.append(RingCopy("wrap", d, (H, H + W), (H + n, H + n + W)))
    return tuple(copies)


def exchange_copies(axis: int, h: int, H: int,
                    nloc: int) -> Tuple[RingCopy, RingCopy]:
    """The mesh's exchange-into-ring strips along one sharded axis: the
    left neighbour's hi strip ``[H+nloc-h, H+nloc)`` lands just below
    this shard's interior at ``[H-h, H)``, the right neighbour's lo strip
    ``[H, H+h)`` just above it at ``[H+nloc, H+nloc+h)``.  ``h`` is the
    superstep's halo (a remainder exchanges shallower strips into the same
    depth-``H`` ring); each ``src`` interval is what this shard sends."""
    return (
        RingCopy("exchange", axis, (H + nloc - h, H + nloc), (H - h, H)),
        RingCopy("exchange", axis, (H, H + h), (H + nloc, H + nloc + h)),
    )


def ping_pong_aliases(wrap: bool) -> Dict[int, int]:
    """The reference launch's ``input_output_aliases`` over operands
    ``(offsets, center, taps, src, dst)``: the tile output lives in
    ``dst`` (input 4), and a periodic launch also returns the refreshed
    ``src`` (input 3).  Kept as data: torch writes in place and donates
    nothing, but the schedule stays comparable with the reference's."""
    return {3: 0, 4: 1} if wrap else {4: 0}


def tile_output_index(wrap: bool) -> int:
    """Which output of the reference launch carries the advanced tiles."""
    return 1 if wrap else 0


@dataclasses.dataclass(frozen=True)
class SuperstepSchedule:
    """One modeled superstep: which ping-pong buffer it reads and writes,
    the ring offset ``H - h`` of its windows, its tiles and ring copies.
    Field for field the reference's record."""

    index: int
    steps: int
    halo: int
    variant: str
    read_buffer: int
    write_buffer: int
    window_offset: int
    window_shape: Tuple[int, ...]
    write_tile: Tuple[int, ...]
    write_stride: Tuple[int, ...]
    ring: Tuple[RingCopy, ...]
    ring_deferred: bool = False
    fixup: bool = False
    aliases: Tuple[Tuple[int, int], ...] = ()


@dataclasses.dataclass(frozen=True)
class RunSchedule:
    """The dataflow of one fused run: up to four full supersteps (the
    buffer pattern is 2-periodic) and the remainder, or ``fallback`` for a
    wrap-degenerate layout.  ``sharded_axes`` are the axes a mesh splits
    over more than one shard (their ring arrives by exchange)."""

    program: StencilProgram
    plan: BlockPlan
    layout: PaddedLayout
    variant: str
    steps: int
    full: int
    rem: int
    supersteps: Tuple[SuperstepSchedule, ...]
    sharded_axes: Tuple[int, ...] = ()
    fallback: bool = False


def ring_schedule(program: StencilProgram, plan: BlockPlan,
                  true_shape: Tuple[int, ...], steps: int, *,
                  variant: Optional[str] = None,
                  decomp=None) -> RunSchedule:
    """The :class:`RunSchedule` that ``run_call`` (one device) or the mesh
    (``core/distributed.DistributedStencil.run``) executes.

    ``decomp`` (shards per axis, or a ``tuning.space.MeshDecomposition``)
    gives each shard's local and rounded extent (the global one over its
    shards), wrap axes only on the device-local periodic axes, and per
    sharded axis the exchange strips of :func:`exchange_copies` in each
    superstep's ring (after the wrap copies, as the reference records
    them; the mesh exchanges first and refreshes the wrap axes after, and
    axes are independent in the proof)."""
    v = normalize_variant(variant)
    ndim = program.ndim
    chunk = TEMPORAL_CHUNK if v == "temporal" else 1
    H = chunk * plan.halo
    shards = getattr(decomp, "axis_shards", decomp)
    if shards is not None:
        local = tuple(true_shape[d] // shards[d] for d in range(ndim))
        rounded = local
        wrap_axes = tuple(d for d in range(ndim)
                          if program.boundary == "periodic"
                          and shards[d] == 1)
        sharded_axes = tuple(d for d in range(ndim) if shards[d] > 1)
    else:
        local = tuple(true_shape)
        rounded = tuple(round_up(true_shape[d], plan.block_shape[d])
                        for d in range(ndim))
        wrap_axes = tuple(range(ndim)) \
            if program.boundary == "periodic" else ()
        sharded_axes = ()
    layout = PaddedLayout(halo=H, local_shape=local, rounded=rounded,
                          wrap_axes=wrap_axes)
    if shards is None and layout.wrap_degenerate():
        return RunSchedule(program=program, plan=plan, layout=layout,
                           variant=v, steps=steps, full=0, rem=0,
                           supersteps=(), fallback=True)
    period = chunk * plan.par_time
    full, rem = divmod(steps, period)
    wrap = bool(wrap_axes)
    amap = ping_pong_aliases(wrap)
    tout = tile_output_index(wrap)
    # the operand whose buffer backs the tile output (3 = window source)
    winput = next((i for i, o in amap.items() if o == tout), 4)
    wraps = wrap_copies(layout)

    def entry(index, rb, ss_steps, ss_variant):
        h = ss_steps * program.halo_radius
        ring = wraps + tuple(c for d in sharded_axes
                             for c in exchange_copies(d, h, H, local[d]))
        return SuperstepSchedule(
            index=index, steps=ss_steps, halo=h, variant=ss_variant,
            read_buffer=rb, write_buffer=rb if winput == 3 else 1 - rb,
            window_offset=H - h,
            window_shape=tuple(b + 2 * h for b in plan.block_shape),
            write_tile=tuple(plan.block_shape),
            write_stride=tuple(plan.block_shape),
            ring=ring, fixup=program.boundary != "periodic",
            aliases=tuple(sorted(amap.items())))

    supersteps = []
    rb = 0
    for i in range(min(full, 4)):
        supersteps.append(entry(i, rb, period, v))
        rb = 1 - rb
    if rem:
        supersteps.append(entry(len(supersteps), rb, rem,
                                "plain" if v == "temporal" else v))
    return RunSchedule(program=program, plan=plan, layout=layout, variant=v,
                       steps=steps, full=full, rem=rem,
                       supersteps=tuple(supersteps),
                       sharded_axes=sharded_axes)


def run_launches(sched: RunSchedule
                 ) -> Tuple[Tuple[str, str, BlockPlan, int], ...]:
    """The superstep launches of the run ``sched`` describes, in order, as
    ``(kernel, variant, plan, count)``: ``count`` launches of ``kernel``,
    each the ``variant`` superstep of ``plan`` (a remainder's plan has
    ``par_time`` = its steps, a temporal chunk's is the run's plan).
    :func:`run_call` launches exactly these; RP105 sizes them.

    A scheduled superstep of ``s`` steps is one launch of its variant's
    carry kernel.  A wrap-degenerate run (``sched.fallback``, which the
    schedule does not model) re-pads every superstep
    (:func:`run_call_padfallback`): B6 for "pipelined", else B5, a
    temporal run with the chunk-deep plan."""
    plan = sched.plan
    if sched.fallback:
        base = deep_plan(plan) if sched.variant == "temporal" else plan
        v = "pipelined" if sched.variant == "pipelined" else "plain"
        kernel = "pipelined_superstep" if v == "pipelined" else "superstep"
        full, rem = divmod(sched.steps, base.par_time)
        out = [(kernel, v, base, full),
               (kernel, v, dataclasses.replace(base, par_time=rem),
                int(rem > 0))]
    else:
        scheduled = sched.supersteps
        out = [(scheduled[0], sched.full)] if sched.full else []
        if sched.rem:
            out.append((scheduled[-1], 1))
        out = [(CARRY_KERNELS[ss.variant], ss.variant,
                dataclasses.replace(plan, par_time=ss.steps // (
                    TEMPORAL_CHUNK if ss.variant == "temporal" else 1)),
                count) for ss, count in out]
    return tuple(o for o in out if o[3])


def run_kernels(program: StencilProgram, plan: BlockPlan,
                true_shape: Optional[Tuple[int, ...]] = None,
                steps: Optional[int] = None,
                variant: Optional[str] = None
                ) -> Tuple[Tuple[str, BlockPlan], ...]:
    """The distinct ``(kernel, plan)`` of :func:`run_launches` for a run
    of ``steps`` on ``true_shape``.  Without them: a run of a full
    superstep (or chunk) and the longest remainder on a grid that is not
    wrap-degenerate."""
    v = normalize_variant(variant)
    if true_shape is None or steps is None:
        chunk = TEMPORAL_CHUNK if v == "temporal" else 1
        steps = 2 * chunk * plan.par_time - 1
        # one whole block at least as wide as the deepest ring per axis
        true_shape = tuple(round_up(chunk * plan.halo, b)
                           for b in plan.block_shape)
    sched = ring_schedule(program, plan, tuple(true_shape), steps,
                          variant=v)
    return tuple(dict.fromkeys((kernel, kplan) for kernel, _, kplan, _
                               in run_launches(sched)))


# ---- the two kernels of a superstep: plain versions and dispatch ------------


def _interior(offsets: Sequence[int], sizes: Sequence[int]):
    return (Ellipsis,) + tuple(slice(o, o + s) for o, s in zip(offsets, sizes))


def padded_superstep_plain(src: torch.Tensor, dst: torch.Tensor,
                           center: torch.Tensor, taps: torch.Tensor, *,
                           program: StencilProgram, plan: BlockPlan,
                           layout: PaddedLayout,
                           tile: Optional[Tuple[int, ...]] = None,
                           offsets: Optional[Sequence[int]] = None,
                           global_shape: Optional[Tuple[int, ...]] = None
                           ) -> torch.Tensor:
    """Plain version of the superstep kernel; writes ``dst``'s rounded
    interior in place and returns ``dst``.

    ``tile`` (default: the whole rounded grid as one tile) cuts the
    interior into output tiles, each computed from its own halo'd window
    as the kernel's CTAs do; the result on true cells does not depend on
    it.  ``offsets`` is a shard's origin in the ``global_shape`` grid (the
    reference's ``offsets=``/``global_shape=``): the fixups act at global
    coordinates ``offsets + o - h``, so a shard's exchanged ring cells at
    inner edges stay as they are.  Without them, one device: origin 0 in
    ``layout.local_shape``.
    """
    center, taps = grid_coeffs(center, taps, src)
    h = plan.halo
    H = layout.halo
    off = H - h
    rounded = layout.rounded
    tile = rounded if tile is None else tuple(tile)
    offs = [0] * len(rounded) if offsets is None else [int(o)
                                                       for o in offsets]
    true = layout.local_shape if global_shape is None \
        else tuple(global_shape)
    coeffs = ProgramCoeffs(center, taps)
    for origin in itertools.product(*(range(0, r, t)
                                      for r, t in zip(rounded, tile))):
        size = [min(t, r - o) for t, r, o in zip(tile, rounded, origin)]
        win = src[_interior([off + o for o in origin],
                            [s + 2 * h for s in size])]
        starts = [g + o - h for g, o in zip(offs, origin)]
        cur = boundary_fixup(program, win, starts, true)
        dst[_interior([H + o for o in origin], size)] = _fused_steps(
            program, coeffs, cur, starts, true, plan.par_time)
    return dst


def refresh_wrap_halo_plain(src: torch.Tensor,
                            layout: PaddedLayout) -> torch.Tensor:
    """Plain version of the wrap refresh: the :func:`wrap_copies` schedule
    as in-place copies of ``src`` (source and destination of one copy are
    disjoint on a layout that is not wrap-degenerate)."""
    nb = src.ndim - len(layout.rounded)
    for c in wrap_copies(layout):
        ax = nb + c.axis
        src.narrow(ax, c.dst[0], c.width).copy_(
            src.narrow(ax, c.src[0], c.width))
    return src


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"tensors on {t.device} have neither a kernel nor a "
                     f"plain version here (cuda or cpu)")


#: The span of each kernel's launch, by its key in ``cuda.KERNELS``.
LAUNCH_SPANS = {name: "launch." + name for name in cuda.KERNELS}
#: The prefix of the range a superstep launch opens inside its launch
#: span: ``superstep.steps.<T>``, T the steps the launch fuses.
STEPS_SPAN = "superstep.steps."
#: The counter of the cell updates superstep launches make (recorder on).
CELL_STEPS = "superstep.cell_steps"


def _record_superstep(sp, t: torch.Tensor, spatial: int, cells: int,
                      steps: int) -> None:
    """A recorded superstep launch: its span ``sp`` takes the launch's
    attributes, and its cell updates (every grid of the batch, every
    fused step) count as :data:`CELL_STEPS`."""
    attrs = _launch_attrs(t, spatial, cells, steps)
    sp.set(**attrs)
    obs.count(CELL_STEPS, attrs["cells"] * steps)


def _launch_attrs(t: torch.Tensor, spatial: int, cells: int,
                  steps: int) -> dict:
    """A launch span's recorder attributes: the grid's dtype, its batch,
    the cells the launch writes (every grid of the batch) and its fused
    steps."""
    batch = t.shape[0] if t.ndim > spatial else 1
    return dict(dtype=str(t.dtype).removeprefix("torch."), batch=batch,
                cells=batch * cells, steps=steps)


def deep_plan(plan: BlockPlan) -> BlockPlan:
    """The chunk-deep plan of the temporal variant: ``TEMPORAL_CHUNK``
    supersteps fused into one (reference ``build_temporal_kernel``)."""
    return dataclasses.replace(plan, par_time=plan.par_time * TEMPORAL_CHUNK)


def padded_superstep(src: torch.Tensor, dst: torch.Tensor,
                     center: torch.Tensor, taps: torch.Tensor, *,
                     program: StencilProgram, plan: BlockPlan,
                     layout: PaddedLayout,
                     variant: Optional[str] = None,
                     offsets: Optional[Sequence[int]] = None,
                     global_shape: Optional[Tuple[int, ...]] = None
                     ) -> torch.Tensor:
    """One superstep ``src`` -> ``dst`` (for "temporal", one chunk of
    ``TEMPORAL_CHUNK`` supersteps): the variant's CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor.  ``offsets`` and
    ``global_shape`` place a mesh shard (plain and pipelined only: the
    mesh refuses the temporal chunk); a shard launches the sharded
    instantiation of B1 or B4."""
    v = normalize_variant(variant)
    shard = dict(offsets=offsets, global_shape=global_shape)
    sharded = offsets is not None or global_shape is not None
    if v == "temporal" and sharded:
        raise ValueError("the temporal chunk runs on one device only: a "
                         "shard's ring is exchanged once per superstep")
    name = CARRY_KERNELS[v] + ("_sharded" if sharded else "")
    steps = plan.par_time * (TEMPORAL_CHUNK if v == "temporal" else 1)
    with obs.span(LAUNCH_SPANS[name]) as sp, \
            obs.span(STEPS_SPAN + str(steps)):
        if sp.recording:
            _record_superstep(sp, src, program.ndim,
                              math.prod(layout.local_shape), steps)
        if _on_cuda(src):
            if v == "temporal":
                cuda.temporal_superstep(src, dst, center, taps,
                                        program=program, plan=plan,
                                        layout=layout)
            else:
                launch = cuda.padded_superstep if v == "plain" \
                    else cuda.padded_pipelined
                launch(src, dst, center, taps, program=program, plan=plan,
                       layout=layout, **shard)
            return dst
        padded_superstep_plain(
            src, dst, center, taps, program=program,
            plan=deep_plan(plan) if v == "temporal" else plan,
            layout=layout, **shard)
        _audit_plain(name, src, dst, center, taps)
    return dst


def refresh_wrap_halo(src: torch.Tensor,
                      layout: PaddedLayout) -> torch.Tensor:
    """Periodic ring refresh of ``src`` in place: one CUDA launch for a
    CUDA tensor, the plain version for a CPU tensor."""
    with obs.span(LAUNCH_SPANS["wrap_halo"]) as sp:
        if sp.recording:
            sp.set(**_launch_attrs(src, len(layout.rounded),
                                   _ring_cells(layout), 0))
        if _on_cuda(src):
            cuda.refresh_wrap_halo(src, layout)
            return src
        refresh_wrap_halo_plain(src, layout)
        _audit_plain("wrap_halo", src, None)
    return src


def _ring_cells(layout: PaddedLayout) -> int:
    """The cells one ring refresh writes: each of :func:`wrap_copies`'s
    strips, every other axis at its padded extent."""
    P = layout.padded_shape
    return sum(c.width * math.prod(P) // P[c.axis]
               for c in wrap_copies(layout))


# ---- executors -----------------------------------------------------------------


def superstep_plain(padded: torch.Tensor, center: torch.Tensor,
                    taps: torch.Tensor, *, program: StencilProgram,
                    plan: BlockPlan, true_shape: Tuple[int, ...],
                    offsets: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Plain version of the pre-padded superstep (B5 and B6):
    ``par_time`` fused steps over a grid ``boundary_pad`` already padded by
    ``plan.halo``; no t=0 fixup; fixups between steps at global
    coordinates, ``offsets`` being the shard origin (zeros on one device)
    and ``true_shape`` the global grid.  Returns the rounded grid."""
    h = plan.halo
    offs = [0] * program.ndim if offsets is None else [int(o)
                                                       for o in offsets]
    center, taps = grid_coeffs(center, taps, padded)
    return _fused_steps(program, ProgramCoeffs(center, taps), padded,
                        [o - h for o in offs], true_shape, plan.par_time)


def superstep_call(padded: torch.Tensor, center: torch.Tensor,
                   taps: torch.Tensor, *, program: StencilProgram,
                   plan: BlockPlan, true_shape: Tuple[int, ...],
                   offsets: Optional[Sequence[int]] = None,
                   variant: Optional[str] = None) -> torch.Tensor:
    """The pre-padded superstep (reference ``superstep_call``).

    ``padded`` is ``rounded + 2*plan.halo`` per axis, optionally behind one
    batch axis, already halo-filled by the program's boundary.  Returns the
    rounded grid after ``par_time`` steps (caller slices back); on the card
    the cells of the round-up slack are unspecified.  ``offsets`` is the
    shard origin in the global ``true_shape``.  A CUDA tensor launches B5
    ("plain") or B6 ("pipelined"), a CPU tensor runs ``superstep_plain``.
    """
    v = normalize_variant(variant)
    # The reference's own semantics, not a fallback: a lone superstep has
    # no chunk to fuse, so "temporal" runs the plain kernel
    # (repro/kernels/common.py:superstep_call).
    if v == "temporal":
        v = "plain"
    batch_dims(program, padded.ndim)
    name = "pipelined_superstep" if v == "pipelined" else "superstep"
    with obs.span(LAUNCH_SPANS[name]) as sp, \
            obs.span(STEPS_SPAN + str(plan.par_time)):
        if sp.recording:
            _record_superstep(sp, padded, program.ndim, math.prod(
                n - 2 * plan.halo for n in padded.shape[-program.ndim:]),
                plan.par_time)
        if _on_cuda(padded):
            launch = cuda.pipelined_superstep if v == "pipelined" \
                else cuda.superstep
            return launch(padded, center, taps, program=program, plan=plan,
                          true_shape=tuple(true_shape), offsets=offsets)
        out = superstep_plain(padded, center, taps, program=program,
                              plan=plan, true_shape=tuple(true_shape),
                              offsets=offsets)
        _audit_plain(name, padded, out, center, taps)
    return out


def pad_superstep(grid: torch.Tensor, center: torch.Tensor,
                  taps: torch.Tensor, *, program: StencilProgram,
                  plan: BlockPlan,
                  variant: Optional[str] = None) -> torch.Tensor:
    """One superstep of a true-shaped grid (optionally batched):
    ``boundary_pad`` by ``plan.halo`` plus the round-up to the block,
    :func:`superstep_call`, and the true region back (a new tensor)."""
    ndim = program.ndim
    nb = batch_dims(program, grid.ndim)
    true_shape = tuple(grid.shape[nb:])
    h = plan.halo
    padded = boundary_pad(program, grid, [(0, 0)] * nb + [
        (h, round_up(true_shape[d], plan.block_shape[d]) - true_shape[d] + h)
        for d in range(ndim)])
    out = superstep_call(padded, center, taps, program=program, plan=plan,
                         true_shape=true_shape, variant=variant)
    return out[_interior([0] * ndim, true_shape)].contiguous()


def run_call_padfallback(grid: torch.Tensor, center: torch.Tensor,
                         taps: torch.Tensor, full: int, *,
                         program: StencilProgram, plan: BlockPlan, rem: int,
                         variant: Optional[str] = None) -> torch.Tensor:
    """Re-pad the true region every superstep: the path of wrap-degenerate
    periodic layouts, where one-lap ring copies cannot refresh the ring.
    Each superstep is one pre-padded superstep (B5, or B6 for
    "pipelined").

    ``variant`` must be "plain" or "pipelined": ``run_call`` lowers a
    wrap-degenerate temporal run as the chunk-deep plan with the plain
    kernel, as the reference does.
    """
    v = normalize_variant(variant)
    if v == "temporal":
        raise ValueError(
            "pass the chunk-deep plan with variant='plain' instead of "
            "variant='temporal' to run_call_padfallback")
    for _ in range(full):
        grid = pad_superstep(grid, center, taps, program=program, plan=plan,
                             variant=v)
    if rem:
        grid = pad_superstep(grid, center, taps, program=program,
                             plan=dataclasses.replace(plan, par_time=rem),
                             variant=v)
    return grid.contiguous()


def zero_outside(buf: torch.Tensor, layout: PaddedLayout) -> torch.Tensor:
    """Zero every cell of the padded buffer ``buf`` (optionally behind one
    batch axis) outside the true interior ``[H, H+n)``, in place: per axis
    the ring ``[0, H)`` and the slack with the far ring ``[H+n, P)``, each
    slab narrowed on the axes before it to their true interior, so the
    ``2 * ndim`` slabs cover the outside once and the interior not at all.
    Returns ``buf``."""
    H = layout.halo
    view = buf
    nb = buf.ndim - len(layout.local_shape)
    for d, (n, p) in enumerate(zip(layout.local_shape,
                                   layout.padded_shape)):
        ax = nb + d
        view.narrow(ax, 0, H).zero_()
        view.narrow(ax, H + n, p - H - n).zero_()
        view = view.narrow(ax, H, n)
    return buf


def run_call(grid, center: torch.Tensor, taps: torch.Tensor,
             full: int, *, program: StencilProgram, plan: BlockPlan,
             true_shape: Tuple[int, ...], rem: int,
             variant: Optional[str] = None) -> torch.Tensor:
    """Fused multi-superstep executor over a persistent padded carry.

    ``grid`` is the true-shaped grid, optionally behind one batch axis, or
    a batch given as a sequence of true-shaped grids (row ``i`` of the
    batch is ``grid[i]``); it is copied into the padded layout once, a
    grid a copy, and never written.  The two buffers are allocated
    uninitialised and only their cells outside the true interior are
    zeroed (:func:`zero_outside`): every launch writes a buffer's true
    interior before reading it, so each buffer holds at every launch what
    zero-filled buffers would.  Each superstep refreshes the periodic ring
    of the source (if any), runs the variant's superstep kernel into the
    other buffer, and swaps the two.  ``full`` supersteps run first, then
    one shallower superstep of ``rem`` steps whose windows read at ring
    offset ``H - rem * radius``.

    Under "temporal" the ring is ``TEMPORAL_CHUNK`` times deeper, each of
    the ``full`` launches is one chunk of ``TEMPORAL_CHUNK * par_time``
    steps, and ``rem`` counts leftover steps.  A wrap-degenerate layout
    re-pads every superstep as :func:`run_call_padfallback` does (a
    sequence stacked first), for temporal with the chunk-deep plan and the
    plain kernel.  The launches are those of :func:`run_launches`.
    Returns a new tensor holding the true interior.

    The device bytes the padded carry's own copies move (each grid's copy
    in and slice out, read and written, and the zeroed cells of both
    buffers) count as ``run_call.copy_bytes`` while a recorder is on.
    """
    rows = None if isinstance(grid, torch.Tensor) else tuple(grid)
    if rows is not None:
        if len(rows) == 0:
            raise ValueError("a batch given as a sequence needs a grid")
        if any(tuple(r.shape) != tuple(true_shape) for r in rows):
            raise ValueError(
                f"every grid of a sequence must have the true shape "
                f"{tuple(true_shape)} (got "
                f"{[tuple(r.shape) for r in rows]})")
    first = grid if rows is None else rows[0]
    v = normalize_variant(variant)
    center, taps = grid_coeffs(center, taps, first)
    period = plan.par_time * (TEMPORAL_CHUNK if v == "temporal" else 1)
    sched = ring_schedule(program, plan, true_shape, full * period + rem,
                          variant=v)
    launches = run_launches(sched)
    if sched.fallback:
        if rows is not None:
            grid = torch.stack(rows)
        with obs.span("run_call.supersteps"):
            for _, step_variant, step_plan, count in launches:
                for _ in range(count):
                    grid = pad_superstep(grid, center, taps,
                                         program=program, plan=step_plan,
                                         variant=step_variant)
        return grid.contiguous()
    layout = sched.layout
    batch = (len(rows),) if rows is not None \
        else tuple(grid.shape[:grid.ndim - program.ndim])
    interior = _interior([layout.halo] * program.ndim, true_shape)
    with obs.span("run_call.pad_in"):
        src = first.new_empty(batch + layout.padded_shape)
        dst = torch.empty_like(src)
        if rows is None:
            src[interior] = grid
        else:
            for i, row in enumerate(rows):
                src[i][interior] = row
        zero_outside(src, layout)
        zero_outside(dst, layout)
    cells = math.prod(batch) * math.prod(true_shape)
    # in and out, a read and a write each; the outside of both buffers
    obs.count("run_call.copy_bytes", first.element_size() * (
        4 * cells + 2 * (src.numel() - cells)))
    # The temporal remainder (fewer than TEMPORAL_CHUNK * par_time steps)
    # is the reference's own semantics, not a fallback: one plain
    # superstep of `rem` steps inside the same deep ring
    # (repro/kernels/common.py:run_call).
    with obs.span("run_call.supersteps"):
        for _, step_variant, step_plan, count in launches:
            for _ in range(count):
                if layout.wrap_axes:
                    refresh_wrap_halo(src, layout)
                padded_superstep(src, dst, center, taps, program=program,
                                 plan=step_plan, layout=layout,
                                 variant=step_variant)
                src, dst = dst, src
    with obs.span("run_call.slice_out"):
        return src[interior].contiguous()
