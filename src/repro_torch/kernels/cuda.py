"""ctypes wrappers of the hand-written CUDA kernels (``csrc/*.cu``).

Each wrapper checks device, dtype, contiguity and shape, launches its
kernel on PyTorch's current stream, raises when the C launcher returns a
non-zero ``cudaError_t``, and adds one to its kernel's ``launches`` count
per launch.  Nothing here runs at import: the library is built and loaded
at the first launch (``kernels/build.py``), one per source and grid dtype
(float32, bfloat16, float16: the program's ``dtype``, which the grid must
have); the launch counts add up over the dtypes, and :func:`launches` by
dtype tells them apart.  The coefficients reach the kernels rounded to
the grid's dtype, as the TPU kernels cast them
(``repro/kernels/common.py:_superstep_pallas``): as floats for a float32
grid, as (c, c) pairs of the grid's dtype for a 16-bit one, whose kernels
multiply two cells at a time (:func:`coefficient_bank`).

Which TPU kernel of ``repro/kernels/common.py`` each one replaces (the
source headers say what bounds each on the card and what its design does
about it).  Two bodies carry every superstep (``blocking.kernel_body``
says which one a kernel and tap set run):

* ``padded_superstep`` (B1, ``build_padded_superstep_kernel``; a mesh
  shard's launch is the sharded instantiation, counted as
  ``padded_superstep_sharded``),
  ``superstep`` (B5, ``build_superstep_kernel``) and
  ``pipelined_superstep`` (B6, ``build_pipelined_kernel``) ->
  ``csrc/queued_superstep.cu`` for stars within ``QUEUE_STEPS``: CTAs
  that stream a column tile plane by plane with a star's streamed-axis
  neighbours in per-thread register queues (geometry in
  ``kernels/queued.py``).  B1 and B5 run a one-shot grid, B6 persistent
  CTAs;
* ``temporal_superstep`` (B3, ``build_temporal_kernel``) and
  ``padded_pipelined`` (B4, ``build_padded_pipelined_kernel``; a shard's
  launch counted as ``padded_pipelined_sharded``) ->
  ``csrc/streamed_superstep.cu``, CTAs that stream a column tile plane by
  plane through one ring of planes per fused step, copying the next plane
  group while the current one computes (geometry in
  ``kernels/streamed.py``); B3 one-shot, B4 persistent.  B1, B5 and B6
  run every other tap set there too: B1 on the carry, B5 and B6 in its
  pre-padded mode (B1 and B5 one-shot, B6 persistent);
* ``refresh_wrap_halo`` (B2, ``_refresh_wrap_halo``) -> ``csrc/wrap_halo.cu``,
  one launch per refresh for every wrap axis, ordered before the
  superstep on the same stream instead of running inside it.

The CTA tile is not the plan's block: :func:`pick_tile` sizes it per
kernel by the card's opt-in shared-memory limit
(``BlockPlan.smem_bytes_for``).
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Optional, Tuple

import torch

from repro_torch.analysis.hw import GpuChip
from repro_torch.core.blocking import vec_cells
from repro_torch.core.program import DTYPES
from repro_torch.kernels import build, queued, streamed

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

BOUNDARY_CODES = {"clamp": 0, "periodic": 1, "constant": 2}


#: The launch audit while it records (``lint/artifact.record_launches``),
#: else None: a launch then pays this one check.
AUDIT = None


class Kernel:
    """One C launcher of the built libraries, and its launch counts per
    grid dtype (``by_dtype``); ``name`` is its key in :data:`KERNELS`."""

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.name = symbol
        self.by_dtype = {}
        self._bound_fns = {}

    @property
    def launches(self) -> int:
        return sum(self.by_dtype.values())

    def _bound(self, dtype: str):
        bound = self._bound_fns.get(dtype)
        if bound is None:
            lib = build.load(self.source, dtype)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            errstr = getattr(lib, self.source.split(".")[0] + "_error_string")
            errstr.argtypes = [ctypes.c_int]
            errstr.restype = ctypes.c_char_p
            bound = self._bound_fns[dtype] = (fn, errstr)
        return bound

    def __call__(self, *args, dtype: str,
                 route: Optional["Kernel"] = None,
                 src: Optional[torch.Tensor] = None,
                 dst: Optional[torch.Tensor] = None,
                 operands: Tuple[torch.Tensor, ...] = ()) -> None:
        """Launch through this kernel's C launcher of the ``dtype``
        library, or through ``route``'s (another source's launcher
        computing the same function); the launch counts as this
        kernel's.  ``src``, ``dst`` (None: ``src`` in place) and
        ``operands`` are the tensors behind the pointers in ``args``,
        which the launch audit records when it is on."""
        fn, errstr = (route or self)._bound(dtype)
        code = fn(*args)
        if code != 0:
            raise RuntimeError(f"{fn.__name__} ({dtype}): CUDA error {code} "
                               f"({errstr(code).decode()})")
        self.by_dtype[dtype] = self.by_dtype.get(dtype, 0) + 1
        if AUDIT is not None:
            AUDIT.launch(self.name, src=src, dst=dst, operands=operands,
                         route="cuda")


#: (src, dst, coef, offs, ntaps, steps, boundary, bval, geometry, batch,
#: device, stream), shared by every superstep launcher
_SUPERSTEP_ARGS = [_P, _P, _P, _P, _I, _I, _I, ctypes.c_float,
                   ctypes.POINTER(_L), _I, _I, _P]

PADDED_SUPERSTEP = Kernel("queued_superstep.cu", "queued_superstep_launch",
                          _SUPERSTEP_ARGS)
TEMPORAL_SUPERSTEP = Kernel("streamed_superstep.cu",
                            "temporal_superstep_launch", _SUPERSTEP_ARGS)
SUPERSTEP = Kernel("queued_superstep.cu", "queued_superstep_launch",
                   _SUPERSTEP_ARGS)
PADDED_PIPELINED = Kernel("streamed_superstep.cu",
                          "padded_pipelined_launch", _SUPERSTEP_ARGS)
PIPELINED_SUPERSTEP = Kernel("queued_superstep.cu",
                             "queued_superstep_launch", _SUPERSTEP_ARGS)
#: The sharded instantiations of B1 and B4 (a mesh shard's carry: the t = 0
#: boundary at global coordinates ``origin + local``), counted apart from
#: the single device's, whose origin is 0 at compile time.
PADDED_SUPERSTEP_SHARDED = Kernel("queued_superstep.cu",
                                  "queued_superstep_launch",
                                  _SUPERSTEP_ARGS)
PADDED_PIPELINED_SHARDED = Kernel("streamed_superstep.cu",
                                  "padded_pipelined_launch",
                                  _SUPERSTEP_ARGS)

#: (buf, boxes, nbox, blocks, P0, P1, P2, device, stream)
WRAP_HALO = Kernel("wrap_halo.cu", "wrap_halo_launch",
                   [_P, _P, _I, _I, _L, _L, _L, _I, _P])

KERNELS = {
    "padded_superstep": PADDED_SUPERSTEP,
    "wrap_halo": WRAP_HALO,
    "temporal_superstep": TEMPORAL_SUPERSTEP,
    "padded_pipelined": PADDED_PIPELINED,
    "superstep": SUPERSTEP,
    "pipelined_superstep": PIPELINED_SUPERSTEP,
    "padded_superstep_sharded": PADDED_SUPERSTEP_SHARDED,
    "padded_pipelined_sharded": PADDED_PIPELINED_SHARDED,
}
for _name, _kernel in KERNELS.items():
    _kernel.name = _name
del _name, _kernel


def reset_launches() -> None:
    for k in KERNELS.values():
        k.by_dtype = {}


def launches(dtype: Optional[str] = None) -> dict:
    """Launches per kernel since :func:`reset_launches`: of every dtype,
    or of the ``dtype`` library alone."""
    if dtype is None:
        return {name: k.launches for name, k in KERNELS.items()}
    return {name: k.by_dtype.get(dtype, 0) for name, k in KERNELS.items()}


@functools.lru_cache(maxsize=None)
def smem_optin(index: int) -> int:
    return GpuChip.from_device(index).smem_optin


@functools.lru_cache(maxsize=None)
def streamed_tap_table(program, device: torch.device) -> torch.Tensor:
    """:func:`streamed.streamed_taps` as int32 rows on ``device``."""
    return torch.tensor(streamed.streamed_taps(program), dtype=torch.int32,
                        device=device)


def smallest_tile(plan, kernel: str) -> Tuple[int, ...]:
    """The in-plane column-tile candidate of ``kernel`` with the least
    shared memory for the body it runs (:meth:`BlockPlan.body`)."""
    steps = plan.kernel_steps(kernel)
    if plan.body(kernel) == "streamed":
        return streamed.smallest_streamed_tile(plan.program, steps)
    return queued.smallest_queued_tile(plan.program, steps)


def pick_tile(plan, kernel: str, smem_limit: int) -> Tuple[int, ...]:
    """The in-plane column tile of ``kernel`` (a name of
    ``blocking.KERNELS``) under ``plan``: ``streamed.pick_streamed_tile``
    for the streamed body, ``queued.pick_queued_tile`` for the register
    queues (:meth:`BlockPlan.body`).  Raises when none fits, which is when
    :func:`smallest_tile` does not."""
    steps = plan.kernel_steps(kernel)
    if plan.body(kernel) == "streamed":
        return streamed.pick_streamed_tile(plan.program, steps, smem_limit)
    return queued.pick_queued_tile(plan.program, steps, smem_limit)


def _stream(dev: torch.device) -> int:
    """PyTorch's current stream on ``dev`` as the launchers take it, looked
    up by device index (by ``torch.device`` the lookup took most of a
    wrap refresh's host time, ``PERF.md``)."""
    return torch.cuda.current_stream(dev.index).cuda_stream


def grid_dtype(program) -> str:
    """The kernels' library dtype of ``program`` (its ``dtype``); raises
    for a dtype the kernels do not take."""
    if program.dtype not in build.DTYPES:
        raise ValueError(f"the kernels take grids of {tuple(build.DTYPES)},"
                         f" not {program.dtype!r}")
    return program.dtype


def _check(t: torch.Tensor, name: str, shape: Tuple[int, ...],
           dtype: str) -> None:
    """``t`` a contiguous CUDA tensor of the kernels' ``dtype`` and of
    ``shape`` behind at most one batch axis."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} lies on {t.device}, the kernel needs a "
                         f"CUDA tensor")
    if t.dtype != DTYPES[dtype]:
        raise ValueError(f"{name} is {t.dtype}, the kernel of a {dtype} "
                         f"program takes {DTYPES[dtype]}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if tuple(t.shape[-len(shape):]) != tuple(shape) \
            or t.ndim not in (len(shape), len(shape) + 1):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)} behind at most one batch axis")


def _check_pair(src: torch.Tensor, dst: torch.Tensor, layout,
                program) -> None:
    P = layout.padded_shape
    _check(src, "src", P, grid_dtype(program))
    _check(dst, "dst", P, grid_dtype(program))
    if dst.shape != src.shape or dst.device != src.device:
        raise ValueError(f"dst {tuple(dst.shape)} on {dst.device} does not "
                         f"match src {tuple(src.shape)} on {src.device}")


def _host_array(geo):
    """The geometry's host array as the C launchers take it (the
    geometries themselves are cached, so a launch's host work stays a
    small part of the kernel's time)."""
    flat = geo.array()
    return (_L * len(flat))(*flat)


def coefficient_bank(center: torch.Tensor, taps: torch.Tensor,
                     grid: torch.Tensor) -> torch.Tensor:
    """The coefficients as the kernels read them: ``center`` and ``taps``
    rounded to ``grid``'s dtype on its device (``common.grid_coeffs``) in
    canonical order, as float32 values for a float32 grid and as (c, c)
    pairs of the grid's dtype (``c0, c0, c1, c1, ...``) for a 16-bit one,
    where one 32-bit entry multiplies a lane of two cells
    (``csrc/elem.cuh``: ``coef_t``)."""
    coef = torch.cat([center.reshape(1).to(grid.device, grid.dtype),
                      taps.reshape(-1).to(grid.device, grid.dtype)])
    if grid.dtype == torch.float32:
        return coef.contiguous()
    return coef.repeat_interleave(2).contiguous()


def _superstep_launch(kernel: Kernel, src: torch.Tensor, dst: torch.Tensor,
                      center: torch.Tensor, taps: torch.Tensor, geo, program,
                      route: Optional[Kernel] = None) -> None:
    """One superstep launch of ``geo`` (a ``queued.QueuedGeometry`` or a
    ``streamed.StreamedGeometry``) through ``kernel``'s launcher, or
    through ``route``'s (the same function on another source): taps as
    (streamed, y, x) rows.  The coefficients go as
    :func:`coefficient_bank`, the boundary value rounded to the grid's
    dtype, as a float."""
    dev = src.device
    coef = coefficient_bank(center, taps, src)
    ntaps = 1 + taps.numel()
    bval = torch.tensor(program.boundary_value, dtype=src.dtype).item()
    table = streamed_tap_table(program, dev)
    kernel(src.data_ptr(), dst.data_ptr(), coef.data_ptr(),
           table.data_ptr(), ntaps,
           geo.steps, BOUNDARY_CODES[program.boundary], float(bval),
           _host_array(geo), geo.batch, dev.index, _stream(dev),
           dtype=grid_dtype(program), route=route, src=src, dst=dst,
           operands=(coef, table))


def _shard(layout, offsets, global_shape) -> dict:
    """The geometry keywords placing a mesh shard (none on one device)."""
    if offsets is None and global_shape is None:
        return {}
    nd = len(layout.local_shape)
    return dict(origin=(0,) * nd if offsets is None
                else tuple(int(o) for o in offsets),
                true_shape=layout.local_shape if global_shape is None
                else tuple(int(n) for n in global_shape))


def padded_superstep(src: torch.Tensor, dst: torch.Tensor,
                     center: torch.Tensor, taps: torch.Tensor, *, program,
                     plan, layout, offsets=None, global_shape=None,
                     tile=None, segment=None) -> None:
    """B1: one superstep of ``plan.par_time`` steps of the padded carry
    ``src`` -> ``dst`` (true interior of ``dst`` only; see
    ``common.padded_superstep_plain``), a one-shot grid: the register
    queues for a star within ``QUEUE_STEPS``, the streamed kernel's
    one-shot launcher (B3's, at ``par_time`` steps) for every other tap
    set.  ``offsets`` and ``global_shape`` place a mesh shard: its
    geometry is then ``sharded`` and the launch runs (and counts as) the
    sharded instantiation.  ``tile`` (in-plane) and ``segment`` override
    the picks."""
    _check_pair(src, dst, layout, program)
    batch = src.shape[0] if src.ndim > program.ndim else 1
    kw = dict(batch=batch, smem_limit=smem_optin(src.device.index),
              tile=tile, segment=segment,
              **_shard(layout, offsets, global_shape))
    if plan.body("padded_superstep") == "streamed":
        geo = streamed.carry_geometry(program, plan.par_time, layout, **kw)
        route = TEMPORAL_SUPERSTEP
    else:
        geo = queued.carry_geometry(program, plan.par_time, layout, **kw)
        route = None
    kernel = PADDED_SUPERSTEP_SHARDED if geo.sharded else PADDED_SUPERSTEP
    _superstep_launch(kernel, src, dst, center, taps, geo, program, route)


def _streamed(kernel: Kernel, name: str, src: torch.Tensor,
              dst: torch.Tensor, center: torch.Tensor, taps: torch.Tensor, *,
              program, plan, layout, tile, segment, offsets=None,
              global_shape=None, sharded: Optional[Kernel] = None) -> None:
    """B3 or B4: a streamed superstep of the padded carry, geometry from
    ``streamed.carry_geometry``; a shard's launch counts as ``sharded``."""
    _check_pair(src, dst, layout, program)
    batch = src.shape[0] if src.ndim > program.ndim else 1
    geo = streamed.carry_geometry(
        program, plan.kernel_steps(name), layout, batch=batch,
        smem_limit=smem_optin(src.device.index), tile=tile, segment=segment,
        **_shard(layout, offsets, global_shape))
    if geo.sharded:
        _superstep_launch(sharded, src, dst, center, taps, geo, program,
                          kernel)
    else:
        _superstep_launch(kernel, src, dst, center, taps, geo, program)


def temporal_superstep(src: torch.Tensor, dst: torch.Tensor,
                       center: torch.Tensor, taps: torch.Tensor, *, program,
                       plan, layout, tile=None, segment=None) -> None:
    """B3: one superstep-chunk of ``TEMPORAL_CHUNK * plan.par_time`` steps
    over the chunk-deep ring (``plan`` is the run's plan, not the deep
    one).  ``tile`` (in-plane) and ``segment`` override the geometry's
    picks."""
    _streamed(TEMPORAL_SUPERSTEP, "temporal_superstep", src, dst, center,
              taps, program=program, plan=plan, layout=layout, tile=tile,
              segment=segment)


def padded_pipelined(src: torch.Tensor, dst: torch.Tensor,
                     center: torch.Tensor, taps: torch.Tensor, *, program,
                     plan, layout, offsets=None, global_shape=None,
                     tile=None, segment=None) -> None:
    """B4: one superstep of ``plan.par_time`` steps, persistent CTAs;
    ``offsets``/``global_shape`` as :func:`padded_superstep`'s."""
    _streamed(PADDED_PIPELINED, "padded_pipelined", src, dst, center, taps,
              program=program, plan=plan, layout=layout, tile=tile,
              segment=segment, offsets=offsets, global_shape=global_shape,
              sharded=PADDED_PIPELINED_SHARDED)


def _rounded(padded: torch.Tensor, program, plan) -> Tuple[int, ...]:
    nd = program.ndim
    spatial = tuple(padded.shape[-nd:])
    rounded = tuple(s - 2 * plan.halo for s in spatial)
    if any(s < 1 for s in rounded):
        raise ValueError(f"padded grid {spatial} is not larger than twice "
                         f"the halo {plan.halo}")
    _check(padded, "padded", spatial, grid_dtype(program))
    return rounded


def _prepadded(kernel: Kernel, name: str, padded: torch.Tensor,
               center: torch.Tensor, taps: torch.Tensor, *, program, plan,
               true_shape, offsets, tile, segment,
               persistent: bool) -> torch.Tensor:
    """A pre-padded superstep (B5 one-shot, B6 persistent) into a new
    tensor of the rounded grid: the register queues for a star within
    ``QUEUE_STEPS``, else the streamed kernel's pre-padded mode on its
    one-shot (B3's) or persistent (B4's) launcher."""
    nd = program.ndim
    rounded = _rounded(padded, program, plan)
    out = torch.empty(tuple(padded.shape[:-nd]) + rounded,
                      device=padded.device, dtype=padded.dtype)
    offsets = (0,) * nd if offsets is None else tuple(int(o)
                                                      for o in offsets)
    args = (program, plan.par_time, tuple(padded.shape[-nd:]),
            tuple(int(n) for n in true_shape), offsets)
    kw = dict(batch=padded.shape[0] if padded.ndim > nd else 1,
              smem_limit=smem_optin(padded.device.index), tile=tile,
              segment=segment)
    if plan.body(name) == "streamed":
        geo = streamed.prepadded_geometry(*args, **kw)
        route = PADDED_PIPELINED if persistent else TEMPORAL_SUPERSTEP
    else:
        geo = queued.prepadded_geometry(*args, persistent=persistent, **kw)
        route = None
    _superstep_launch(kernel, padded, out, center, taps, geo, program,
                      route)
    return out


def superstep(padded: torch.Tensor, center: torch.Tensor,
              taps: torch.Tensor, *, program, plan, true_shape, offsets=None,
              tile=None, segment=None) -> torch.Tensor:
    """B5: the pre-padded superstep, a grid ``boundary_pad`` already padded
    by ``plan.halo`` -> a new tensor of the rounded grid, every cell
    written (cells of the round-up slack in a tile or segment wholly past
    the grid are finite but unspecified: callers slice the true region
    back); ``offsets`` is the shard origin in the global ``true_shape``.
    A one-shot grid.  ``tile`` (in-plane) and ``segment`` override the
    picks."""
    return _prepadded(SUPERSTEP, "superstep", padded, center, taps,
                      program=program, plan=plan, true_shape=true_shape,
                      offsets=offsets, tile=tile, segment=segment,
                      persistent=False)


def pipelined_superstep(padded: torch.Tensor, center: torch.Tensor,
                        taps: torch.Tensor, *, program, plan, true_shape,
                        offsets=None, tile=None,
                        segment=None) -> torch.Tensor:
    """B6: B5's function on persistent CTAs, the first planes of a CTA's
    next work item in flight while the current one computes."""
    return _prepadded(PIPELINED_SUPERSTEP, "pipelined_superstep", padded,
                      center, taps, program=program, plan=plan,
                      true_shape=true_shape, offsets=offsets, tile=tile,
                      segment=segment, persistent=True)


#: Threads of a wrap-refresh CTA and the items each copies
#: (``csrc/wrap_halo.cu``).
WRAP_THREADS, WRAP_PER_THREAD = 256, 2


@functools.lru_cache(maxsize=64)
def wrap_boxes(layout) -> Tuple[Tuple[Tuple[int, int, int], ...], ...]:
    """The shell of ``layout`` (``common.PaddedLayout``): the cells whose
    coordinate on some wrap axis lies outside ``[H, H + n)``, as boxes of
    ``(lo, extent, shift)`` per spatial axis; each cell of a box takes the
    cell ``shift`` away (per axis), the interior cell at its wrapped
    coordinate, which is what the axis-ordered ``common.wrap_copies``
    leave there.  Slab ``d`` (one per wrap axis, in order) is ring on axis
    ``d``, interior on the wrap axes before it and full on the axes after
    it; it splits into boxes where the shift changes (the two sides of the
    ring on ``d``; low ring, interior and high ring on a later wrap axis).
    Raises on a wrap-degenerate layout, whose sources would not all be
    interior."""
    if layout.wrap_degenerate():
        raise ValueError(f"a wrap-degenerate layout ({layout}) has no "
                         f"one-lap ring refresh: the run re-pads instead")
    H, P = layout.halo, layout.padded_shape
    boxes = []
    for i, d in enumerate(layout.wrap_axes):
        axes = []
        for a, (n, p) in enumerate(zip(layout.local_shape, P)):
            low, mid, high = (0, H, n), (H, n, 0), (H + n, p - H - n, -n)
            if a == d:
                axes.append((low, high))
            elif a in layout.wrap_axes[:i]:
                axes.append((mid,))
            elif a in layout.wrap_axes:
                axes.append((low, mid, high))
            else:
                axes.append(((0, p, 0),))
        boxes += [b for b in itertools.product(*axes)
                  if all(ext > 0 for _, ext, _ in b)]
    return tuple(boxes)


def wrap_rows(layout, batch: int, aligned: bool, itemsize: int = 4):
    """The ``wrap_halo.cu:BoxField`` rows of :func:`wrap_boxes` for a
    ``batch`` of grids of ``itemsize`` bytes per cell, the launch's CTAs
    and the padded extent as three axes (a 2D grid's first is 1).  A box
    copies 16 bytes (4 cells in float32, 8 in 16 bits) an item where its
    rows are 16-byte aligned on both sides (``aligned``: the buffer is)."""
    nd = len(layout.padded_shape)
    P3 = (1,) * (3 - nd) + tuple(layout.padded_shape)
    a = vec_cells(itemsize)
    rows, blocks = [], 0
    for box in wrap_boxes(layout):
        (l0, e0, s0), (l1, e1, s1), (l2, e2, s2) = \
            ((0, 1, 0),) * (3 - nd) + box
        vec = aligned and all(v % a == 0 for v in (P3[2], l2, e2, s2))
        ex = e2 // a if vec else e2
        count = batch * e0 * e1 * ex
        if count >= 1 << 31:
            raise ValueError(f"a wrap box of {count} items needs 64-bit "
                             f"item indices")
        rows.append((blocks, count, l0, l1, l2, e0, e1, ex,
                     (s0 * P3[1] + s1) * P3[2] + s2, int(vec)))
        blocks += -(-count // (WRAP_THREADS * WRAP_PER_THREAD))
    return tuple(rows), blocks, P3


@functools.lru_cache(maxsize=64)
def _wrap_launch(layout, batch: int, device: torch.device, aligned: bool,
                 itemsize: int):
    """The launch arguments of :func:`wrap_rows` after the buffer:
    ``(rows on the device, boxes, CTAs, P0, P1, P2)``, made once per
    layout, batch, device and bytes per cell (the device array is kept
    alive here)."""
    rows, blocks, P3 = wrap_rows(layout, batch, aligned, itemsize)
    table = torch.tensor(rows, dtype=torch.int64, device=device)
    torch.cuda.current_stream(device.index).synchronize()
    return table, (table.data_ptr(), len(rows), blocks) + P3


#: The kernels' dtype name of each grid dtype they take.
_DTYPE_NAMES = {t: name for name, t in DTYPES.items()}


def refresh_wrap_halo(src: torch.Tensor, layout) -> None:
    """B2: refresh every wrap axis of ``src`` in place in one launch
    (:func:`wrap_boxes`; the launch arguments are cached per layout, so a
    refresh is one ctypes call), in the library of ``src``'s dtype (the
    copy moves cells as they are).  Refuses a wrap-degenerate layout."""
    P = layout.padded_shape
    dtype = _DTYPE_NAMES.get(src.dtype, "float32")
    _check(src, "src", P, dtype)
    ptr, dev = src.data_ptr(), src.device
    _, args = _wrap_launch(layout, src.shape[0] if src.ndim > len(P) else 1,
                           dev, ptr % 16 == 0, src.element_size())
    WRAP_HALO(ptr, *args, dev.index, _stream(dev), dtype=dtype, src=src)
