"""ctypes wrappers of the hand-written CUDA kernels (``csrc/*.cu``).

Each wrapper checks device, dtype, contiguity and shape, launches its
kernel on PyTorch's current stream, raises when the C launcher returns a
non-zero ``cudaError_t``, and adds one to its kernel's ``launches`` count
per launch.  Nothing here runs at import: the library is built and loaded
at the first launch (``kernels/build.py``).

Which TPU kernel of ``repro/kernels/common.py`` each one replaces (the
source headers say what bounds each on the card and what its design does
about it):

* ``padded_superstep`` (B1, ``build_padded_superstep_kernel``) and
  ``pipelined_superstep`` (B6, ``build_pipelined_kernel``) ->
  ``csrc/queued_superstep.cu``, CTAs that stream a column tile plane by
  plane with a star's streamed-axis neighbours in per-thread register
  queues (geometry in ``kernels/queued.py``; B6's CTAs are persistent).
  For every other tap set B1 runs the one-shot launcher of
  ``csrc/streamed_superstep.cu`` (the same function of the padded carry),
  B6 the ring path of its own source;
* ``superstep`` (B5, ``build_superstep_kernel``) ->
  ``csrc/padded_superstep.cu``, one CTA per output tile and its halo'd
  window;
* ``temporal_superstep`` (B3, ``build_temporal_kernel``) and
  ``padded_pipelined`` (B4, ``build_padded_pipelined_kernel``) ->
  ``csrc/streamed_superstep.cu``, CTAs that stream a column tile plane by
  plane through one ring of planes per fused step, copying the next plane
  group while the current one computes (geometry in
  ``kernels/streamed.py``; B4's CTAs are persistent);
* ``refresh_wrap_halo`` (B2, ``_refresh_wrap_halo``) -> ``csrc/wrap_halo.cu``,
  one launch per wrap axis, ordered before the superstep on the same
  stream instead of running inside it.

The CTA tile is not the plan's block: :func:`pick_tile` sizes it per
kernel by the card's opt-in shared-memory limit
(``BlockPlan.smem_bytes_for``).
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.analysis.hw import GpuChip
from repro_torch.kernels import build, queued, streamed

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

BOUNDARY_CODES = {"clamp": 0, "periodic": 1, "constant": 2}

#: CTA output-tile candidates per axis; x (contiguous) is a multiple of 32
#: so that a warp reads whole 128-byte rows.
TILE_X = (128, 64, 32)
TILE_Y = (64, 32, 16, 8, 4)
TILE_Z = (16, 8, 4, 2, 1)

#: Rows of the geometry array, in the order of ``superstep_common.cuh:Field``.
GEOMETRY_FIELDS = ("true", "src", "load", "origin", "dst", "store",
                   "written", "tile", "radius")
#: What a 2D grid's missing z axis holds in each row (one plane, no halo).
_LEAD = dict(true=1, src=1, load=0, origin=0, dst=1, store=0, written=1,
             tile=1, radius=0)


class Kernel:
    """One C launcher of a built library, and its launch count."""

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._errstr = None

    def _bound(self):
        if self._fn is None:
            lib = build.load(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            errstr = getattr(lib, self.source.split(".")[0] + "_error_string")
            errstr.argtypes = [ctypes.c_int]
            errstr.restype = ctypes.c_char_p
            self._fn, self._errstr = fn, errstr
        return self._fn, self._errstr

    def __call__(self, *args, route: Optional["Kernel"] = None) -> None:
        """Launch through this kernel's C launcher, or through ``route``'s
        (another source's launcher computing the same function); the
        launch counts as this kernel's."""
        fn, errstr = (route or self)._bound()
        code = fn(*args)
        if code != 0:
            raise RuntimeError(f"{fn.__name__}: CUDA error {code} "
                               f"({errstr(code).decode()})")
        self.launches += 1


#: (src, dst, coef, offs, ntaps, steps, boundary, bval, geometry, batch,
#: device, stream), shared by every superstep launcher
_SUPERSTEP_ARGS = [_P, _P, _P, _P, _I, _I, _I, ctypes.c_float,
                   ctypes.POINTER(_L), _I, _I, _P]

PADDED_SUPERSTEP = Kernel("queued_superstep.cu", "padded_superstep_launch",
                          _SUPERSTEP_ARGS)
TEMPORAL_SUPERSTEP = Kernel("streamed_superstep.cu",
                            "temporal_superstep_launch", _SUPERSTEP_ARGS)
SUPERSTEP = Kernel("padded_superstep.cu", "superstep_launch",
                   _SUPERSTEP_ARGS)
PADDED_PIPELINED = Kernel("streamed_superstep.cu",
                          "padded_pipelined_launch", _SUPERSTEP_ARGS)
PIPELINED_SUPERSTEP = Kernel("queued_superstep.cu",
                             "pipelined_superstep_launch", _SUPERSTEP_ARGS)

WRAP_HALO = Kernel(
    "wrap_halo.cu", "wrap_halo_launch",
    [_P, _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _P])

KERNELS = {
    "padded_superstep": PADDED_SUPERSTEP,
    "wrap_halo": WRAP_HALO,
    "temporal_superstep": TEMPORAL_SUPERSTEP,
    "padded_pipelined": PADDED_PIPELINED,
    "superstep": SUPERSTEP,
    "pipelined_superstep": PIPELINED_SUPERSTEP,
}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launches() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


@functools.lru_cache(maxsize=None)
def smem_optin(index: int) -> int:
    return GpuChip.from_device(index).smem_optin


@functools.lru_cache(maxsize=None)
def tap_table(program, device: torch.device) -> torch.Tensor:
    """``((0,…,0),) + neighbor_taps`` as int32 (z, y, x) rows on ``device``
    (a 2D tap gets z = 0)."""
    rows = [(0,) * 3] + [(0,) * (3 - program.ndim) + tuple(o)
                         for o in program.neighbor_taps]
    return torch.tensor(rows, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def streamed_tap_table(program, device: torch.device) -> torch.Tensor:
    """:func:`streamed.streamed_taps` as int32 rows on ``device``."""
    return torch.tensor(streamed.streamed_taps(program), dtype=torch.int32,
                        device=device)


def smallest_tile(plan, kernel: str) -> Tuple[int, ...]:
    """The CTA tile candidate of ``kernel`` with the least shared memory:
    the least extent on every axis for B5's window, the least ring or
    plane memory for the kernels that stream planes."""
    steps = plan.kernel_steps(kernel)
    body = plan.body(kernel)
    if body == "streamed":
        return streamed.smallest_streamed_tile(plan.program, steps)
    if body in ("queue", "ring"):
        return queued.smallest_queued_tile(plan.program, steps,
                                           body == "queue")
    ndim = plan.program.ndim
    axes = (TILE_Y, TILE_X) if ndim == 2 else (TILE_Z, TILE_Y, TILE_X)
    return tuple(min(a) for a in axes)


def pick_tile(plan, kernel: str, smem_limit: int) -> Tuple[int, ...]:
    """The CTA tile of ``kernel`` (a name of ``blocking.KERNELS``) under
    ``plan``.

    The streamed kernels take an in-plane column tile
    (``streamed.pick_streamed_tile``), and so do B1 and B6
    (``queued.pick_queued_tile``; B1 without register queues the streamed
    pick, :meth:`BlockPlan.body`).  B5 takes an output tile per axis:
    among the candidates whose shared memory
    (``BlockPlan.smem_bytes_for``) fits a third of the limit (three CTAs
    per SM), or else the whole limit, the least window volume per output
    cell, then the widest x.  Raises when none fits, which is when
    :func:`smallest_tile` does not.
    """
    steps = plan.kernel_steps(kernel)
    body = plan.body(kernel)
    if body == "streamed":
        return streamed.pick_streamed_tile(plan.program, steps, smem_limit)
    if body in ("queue", "ring"):
        return queued.pick_queued_tile(plan.program, steps, smem_limit,
                                       body == "queue")
    ndim = plan.program.ndim
    axes = (TILE_Y, TILE_X) if ndim == 2 else (TILE_Z, TILE_Y, TILE_X)
    cands = list(itertools.product(*axes))
    halo = steps * plan.program.halo_radius

    def cost(t):
        return (math.prod(s + 2 * halo for s in t) / math.prod(t), -t[-1])

    for budget in (smem_limit // 3, smem_limit):
        fits = [t for t in cands
                if plan.smem_bytes_for(t, kernel) <= budget]
        if fits:
            return min(fits, key=cost)
    smallest = smallest_tile(plan, kernel)
    raise ValueError(
        f"no CTA tile fits: the smallest, {smallest}, needs "
        f"{plan.smem_bytes_for(smallest, kernel)} bytes of shared memory "
        f"for {kernel} ({steps} steps, halo {halo}), the card allows "
        f"{smem_limit}")


def _check(t: torch.Tensor, name: str, shape: Tuple[int, ...]) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} lies on {t.device}, the kernel needs a "
                         f"CUDA tensor")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} is {t.dtype}, the kernel takes float32")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if tuple(t.shape[-len(shape):]) != tuple(shape) \
            or t.ndim not in (len(shape), len(shape) + 1):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)} behind at most one batch axis")


def _launch(kernel: Kernel, grid_in: torch.Tensor, grid_out: torch.Tensor,
            center: torch.Tensor, taps: torch.Tensor, *, program,
            steps: int, **rows: Sequence[int]) -> None:
    """One superstep launch ``grid_in`` -> ``grid_out``; ``rows`` are the
    geometry rows of :data:`GEOMETRY_FIELDS` over the spatial axes."""
    nd = program.ndim
    dev = grid_in.device
    batch = grid_in.shape[0] if grid_in.ndim > nd else 1
    coef = torch.cat([center.reshape(1), taps.reshape(-1)]).to(
        device=dev, dtype=torch.float32).contiguous()
    offs = tap_table(program, dev)
    lead = 3 - nd
    flat = [v for f in GEOMETRY_FIELDS
            for v in (_LEAD[f],) * lead + tuple(int(x) for x in rows[f])]
    geometry = (_L * len(flat))(*flat)
    stream = torch.cuda.current_stream(dev).cuda_stream
    kernel(grid_in.data_ptr(), grid_out.data_ptr(), coef.data_ptr(),
           offs.data_ptr(), coef.numel(), steps,
           BOUNDARY_CODES[program.boundary], float(program.boundary_value),
           geometry, batch, dev.index, stream)


def _check_pair(src: torch.Tensor, dst: torch.Tensor, layout) -> None:
    P = layout.padded_shape
    _check(src, "src", P)
    _check(dst, "dst", P)
    if dst.shape != src.shape or dst.device != src.device:
        raise ValueError(f"dst {tuple(dst.shape)} on {dst.device} does not "
                         f"match src {tuple(src.shape)} on {src.device}")


def _host_array(geo):
    """The geometry's host array as the C launchers take it (the
    geometries themselves are cached, so a launch's host work stays a
    small part of the kernel's time)."""
    flat = geo.array()
    return (_L * len(flat))(*flat)


def _queued_launch(kernel: Kernel, src, dst, center, taps, geo,
                   program) -> None:
    dev = src.device
    coef = torch.cat([center.reshape(1), taps.reshape(-1)]).to(
        device=dev, dtype=torch.float32).contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    kernel(src.data_ptr(), dst.data_ptr(), coef.data_ptr(),
           streamed_tap_table(program, dev).data_ptr(), coef.numel(),
           geo.steps, BOUNDARY_CODES[program.boundary],
           float(program.boundary_value), _host_array(geo), geo.batch,
           dev.index, stream)


def padded_superstep(src, dst, center, taps, *, program, plan, layout,
                     tile=None, segment=None) -> None:
    """B1: one superstep of ``plan.par_time`` steps of the padded carry
    ``src`` -> ``dst`` (true interior of ``dst`` only; see
    ``common.padded_superstep_plain``), a one-shot grid: the register
    queues for a star within ``QUEUE_STEPS``, the streamed kernel's
    one-shot launcher (B3's, at ``par_time`` steps) for every other tap
    set.  ``tile`` (in-plane) and ``segment`` override the picks."""
    _check_pair(src, dst, layout)
    if plan.body("padded_superstep") == "streamed":
        _streamed(PADDED_SUPERSTEP, "padded_superstep", src, dst, center,
                  taps, program=program, plan=plan, layout=layout,
                  tile=tile, segment=segment, route=TEMPORAL_SUPERSTEP)
        return
    batch = src.shape[0] if src.ndim > program.ndim else 1
    geo = queued.carry_geometry(
        program, plan.par_time, layout, batch=batch,
        smem_limit=smem_optin(src.device.index), tile=tile,
        segment=segment)
    _queued_launch(PADDED_SUPERSTEP, src, dst, center, taps, geo, program)


def _streamed(kernel: Kernel, name: str, src, dst, center, taps, *,
              program, plan, layout, tile, segment,
              route: Optional[Kernel] = None) -> None:
    """A streamed superstep of the padded carry (B3, B4, or B1 through
    ``route``): geometry from ``streamed.carry_geometry``, taps as
    (streamed, y, x) rows."""
    _check_pair(src, dst, layout)
    nd = program.ndim
    dev = src.device
    batch = src.shape[0] if src.ndim > nd else 1
    steps = plan.kernel_steps(name)
    geo = streamed.carry_geometry(
        program, steps, layout, batch=batch,
        smem_limit=smem_optin(dev.index), tile=tile, segment=segment)
    coef = torch.cat([center.reshape(1), taps.reshape(-1)]).to(
        device=dev, dtype=torch.float32).contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    kernel(src.data_ptr(), dst.data_ptr(), coef.data_ptr(),
           streamed_tap_table(program, dev).data_ptr(), coef.numel(), steps,
           BOUNDARY_CODES[program.boundary], float(program.boundary_value),
           _host_array(geo), batch, dev.index, stream, route=route)


def temporal_superstep(src, dst, center, taps, *, program, plan, layout,
                       tile=None, segment=None) -> None:
    """B3: one superstep-chunk of ``TEMPORAL_CHUNK * plan.par_time`` steps
    over the chunk-deep ring (``plan`` is the run's plan, not the deep
    one).  ``tile`` (in-plane) and ``segment`` override the geometry's
    picks."""
    _streamed(TEMPORAL_SUPERSTEP, "temporal_superstep", src, dst, center,
              taps, program=program, plan=plan, layout=layout, tile=tile,
              segment=segment)


def padded_pipelined(src, dst, center, taps, *, program, plan, layout,
                     tile=None, segment=None) -> None:
    """B4: one superstep of ``plan.par_time`` steps, persistent CTAs."""
    _streamed(PADDED_PIPELINED, "padded_pipelined", src, dst, center, taps,
              program=program, plan=plan, layout=layout, tile=tile,
              segment=segment)


def _rounded(padded: torch.Tensor, program, plan) -> Tuple[int, ...]:
    nd = program.ndim
    spatial = tuple(padded.shape[-nd:])
    rounded = tuple(s - 2 * plan.halo for s in spatial)
    if any(s < 1 for s in rounded):
        raise ValueError(f"padded grid {spatial} is not larger than twice "
                         f"the halo {plan.halo}")
    _check(padded, "padded", spatial)
    return rounded


def _offsets(program, offsets) -> Tuple[int, ...]:
    return (0,) * program.ndim if offsets is None else tuple(
        int(o) for o in offsets)


def superstep(padded, center, taps, *, program, plan, true_shape,
              offsets=None) -> torch.Tensor:
    """B5: the pre-padded superstep: a grid ``boundary_pad`` already padded
    by ``plan.halo`` -> a new tensor of the rounded grid.  Cells of the
    round-up slack are finite but unspecified (callers slice the true
    region back, see ``superstep_common.cuh:boundary_fixup``)."""
    nd = program.ndim
    rounded = _rounded(padded, program, plan)
    out = torch.empty(tuple(padded.shape[:-nd]) + rounded,
                      device=padded.device, dtype=padded.dtype)
    tile = pick_tile(plan, "superstep", smem_optin(padded.device.index))
    _launch(SUPERSTEP, padded, out, center, taps, program=program,
            steps=plan.par_time, true=true_shape,
            src=tuple(padded.shape[-nd:]), load=(0,) * nd,
            origin=_offsets(program, offsets), dst=rounded,
            store=(0,) * nd, written=rounded, tile=tile,
            radius=(program.halo_radius,) * nd)
    return out


def pipelined_superstep(padded, center, taps, *, program, plan, true_shape,
                        offsets=None, tile=None,
                        segment=None) -> torch.Tensor:
    """B6: B5's function on persistent register-queued CTAs
    (``queued.prepadded_geometry``), the first planes of a CTA's next work
    item in flight while the current one computes.  ``tile`` (in-plane)
    and ``segment`` override the picks."""
    nd = program.ndim
    rounded = _rounded(padded, program, plan)
    out = torch.empty(tuple(padded.shape[:-nd]) + rounded,
                      device=padded.device, dtype=padded.dtype)
    batch = padded.shape[0] if padded.ndim > nd else 1
    geo = queued.prepadded_geometry(
        program, plan.par_time, padded.shape[-nd:], true_shape,
        _offsets(program, offsets), batch=batch,
        smem_limit=smem_optin(padded.device.index), tile=tile,
        segment=segment)
    _queued_launch(PIPELINED_SUPERSTEP, padded, out, center, taps, geo,
                   program)
    return out


def refresh_wrap_halo(src: torch.Tensor, copies, padded_shape) -> None:
    """Run the wrap ``copies`` (``common.wrap_copies``: lo then hi per
    axis) in place on ``src``, one launch per axis in order."""
    P = tuple(padded_shape)
    _check(src, "src", P)
    nd = len(P)
    batch = src.shape[0] if src.ndim > nd else 1
    stream = torch.cuda.current_stream(src.device).cuda_stream
    for lo, hi in zip(copies[0::2], copies[1::2]):
        d = lo.axis
        WRAP_HALO(src.data_ptr(), batch * math.prod(P[:d]), P[d],
                  math.prod(P[d + 1:]), lo.src[0], lo.dst[0], lo.width,
                  hi.src[0], hi.dst[0], hi.width, src.device.index, stream)
