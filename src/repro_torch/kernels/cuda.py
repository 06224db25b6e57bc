"""ctypes wrappers of the hand-written CUDA kernels (``csrc/*.cu``).

Each wrapper checks device, dtype, contiguity and shape, launches its
kernel on PyTorch's current stream, raises when the C launcher returns a
non-zero ``cudaError_t``, and adds one to its kernel's ``launches`` count
per launch.  Nothing here runs at import: the library is built and loaded
at the first launch (``kernels/build.py``).

* ``padded_superstep`` -> ``csrc/padded_superstep.cu`` replaces the TPU
  kernel ``repro/kernels/common.py:build_padded_superstep_kernel``.  Bound
  by device-memory bytes at the paper's shapes; the fused steps stay in
  shared memory, and :func:`pick_tile` sizes the CTA tile by the opt-in
  shared-memory limit (see the source's header note).
* ``refresh_wrap_halo`` -> ``csrc/wrap_halo.cu`` replaces
  ``repro/kernels/common.py:_refresh_wrap_halo``.  Bound by bytes
  (O(surface) copies); one launch per wrap axis, ordered before the
  superstep on the same stream instead of running inside it.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math
from typing import Sequence, Tuple

import torch

from repro_torch.analysis.hw import GpuChip
from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

BOUNDARY_CODES = {"clamp": 0, "periodic": 1, "constant": 2}

#: CTA output-tile candidates per axis; x (contiguous) is a multiple of 32
#: so that a warp reads whole 128-byte rows.
TILE_X = (128, 64, 32)
TILE_Y = (64, 32, 16, 8, 4)
TILE_Z = (16, 8, 4, 2, 1)


class Kernel:
    """One C launcher of a built library, and its launch count."""

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._errstr = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            lib = build.load(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            errstr = getattr(lib, self.source.split(".")[0] + "_error_string")
            errstr.argtypes = [ctypes.c_int]
            errstr.restype = ctypes.c_char_p
            self._fn, self._errstr = fn, errstr
        code = self._fn(*args)
        if code != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {code} "
                               f"({self._errstr(code).decode()})")
        self.launches += 1


PADDED_SUPERSTEP = Kernel(
    "padded_superstep.cu", "padded_superstep_launch",
    [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I,
     _L, _L, _L, _L, _L, _L, _L, _I, _I, _I, _I, _I, _P])

WRAP_HALO = Kernel(
    "wrap_halo.cu", "wrap_halo_launch",
    [_P, _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _P])

KERNELS = {"padded_superstep": PADDED_SUPERSTEP, "wrap_halo": WRAP_HALO}


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


def smem_bytes(tile: Sequence[int], halo: int, steps: int,
               ntaps: int) -> int:
    """Dynamic shared memory of one CTA: one window (two when the steps
    ping-pong) plus the coefficient and offset tables."""
    window = math.prod(t + 2 * halo for t in tile)
    return 4 * window * (2 if steps > 1 else 1) + 8 * ntaps


def pick_tile(ndim: int, halo: int, steps: int, ntaps: int,
              smem_limit: int) -> Tuple[int, ...]:
    """The CTA output tile of the superstep kernel.

    Among the candidates whose shared memory fits a third of the limit
    (three CTAs per SM), or else the whole limit, take the least window
    volume per output cell, then the widest x.  Raises when none fits.
    """
    axes = (TILE_Y, TILE_X) if ndim == 2 else (TILE_Z, TILE_Y, TILE_X)
    cands = list(itertools.product(*axes))

    def cost(t):
        return (math.prod(s + 2 * halo for s in t) / math.prod(t), -t[-1])

    for budget in (smem_limit // 3, smem_limit):
        fits = [t for t in cands
                if smem_bytes(t, halo, steps, ntaps) <= budget]
        if fits:
            return min(fits, key=cost)
    smallest = min(cands, key=math.prod)
    raise ValueError(
        f"no CTA tile fits: the smallest, {smallest}, needs "
        f"{smem_bytes(smallest, halo, steps, ntaps)} bytes of shared memory "
        f"for halo {halo} and {steps} steps, the card allows {smem_limit}")


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


def padded_superstep(src: torch.Tensor, dst: torch.Tensor,
                     center: torch.Tensor, taps: torch.Tensor, *,
                     program, plan, layout) -> None:
    """Launch one superstep ``src`` -> ``dst`` (true interior of ``dst``
    only; see ``common.padded_superstep_plain`` for the contract)."""
    P = layout.padded_shape
    _check(src, "src", P)
    _check(dst, "dst", P)
    if dst.shape != src.shape or dst.device != src.device:
        raise ValueError(f"dst {tuple(dst.shape)} on {dst.device} does not "
                         f"match src {tuple(src.shape)} on {src.device}")
    nd = program.ndim
    batch = src.shape[0] if src.ndim > nd else 1
    coef = torch.cat([center.reshape(1), taps.reshape(-1)]).to(
        device=src.device, dtype=torch.float32).contiguous()
    offs = tap_table(program, src.device)
    ntaps = coef.numel()
    steps = plan.par_time
    r = program.halo_radius
    tile = pick_tile(nd, steps * r, steps, ntaps,
                     smem_optin(src.device.index))
    lead = (1,) * (3 - nd)
    n3 = lead + tuple(layout.local_shape)
    P3 = lead + tuple(P)
    t3 = lead + tuple(tile)
    tiles = [-(-n // t) for n, t in zip(n3, t3)]
    if tiles[1] > 65535 or tiles[0] * batch > 65535:
        raise ValueError(f"{tiles} CTA tiles x batch {batch} exceed the "
                         f"launch grid's y/z limit of 65535")
    stream = torch.cuda.current_stream(src.device).cuda_stream
    PADDED_SUPERSTEP(src.data_ptr(), dst.data_ptr(), coef.data_ptr(),
                     offs.data_ptr(), ntaps, steps, r,
                     BOUNDARY_CODES[program.boundary],
                     float(program.boundary_value), nd, *n3, *P3,
                     layout.halo, *t3, batch, src.device.index, stream)


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
