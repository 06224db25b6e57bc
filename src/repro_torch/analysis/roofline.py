"""Roofline terms of a step, counted on the meta device — counterpart of
``repro/analysis/roofline.py``.

Three terms per (arch x shape x mesh) cell, each per device, over the
card's data-sheet constants (``analysis/hw.GpuChip``: the bf16 dense
tensor peak, HBM bandwidth, NVLink each way):

    compute    = FLOPs_per_device / peak_bf16_flops
    memory     = bytes_per_device / hbm_bytes_per_s
    collective = collective_bytes_per_device / nvlink_bytes_per_s

The reference reads FLOPs and bytes from compiled HLO with a parser.  The
port has no compiler output to read, so it measures the same quantities
by running the step itself on meta tensors under :class:`CostCounter`,
with the reference parser's conventions (``_parse_module``):

* a matrix product costs ``2·M·N·K`` (``torch.utils.flop_counter``'s
  registry: ``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions and the
  fused attention kernels);
* an elementwise op costs 1 FLOP per output element (:data:`_EW_OPS`,
  the aten names of the reference's ``_EW_OPS``); an aten op that XLA
  lowers to several such HLO ops costs theirs (:data:`_COMPOSITE`);
* a reduction costs its input's elements (the reference's ``reduce``);
* views and the ops of :data:`_FREE_OPS` (the reference's parameter,
  bitcast and allocation ops) cost nothing;
* every other op moves its inputs' and outputs' bytes.

There is no trip-count walk.  XLA's ``cost_analysis`` counts a while body
once, so the reference multiplies each body by its ``known_trip_count``;
eager PyTorch runs every layer's and every microbatch's ops, so each is
dispatched, and counted, as often as it runs.

The counter also follows the bytes of the tensors the step allocates
while it runs (by storage, so a view adds nothing) and keeps their peak:
the step's temporaries, which the dry run adds to its arguments for the
fit to the card's memory.
"""

from __future__ import annotations

import dataclasses
import json
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis.hw import H100_SXM, GpuChip

#: the reference's collective kinds, in its order
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: 1 FLOP per output element: the aten names of the reference's
#: ``_EW_OPS`` (HLO elementwise and transcendental ops)
_EW_OPS = frozenset("""
add sub rsub mul div maximum minimum pow bitwise_and bitwise_or bitwise_xor
bitwise_not logical_and logical_or logical_xor logical_not neg abs exp expm1
log log1p tanh rsqrt sqrt sin cos tan atan2 sigmoid where clamp clamp_min
clamp_max eq ne lt le gt ge floor ceil round sign remainder fmod isfinite
reciprocal square masked_fill
""".split())

#: FLOPs per output element of aten ops XLA lowers to several elementwise
#: HLO ops (the reference's ``jax.nn`` definitions): silu = x * logistic(x);
#: tanh-GeLU = 0.5x(1 + tanh(c(x + 0.044715x^3))); softplus = log1p(exp);
#: each backward is its chain rule's multiplies and adds
_COMPOSITE = {
    "silu": 2, "gelu": 8, "softplus": 2, "lerp": 3, "addcmul": 2,
    "addcdiv": 2, "tanh_backward": 3, "sigmoid_backward": 3,
    "silu_backward": 5, "gelu_backward": 14, "softplus_backward": 4,
    "threshold_backward": 1,
}

#: reductions: the reference's ``reduce`` costs its input's elements
_REDUCTIONS = frozenset("""
sum mean amax amin max min prod var std cumsum cumprod logsumexp norm
linalg_vector_norm argmax argmin any all
""".split())

#: softmax and its backward: a max, a subtraction, an exponential, a sum
#: and a division per element (its backward: a product, a sum, a
#: subtraction and a product)
_PER_INPUT = {"_softmax": 5, "_log_softmax": 5,
              "_softmax_backward_data": 4, "_log_softmax_backward_data": 4}

#: no FLOPs and no bytes: the reference's parameter, bitcast and
#: allocation ops (besides every view op)
_FREE_OPS = frozenset("""
empty empty_like empty_strided new_empty new_empty_strided detach alias
lift_fresh _unsafe_view _local_scalar_dense sym_size sym_stride sym_numel
""".split())


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts FLOPs and bytes of every aten op run under it (module
    docstring), and the peak bytes of the storages allocated under it
    (``peak_temp_bytes``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live_bytes = 0
        self.peak_temp_bytes = 0
        self._refs: Dict[int, list] = {}    # storage -> [live tensors, bytes]
        self._seen: Dict[tuple, tuple] = {}  # op key -> output layout

    def add(self, flops: int, moved: int, transient: int = 0):
        """Counts made elsewhere (a layer body counted once for every
        layer of its kind), with ``transient`` bytes alive at once on top
        of what lives now."""
        self.flops += flops
        self.bytes += moved
        self.peak_temp_bytes = max(self.peak_temp_bytes,
                                   self.live_bytes + transient)

    def _track(self, out: torch.Tensor):
        """Count ``out``'s storage while any tensor allocated on it under
        the counter lives."""
        key = out.untyped_storage()._cdata
        entry = self._refs.get(key)
        if entry is None:
            entry = self._refs[key] = [0, out.untyped_storage().nbytes()]
            self.live_bytes += entry[1]
            self.peak_temp_bytes = max(self.peak_temp_bytes, self.live_bytes)
        entry[0] += 1
        weakref.finalize(out, self._release, key)

    def _release(self, key: int):
        entry = self._refs[key]
        entry[0] -= 1
        if entry[0] == 0:
            self.live_bytes -= entry[1]
            del self._refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket not in flop_registry:
            # an op with a composite definition (``matmul`` under
            # ``inference_mode``) is counted by the ops it is made of
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        if func.is_view or func._schema.is_mutable:
            out = func(*args, **kwargs)
            if func.is_view or _base(func) in _FREE_OPS:
                for t in _tensors(out):
                    if t.untyped_storage()._cdata in self._refs:
                        self._track(t)
                return out
            return self._count(func, args, kwargs, out)
        key = _key(func, args, kwargs)
        known = self._seen.get(key) if key is not None else None
        if known is not None:
            out = _rebuilt(known)
        else:
            out = func(*args, **kwargs)
            if key is not None and _fresh(func, out):
                self._seen[key] = _layout(out)
        return self._count(func, args, kwargs, out)

    def _count(self, func, args, kwargs, out):
        base = _base(func)
        if base in _FREE_OPS:
            return out
        outs = list(_tensors(out))
        flops = 0
        if func.overloadpacket in flop_registry:
            flops = flop_registry[func.overloadpacket](*args, **kwargs,
                                                       out_val=out)
        elif base in _EW_OPS:
            flops = sum(t.numel() for t in outs)
        elif base in _COMPOSITE:
            flops = _COMPOSITE[base] * sum(t.numel() for t in outs)
        elif base in _REDUCTIONS:
            first = next(_tensors(args), None)
            flops = first.numel() if first is not None else 0
        elif base in _PER_INPUT:
            flops = _PER_INPUT[base] * next(_tensors(args)).numel()
        moved = sum(_nbytes(t) for t in _tensors((args, kwargs))) \
            + sum(_nbytes(t) for t in outs)
        self.flops += int(flops)
        self.bytes += moved
        if not func._schema.is_mutable:
            for t in outs:
                self._track(t)
        return out


def _base(func) -> str:
    """The op's name without the in-place underscore."""
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.endswith("__") \
        else name


def _meta(x):
    """A hashable stand-in for one argument: a tensor's layout, a list's
    items', a plain value as it is; None where it cannot be hashed."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        items = tuple(_meta(i) for i in x)
        return None if None in items else ("L", items)
    if isinstance(x, (int, float, bool, str, torch.dtype, torch.device,
                      torch.memory_format, torch.layout)) or x is None:
        return ("V", type(x).__name__, x)
    return None


def _key(func, args, kwargs):
    """The op and its arguments' layouts: two calls with one key make
    outputs of one layout (the meta kernels read nothing else)."""
    items = tuple(_meta(a) for a in args) + tuple(
        (k, _meta(v)) for k, v in sorted(kwargs.items()))
    if any(i is None or (isinstance(i, tuple) and i[1] is None)
           for i in items):
        return None
    return (func,) + items


def _fresh(func, out) -> bool:
    """Whether every output is a new tensor (no alias of an input): only
    those are rebuilt from a remembered layout."""
    if any(r.alias_info is not None for r in func._schema.returns):
        return False
    return all(isinstance(t, torch.Tensor) for t in
               (out if isinstance(out, (list, tuple)) else (out,)))


def _layout(out):
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.stride(), out.dtype)
    return type(out), tuple(_layout(t) for t in out)


def _rebuilt(layout):
    """New meta tensors of a remembered layout."""
    if isinstance(layout[0], type):
        kind, items = layout
        return kind(_rebuilt(i) for i in items)
    shape, stride, dtype = layout
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


@dataclasses.dataclass
class RooflineCell:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: Dict[str, float]
    peak_memory_per_device: int
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops: float
    useful_ratio: float
    notes: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def analyze(*, arch: str, shape: str, mesh_name: str, chips: int,
            flops: float, bytes_accessed: float,
            collectives: Dict[str, float], peak_bytes: int,
            model_flops: float, hw: GpuChip = H100_SXM,
            notes: str = "") -> RooflineCell:
    """A cell's three terms from its counted FLOPs, bytes and collective
    bytes per device (``collectives``: bytes by kind of
    :data:`COLLECTIVES`) and its peak bytes per device."""
    coll = {k: float(collectives.get(k, 0.0)) for k in COLLECTIVES}
    total = sum(coll.values())
    t_c = flops / hw.peak_bf16_flops
    t_m = bytes_accessed / hw.hbm_bytes_per_s
    t_x = total / hw.nvlink_bytes_per_s
    dominant = max((("compute", t_c), ("memory", t_m), ("collective", t_x)),
                   key=lambda kv: kv[1])[0]
    total_flops = flops * chips
    return RooflineCell(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=float(flops), bytes_per_device=float(bytes_accessed),
        coll_bytes_per_device=total, coll_breakdown=coll,
        peak_memory_per_device=int(peak_bytes),
        t_compute=t_c, t_memory=t_m, t_collective=t_x, dominant=dominant,
        model_flops=model_flops,
        useful_ratio=(model_flops / total_flops) if total_flops else 0.0,
        notes=notes)


def save_cell(cell: RooflineCell, path: str):
    with open(path, "w") as f:
        json.dump(cell.to_json(), f, indent=1)


def count(fn, *args, **kwargs) -> CostCounter:
    """Run ``fn(*args, **kwargs)`` under a fresh :class:`CostCounter` and
    return the counter."""
    counter = CostCounter()
    with counter:
        fn(*args, **kwargs)
    return counter


__all__ = ["COLLECTIVES", "CostCounter", "RooflineCell", "analyze", "count",
           "save_cell"]
