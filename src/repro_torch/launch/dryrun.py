"""Multi-pod dry run: every (arch x shape x mesh) cell on the production
meshes, counted on the meta device — counterpart of
``repro/launch/dryrun.py``.

The reference lowers and compiles each cell for 256 or 512 forced host
devices and reads XLA's memory and cost analyses.  One process with one
card has no SPMD partitioner, so the port counts what the compiler would
report, per device, with nothing allocated (the model, the inputs and
every step run on ``device="meta"``):

1. **The model** at full width and depth (the training build: its
   parameters in ``param_dtype``, as the reference's params tree).
2. **Shardings**: the reference's rule flags per cell
   (``seq_parallel_cache`` for long_500k, ``expert_parallel`` for MoE in
   ``"ep"`` mode, ``fsdp_over_pod`` for bf16 params) and the batch over
   every mesh axis but ``model`` (not split at batch 1).  A dim that does
   not divide by its mesh axes raises the ``ValueError`` of
   ``checkpoint.reshard.NamedSharding`` naming the leaf and the axes,
   where the reference's ``jit`` refuses the cell; nothing else is
   swapped in.
3. **Argument bytes per device**, exact, from each leaf's
   ``shard_shape``: the parameters in the reference's stacked layout
   (``LMModel.reference_logical_axes``), AdamW's two moments under the
   parameter shardings and its int32 step, the batch, and the caches
   under :func:`cache_pspecs` (each layer's ``pos`` counted, as the
   reference stacks one per cache).
4. **FLOPs and bytes per device**, counted on the step itself
   (``analysis.roofline.CostCounter``): ``make_train_step`` with the
   reference's ``accum`` rule, ``make_prefill_step`` or
   ``make_decode_step``, run at one batch shard's batch.  The partition
   model: the batch shards split the work evenly, and the devices that
   share a batch shard (``chips / batch shards``, all of them at batch
   1) split its work evenly, so the shard's counts are divided by their
   number.  A layer's body runs the same ops for every layer of its
   kind and input layout, so :class:`_LayerMemo` counts it once per kind
   and layout (forward and backward on their own, on a thread of their
   own) and the step runs a stand-in of the same outputs that adds those
   counts where the body would run, remat recomputations included;
   everything else in the step runs and is counted as it is.
5. **Collective bytes per device**, a closed form over the shardings
   (:func:`collective_bytes`), by the names the reference's HLO gives
   them, each an operand's bytes as the reference counts them:
   ``all-gather`` of every parameter split over a batch axis (FSDP), per
   use (each forward, backward and remat recomputation of each
   microbatch); ``reduce-scatter`` of those parameters' gradients, per
   microbatch; ``all-reduce`` of the gradients of parameters replicated
   over a batch axis, per microbatch; ``all-reduce`` of the tensor-
   parallel activations, two per layer in every forward and backward
   pass and one after the vocab-split embedding; ``all-to-all`` of the
   expert-parallel dispatch buffers, two per MoE layer and pass; and for
   long_500k the sequence-split caches' ``all-reduce`` of each attention
   layer's output.  It is a model, not a measurement.

The peak per device is the arguments plus the step's counted
temporaries divided as its work is; ``fits_hbm`` compares it with
:data:`HBM_LIMIT` (``analysis.hw.H100_SXM.hbm_bytes``).  A stencil cell
(:func:`run_stencil_cell`) uses the reference's decomposition and
``tuning/model_rank``'s exchange.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --cells all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi \\
        --cells grok-1-314b:train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --stencil --mesh both
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import threading
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.analysis import roofline
from repro_torch.analysis.hw import H100_SXM
from repro_torch.checkpoint.reshard import NamedSharding
from repro_torch.configs import (ARCHS, SHAPES, get_arch, input_specs,
                                 shape_applicable)
from repro_torch.configs import stencil2d as st2d_cfg
from repro_torch.configs import stencil3d as st3d_cfg
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import attention, common, mamba as mamba_mod, \
    rwkv as rwkv_mod, transformer
from repro_torch.models.moe import capacity
from repro_torch.optim import AdamW
from repro_torch.runtime import mesh_rules
from repro_torch.runtime.mesh_rules import PartitionSpec as P
from repro_torch.runtime.trainer import (make_decode_step, make_prefill_step,
                                         make_train_step)
from repro_torch.tuning.model_rank import exchange_bytes_per_superstep
from repro_torch.tuning.space import MeshDecomposition

#: The device memory ``fits_hbm`` compares a cell's peak with: one H100's.
HBM_LIMIT = H100_SXM.hbm_bytes

# ---------------------------------------------------------------------------
# model-flops accounting (§Roofline's MODEL_FLOPS row)
# ---------------------------------------------------------------------------

def _param_counts(cfg, params):
    """(body, active) parameter counts; ``params``: the model, or its
    parameters."""
    total = common.param_count(params)
    d, v = cfg.d_model, cfg.vocab
    n_embed = v * d * cfg.num_codebooks
    if not cfg.tie_embeddings:
        n_embed += v * d * cfg.num_codebooks
    if cfg.frontend_dim:
        n_embed += cfg.frontend_dim * d
    n_body = total - n_embed

    n_expert = 0
    if cfg.moe is not None:
        moe_layers = sum(1 for l in cfg.pattern if l.ffn == "moe") \
            * cfg.units + sum(1 for l in cfg.tail if l.ffn == "moe")
        mats = 3 if cfg.mlp == "swiglu" else 2
        n_expert = moe_layers * cfg.moe.num_experts * mats * d * cfg.moe.d_ff
        frac = cfg.moe.top_k / cfg.moe.num_experts
        n_active = n_body - n_expert + int(n_expert * frac)
    else:
        n_active = n_body
    return n_body, n_active


def model_flops(cfg, shape, params) -> float:
    n_body, n_active = _param_counts(cfg, params)
    if shape.kind == "train":
        return 6.0 * n_active * shape.cells()
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.cells()
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


# ---------------------------------------------------------------------------
# cache shardings
# ---------------------------------------------------------------------------

def cache_pspecs(caches, cfg, mesh, *, long_context: bool):
    """Per-cache-type PartitionSpecs (see DESIGN §6), one per cache of
    ``caches`` (a layer's state has no leading unit axis here; one that
    has gets ``None`` for it, as the reference's stacked caches).

    decode_32k: batch over (pod,data); kv_heads over model if divisible else
    cache-seq over model.  long_500k (batch=1): sequence-parallel cache over
    all axes; recurrent states over model.
    """
    axes = tuple(mesh.axis_names)
    batch_axes = tuple(a for a in axes if a != "model")
    model_size = mesh.shape["model"]
    kv_div = (cfg.attn is not None and cfg.attn.kind == "gqa"
              and cfg.attn.n_kv_heads % model_size == 0)

    if long_context:
        b = None
        seq = batch_axes + (() if kv_div else ("model",))
        seq = seq if len(seq) > 1 else seq[0]
    else:
        b = batch_axes if len(batch_axes) > 1 else batch_axes[0]
        seq = None if kv_div else "model"

    def lead(leaf_ndim, base_ndim):
        return (None,) * (leaf_ndim - base_ndim)

    def one(c):
        if isinstance(c, attention.KVCache):
            ex = lead(c.k.ndim, 4)
            kvax = "model" if kv_div else None
            return attention.KVCache(
                k=P(*ex, b, seq, kvax, None),
                v=P(*ex, b, seq, kvax, None),
                pos=P(*ex, b, seq))
        if isinstance(c, attention.MLACache):
            ex = lead(c.c_kv.ndim, 3)
            sq = seq if not kv_div else "model"
            return attention.MLACache(
                c_kv=P(*ex, b, sq, None),
                k_rope=P(*ex, b, sq, None),
                pos=P(*ex, b, sq))
        if isinstance(c, mamba_mod.MambaState):
            ex = lead(c.ssm.ndim, 3)
            return mamba_mod.MambaState(
                ssm=P(*ex, b, "model", None),
                conv=P(*ex, b, None, "model"))
        if isinstance(c, rwkv_mod.RwkvState):
            ex = lead(c.wkv.ndim, 4)
            return rwkv_mod.RwkvState(
                wkv=P(*ex, b, "model", None, None),
                shift_tm=P(*ex, b, "model"),
                shift_cm=P(*ex, b, "model"))
        raise TypeError(type(c))

    return [one(c) for c in caches]


# ---------------------------------------------------------------------------
# the reference's stacked parameter layout
# ---------------------------------------------------------------------------

def reference_params(model) -> Dict[str, tuple]:
    """Each leaf of the reference's params tree: (shape, dtype, logical
    axes), unit layers stacked on a leading ``"unit"`` axis."""
    cfg = model.cfg
    axes = model.logical_axes()
    out = {}
    for name, p in model.named_parameters():
        leaf = transformer.reference_leaf(cfg, name)[0]
        if leaf in out:
            continue
        if leaf.startswith("units."):
            out[leaf] = ((cfg.units,) + tuple(p.shape), p.dtype,
                         ("unit",) + axes[name])
        else:
            out[leaf] = (tuple(p.shape), p.dtype, axes[name])
    return out


def _bytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def _batch_pspec(bax, t: torch.Tensor):
    return P(bax, *([None] * (t.ndim - 1)))


# ---------------------------------------------------------------------------
# counting a step with each layer body counted once per kind
# ---------------------------------------------------------------------------

def _layout(x):
    """A hashable description of a layer call's argument: tensors by
    shape, stride, dtype and whether they need a gradient."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype, x.requires_grad)
    if isinstance(x, dict):
        return tuple((k, _layout(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_layout(v) for v in x)
    return x


def _empty_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device="meta")


@dataclasses.dataclass
class _BodyCost:
    forward: tuple                 # (flops, bytes)
    backward: Optional[tuple]
    peak: int                      # the body's own temporaries at most
    saved: int                     # bytes it keeps for its backward
    out: torch.Tensor              # a tensor of the output's layout
    aux: Optional[Dict[str, torch.Tensor]]


def _counts(c: roofline.CostCounter) -> tuple:
    return c.flops, c.bytes


class _StandIn(torch.autograd.Function):
    """A layer body's place in the step: outputs of its layout; its
    forward and backward add the body's counts.  It keeps the body's
    saved bytes for its backward (dropped and recomputed under remat)."""

    @staticmethod
    def forward(ctx, memo, cost, x, *inputs):
        ctx.memo, ctx.cost = memo, cost
        ctx.layouts = [(t.shape, t.stride(), t.dtype) for t in (x,) + inputs]
        ctx.save_for_backward(torch.empty(cost.saved, dtype=torch.uint8,
                                          device="meta"))
        aux = cost.aux or {}
        return (_empty_like(cost.out),) + tuple(_empty_like(a)
                                                for a in aux.values())

    @staticmethod
    def backward(ctx, *grads):
        ctx.saved_tensors                  # a remat span recomputes here
        ctx.memo.counter.add(*ctx.cost.backward)
        return (None, None) + tuple(
            torch.empty_strided(s, st, dtype=dt, device="meta")
            if need else None
            for (s, st, dt), need in zip(ctx.layouts,
                                         ctx.needs_input_grad[2:]))


class _LayerMemo:
    """Counts each layer body once per (layer kind, input layout, grad
    mode) and lets the step run :class:`_StandIn` in its place (module
    docstring, part 4)."""

    def __init__(self, model, counter: roofline.CostCounter):
        self.counter = counter
        self.costs: Dict[tuple, _BodyCost] = {}
        for layer in model.layers:
            layer.forward = self._bound(layer)

    def _bound(self, layer):
        def forward(x, positions, weights, rope, cache=None, ring=None):
            return self.forward(layer, x, positions, weights, rope, cache,
                                ring)
        return forward

    def forward(self, layer, x, positions, weights, rope, cache, ring):
        grad = torch.is_grad_enabled()
        key = (layer.lcfg, _layout((x, positions, weights, rope, cache,
                                    ring)), grad,
               torch.is_inference_mode_enabled())
        cost = self.costs.get(key)
        if cost is None:
            cost = self.costs[key] = self._measure(
                layer, (x, positions, weights, rope, cache, ring))
        self.counter.add(*cost.forward, transient=cost.peak)
        params = [p for p in layer.parameters() if p.requires_grad]
        ws = list(weights.values())
        if not grad or not (x.requires_grad or params
                            or any(w.requires_grad for w in ws)):
            aux = None if cost.aux is None else \
                {k: _empty_like(v) for k, v in cost.aux.items()}
            return _empty_like(cost.out), aux
        outs = _StandIn.apply(self, cost, x, *ws, *params)
        aux = None if cost.aux is None else dict(zip(cost.aux, outs[1:]))
        return outs[0], aux

    def _measure(self, layer, args) -> _BodyCost:
        """The body's counts, on a thread of its own: no dispatch mode and
        no saved-tensor hook of the step reaches it."""
        grad = torch.is_grad_enabled()
        inference = torch.is_inference_mode_enabled()
        result = {}

        def run():
            try:
                result["cost"] = _measure_body(layer, args, grad, inference)
            except BaseException as e:       # noqa: BLE001  re-raised below
                result["error"] = e

        t = threading.Thread(target=run)
        t.start()
        t.join()
        if "error" in result:
            raise result["error"]
        return result["cost"]


def _fresh(t, grad: bool):
    if not isinstance(t, torch.Tensor):
        return t
    out = _empty_like(t)
    return out.requires_grad_(grad and t.requires_grad)


def _measure_body(layer, args, grad: bool, inference: bool) -> _BodyCost:
    x, positions, weights, rope, cache, ring = args
    x = _fresh(x, grad)
    weights = {k: _fresh(v, grad) for k, v in weights.items()}
    body = type(layer).forward
    if inference:
        with torch.inference_mode(), roofline.CostCounter() as fwd:
            y, aux = body(layer, x, positions, weights, rope, cache, ring)
        return _BodyCost(_counts(fwd), None, fwd.peak_temp_bytes, 0,
                         _empty_like(y), _aux_like(aux))
    with torch.set_grad_enabled(grad):
        with roofline.CostCounter() as fwd:
            y, aux = body(layer, x, positions, weights, rope, cache, ring)
        kept = fwd.live_bytes - y.numel() * y.element_size()
        backward = None
        peak = fwd.peak_temp_bytes
        if grad:
            inputs = [t for t in [x, *weights.values(),
                                  *layer.parameters()] if t.requires_grad]
            outs = [o for o in [y, *(aux or {}).values()]
                    if o.requires_grad]
            with roofline.CostCounter() as bwd:
                torch.autograd.grad(outs, inputs,
                                    grad_outputs=[_empty_like(o)
                                                  for o in outs],
                                    allow_unused=True)
            backward = _counts(bwd)
            peak = max(peak, fwd.live_bytes + bwd.peak_temp_bytes)
    return _BodyCost(_counts(fwd), backward, peak, max(kept, 0),
                     _empty_like(y), _aux_like(aux))


def _aux_like(aux):
    return None if aux is None else {k: _empty_like(v.detach())
                                     for k, v in aux.items()}


def count_step(model, fn, *args) -> roofline.CostCounter:
    """``fn(*args)`` (a step of ``model``) under a ``CostCounter``, each
    layer body counted once per kind and layout (module docstring)."""
    counter = roofline.CostCounter()
    _LayerMemo(model, counter)
    try:
        with counter:
            fn(*args)
    finally:
        for layer in model.layers:
            del layer.forward
    return counter


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def collective_bytes(cfg, shape, mesh, params, shardings, *, batch: int,
                     accum: int) -> Dict[str, float]:
    """Collective bytes per device of one step (module docstring, part 5).
    ``params``: :func:`reference_params`; ``shardings``: their
    ``NamedSharding``s; ``batch``: one batch shard's batch."""
    out = {k: 0.0 for k in roofline.COLLECTIVES}
    batch_axes = [a for a in mesh.axis_names if a != "model"]
    train = shape.kind == "train"
    passes = (2 + (cfg.remat != "none")) * accum if train else 1
    acc_size = getattr(torch, cfg.accum_dtype).itemsize
    for leaf, (shp, dtype, _) in params.items():
        sh = shardings[leaf]
        piece = math.prod(sh.shard_shape(shp, leaf))
        split = {a for e in sh.spec if e is not None
                 for a in ((e,) if isinstance(e, str) else e)}
        fsdp = math.prod(mesh.shape[a] for a in batch_axes if a in split)
        if fsdp > 1:
            out["all-gather"] += passes * _bytes((piece,), dtype)
            if train:
                out["reduce-scatter"] += accum * piece * fsdp * acc_size
        if train and any(mesh.shape[a] > 1 and a not in split
                         for a in batch_axes):
            out["all-reduce"] += accum * piece * acc_size
    tp = mesh.shape.get("model", 1)
    if tp > 1:
        seq = 1 if shape.kind == "decode" else shape.seq_len
        micro = batch // accum if train else batch
        elem = getattr(torch, cfg.compute_dtype).itemsize
        act = micro * seq * cfg.d_model * elem
        layers = cfg.units * len(cfg.pattern) + len(cfg.tail)
        tp_passes = passes if train else 1
        out["all-reduce"] += tp_passes * (2 * layers + 1) * act
        if cfg.moe is not None and cfg.moe.mode == "ep":
            moe_layers = sum(1 for l in cfg.pattern if l.ffn == "moe") \
                * cfg.units + sum(1 for l in cfg.tail if l.ffn == "moe")
            buf = micro * cfg.moe.num_experts * capacity(cfg.moe, seq) \
                * cfg.d_model * elem
            out["all-to-all"] += tp_passes * 2 * moe_layers * buf
    if shape.name == "long_500k" and cfg.attn is not None:
        attn_layers = sum(1 for l in cfg.pattern if l.kind == "attn") \
            * cfg.units + sum(1 for l in cfg.tail if l.kind == "attn")
        heads = cfg.attn.n_heads * (cfg.attn.v_dim if cfg.attn.kind == "mla"
                                    else cfg.attn.head_dim)
        out["all-reduce"] += attn_layers * batch * (heads + 2
                                                    * cfg.attn.n_heads) * 4
    return out


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _cell_rules(cfg, shape_name: str, multi_pod: bool):
    return mesh_rules.default_rules(
        multi_pod,
        seq_parallel_cache=(shape_name == "long_500k"),
        expert_parallel=(cfg.moe is not None and cfg.moe.mode == "ep"),
        # the HBM-tight giants span FSDP across pods instead of replicating
        fsdp_over_pod=(cfg.param_dtype == "bfloat16"),
    )


def cell_arguments(cfg, shape, mesh, rules, model) -> dict:
    """The cell's shardings and argument bytes per device: ``params``
    (:func:`reference_params`), ``param_sh`` (their ``NamedSharding``s),
    ``arg_bytes`` by part, ``batch_shards``, the batch axes ``bax``, and
    ``accum`` (the reference's rule).  Raises the ``ValueError`` of an
    uneven dim (module docstring, part 2)."""
    params = reference_params(model)
    param_sh = {leaf: NamedSharding(mesh, rules.pspec(axes))
                for leaf, (_, _, axes) in params.items()}
    param_b = sum(_bytes(param_sh[leaf].shard_shape(shp, leaf), dt)
                  for leaf, (shp, dt, _) in params.items())
    batch_axes = tuple(a for a in mesh.axis_names if a != "model")
    bax = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    n_batch_shards = math.prod(mesh.shape[a] for a in batch_axes)
    if shape.global_batch == 1:
        bax = None
    parts = {"params": param_b}
    accum = 1
    if shape.kind == "train":
        mdt = getattr(torch, cfg.moment_dtype)
        moment = sum(_bytes(param_sh[leaf].shard_shape(shp, leaf), mdt)
                     for leaf, (shp, _, _) in params.items())
        parts["opt_state"] = 2 * moment + 4            # mu, nu, int32 step
        accum = max(1, min(cfg.train_accum,
                           shape.global_batch // n_batch_shards))
    ins = input_specs(cfg, shape, model=model)
    caches = ins.pop("caches", None)
    parts["batch"] = sum(
        _bytes(NamedSharding(mesh, _batch_pspec(bax, t)).shard_shape(
            t.shape, f"batch/{k}"), t.dtype) for k, t in ins.items())
    if caches is not None:
        specs = cache_pspecs(caches, cfg, mesh,
                             long_context=(shape.name == "long_500k"))
        total = 0
        for i, (c, s) in enumerate(zip(caches, specs)):
            for field, t, spec in zip(c._fields, c, s):
                total += _bytes(NamedSharding(mesh, spec).shard_shape(
                    t.shape, f"caches/{i}/{field}"), t.dtype)
        parts["caches"] = total
    return {"params": params, "param_sh": param_sh, "arg_bytes": parts,
            "bax": bax, "accum": accum,
            "batch_shards": n_batch_shards if bax is not None else 1}


def step_counts(cfg, shape, model, *, batch: int, accum: int):
    """The cell's step run on meta tensors at ``batch`` (one batch
    shard's) under the counter: the ``CostCounter``."""
    ins = input_specs(cfg, shape, model=model, batch=batch)
    if shape.kind == "train":
        opt = AdamW(moment_dtype=cfg.moment_dtype)
        state = opt.init(dict(model.named_parameters()))
        step = make_train_step(model, opt, accum=accum)
        return count_step(model, step, state, None, ins)
    if shape.kind == "prefill":
        return count_step(model, make_prefill_step(model), ins)
    return count_step(model, make_decode_step(model), ins["caches"],
                      ins["tokens"], ins["pos"])


def run_lm_cell(arch: str, shape_name: str, multi_pod: bool,
                out_dir: Optional[str], verbose: bool = True):
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    if not shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "pure full attention; long_500k skipped "
                          "(DESIGN §5)"}

    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    mesh_name = _mesh_name(multi_pod)
    chips = mesh.size
    rules = _cell_rules(cfg, shape_name, multi_pod)
    model = transformer.build(cfg, device="meta", train=True)

    t0 = time.time()
    args = cell_arguments(cfg, shape, mesh, rules, model)
    shard_batch = shape.global_batch // args["batch_shards"]
    counter = step_counts(cfg, shape, model, batch=shard_batch,
                          accum=args["accum"])
    sharing = chips // args["batch_shards"]
    coll = collective_bytes(cfg, shape, mesh, args["params"],
                            args["param_sh"], batch=shard_batch,
                            accum=args["accum"])
    arg_b = sum(args["arg_bytes"].values())
    temp_b = counter.peak_temp_bytes // sharing
    peak = arg_b + temp_b
    t_count = time.time() - t0

    cell = roofline.analyze(
        arch=arch, shape=shape_name, mesh_name=mesh_name, chips=chips,
        flops=counter.flops / sharing, bytes_accessed=counter.bytes / sharing,
        collectives=coll, peak_bytes=peak,
        model_flops=model_flops(cfg, shape, model),
        notes=f"accum={args['accum']} batch_shard={shard_batch} "
              f"sharing={sharing}")
    result = cell.to_json()
    result["fits_hbm"] = bool(peak <= HBM_LIMIT)
    result["peak_bytes"] = int(peak)
    result["arg_bytes"] = int(arg_b)
    result["arg_breakdown"] = {k: int(v) for k, v in
                               args["arg_bytes"].items()}
    result["temp_bytes"] = int(temp_b)
    result["count_s"] = t_count
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: "
              f"count={t_count:.1f}s args={arg_b / 2**30:.2f}GiB "
              f"temp={temp_b / 2**30:.2f}GiB")
        print(f"  roofline: compute={cell.t_compute:.3e}s "
              f"memory={cell.t_memory:.3e}s coll={cell.t_collective:.3e}s "
              f"dominant={cell.dominant} useful={cell.useful_ratio:.2f} "
              f"fits_hbm={result['fits_hbm']}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{arch}__{shape_name}__{mesh_name}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(result, f, indent=1)
    return result


# ---------------------------------------------------------------------------
# stencil cells (the paper's own workload on the production mesh)
# ---------------------------------------------------------------------------

def stencil_decomposition(ndim: int, mesh, multi_pod: bool):
    """The reference's partition: grid axis 0 over the batch axes, axis 1
    over ``model``, a third axis whole; as shards per grid axis."""
    parts = [("pod", "data") if multi_pod else ("data",), ("model",)]
    parts += [()] * (ndim - 2)
    return MeshDecomposition(axis_shards=tuple(
        math.prod(mesh.shape[a] for a in p) for p in parts))


def run_stencil_cell(wl, multi_pod: bool, out_dir: Optional[str],
                     verbose: bool = True):
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    mesh_name = _mesh_name(multi_pod)
    chips = mesh.size
    spec = wl.spec
    plan = wl.plan()
    t0 = time.time()
    decomp = stencil_decomposition(spec.ndim, mesh, multi_pod)
    for d, (g, s) in enumerate(zip(wl.grid_shape, decomp.axis_shards)):
        if g % s:
            raise ValueError(f"{wl.name}: grid axis {d} ({g}) does not "
                             f"divide over {s} shards")
    local = decomp.local_shape(wl.grid_shape)
    padded = math.prod(n + 2 * plan.halo for n in local) * plan.itemsize
    exchange = exchange_bytes_per_superstep(spec, plan, decomp,
                                            wl.grid_shape)
    mf = (1.0 * spec.flops_per_cell * plan.par_time
          * math.prod(wl.grid_shape))
    cell = roofline.analyze(
        arch=wl.name, shape="superstep", mesh_name=mesh_name, chips=chips,
        flops=mf / chips, bytes_accessed=2 * padded,
        collectives={"collective-permute": exchange}, peak_bytes=2 * padded,
        model_flops=mf,
        notes=f"par_time={plan.par_time} halo={plan.halo}")
    dt = time.time() - t0
    result = cell.to_json()
    result["fits_hbm"] = bool(2 * padded <= HBM_LIMIT)
    result["peak_bytes"] = int(2 * padded)
    result["count_s"] = dt
    if verbose:
        print(f"[dryrun] stencil {wl.name} x {mesh_name}: {dt:.3f}s "
              f"dominant={cell.dominant} useful={cell.useful_ratio:.2f} "
              f"fits={result['fits_hbm']}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir,
                               f"stencil__{wl.name}__{mesh_name}.json"),
                  "w") as f:
            json.dump(result, f, indent=1)
    return result


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default="all",
                    help='"all" or comma list of arch:shape')
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--stencil", action="store_true",
                    help="run the paper's stencil workloads instead of LM")
    ap.add_argument("--out", default="build/repro_torch/dryrun")
    ap.add_argument("--radius", type=int, default=4)
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    if args.stencil:
        wls = {**st2d_cfg.workloads(args.radius),
               **st3d_cfg.workloads(args.radius)}
        for multi in meshes:
            for wl in wls.values():
                if wl.name.endswith("_paper") and multi:
                    continue  # single-chip-scale grid; pod run uses _pod
                try:
                    run_stencil_cell(wl, multi, args.out)
                except Exception:
                    failures.append((wl.name, multi))
                    traceback.print_exc()
    else:
        cells = []
        if args.cells == "all":
            for arch in ARCHS:
                for shape in SHAPES:
                    cells.append((arch, shape))
        else:
            for part in args.cells.split(","):
                arch, shape = part.split(":")
                cells.append((arch, shape))
        for multi in meshes:
            for arch, shape in cells:
                try:
                    run_lm_cell(arch, shape, multi, args.out)
                except Exception:
                    failures.append((f"{arch}:{shape}", multi))
                    traceback.print_exc()

    if failures:
        print(f"[dryrun] FAILURES: {failures}")
        raise SystemExit(1)
    print("[dryrun] all cells counted OK")


if __name__ == "__main__":
    main()
