"""Mixture-of-Experts layer: top-k routing with capacity — counterpart of
``repro/models/moe.py`` (its math; the ``ep``/``tp`` modes only shard and
are left out).

Dispatch is index-based: per sequence, each token's k experts get a
position-in-expert from a cumulative count in token order; tokens past
``capacity`` are dropped (GShard-style), as the reference drops them:

* ``torch.topk`` promises no order among equal values, and bfloat16
  router logits tie often; ``jax.lax.top_k`` puts the lower index first.
  The experts are picked by a stable descending sort, which does too.
* JAX drops an out-of-range scatter (``inp.at[...].add``) and clamps an
  out-of-range gather (``combine_one``); torch raises on both.  A dropped
  (token, choice) is written to a spare slot past ``cap`` that is then
  cut off, and read from the clamped slot with its weight times ``keep``
  (0), as the reference reads it.
* The combine accumulates over the k choices in order, in the expert
  output's dtype.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import MoECfg
from repro_torch.models.common import ACTIVATIONS, Params, dense_param


def axes(cfg: MoECfg) -> Dict[str, tuple]:
    """Each leaf's logical axes (the reference's ``_w_axes``): experts
    over ``experts`` in expert-parallel mode (where ``d_ff`` then finds
    its mesh axis taken), else replicated."""
    e = "experts" if cfg.mode == "ep" else None
    w_in, w_out = (e, "d_model", "d_ff"), (e, "d_ff", "d_model")
    return {"router": ("d_model", None), "wi_gate": w_in, "wi_up": w_in,
            "wi": w_in, "wo": w_out}


def init_moe(gen: Optional[torch.Generator], d_model: int, cfg: MoECfg,
             dtype, mlp_kind: str, device=None) -> Params:
    E, F = cfg.num_experts, cfg.d_ff

    def dense(shape):
        return dense_param(gen, shape, dtype, device=device)

    p = {"router": dense((d_model, E))}
    if mlp_kind == "swiglu":
        p["wi_gate"] = dense((E, d_model, F))
        p["wi_up"] = dense((E, d_model, F))
    else:
        p["wi"] = dense((E, d_model, F))
    p["wo"] = dense((E, F, d_model))
    return p


def capacity(cfg: MoECfg, seq: int) -> int:
    c = int(seq * cfg.top_k / cfg.num_experts * cfg.capacity_factor)
    return max(cfg.top_k, (c + 3) // 4 * 4)


def _route_one(x, router_logits, cfg: MoECfg, cap: int):
    """Routing for each sequence: x (..., S, d), logits (..., S, E).

    Returns (expert_idx, slot_idx, weight, keep, probs), the first four
    (..., S, k), ``probs`` (..., S, E) float32."""
    S, E = router_logits.shape[-2:]
    k = cfg.top_k
    probs = torch.softmax(router_logits.float(), dim=-1)
    # jax.lax.top_k: descending, the lower index first among equals
    weight, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    weight, expert_idx = weight[..., :k], expert_idx[..., :k]
    weight = weight / torch.clamp_min(weight.sum(-1, keepdim=True), 1e-9)

    # position of each (token, choice) within its expert: flattened in
    # token order (earlier tokens first), counted per expert
    flat_e = expert_idx.reshape(*expert_idx.shape[:-2], S * k)
    onehot = torch.nn.functional.one_hot(flat_e, E)          # (..., S*k, E)
    pos_in_e = torch.cumsum(onehot, dim=-2) - 1
    slot = torch.gather(pos_in_e, -1, flat_e[..., None])[..., 0]
    keep = slot < cap
    return (expert_idx, slot.reshape(expert_idx.shape),
            weight.to(x.dtype), keep.reshape(expert_idx.shape), probs)


def apply_moe(params: Params, x, cfg: MoECfg, mlp_kind: str,
              act: str) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (out, aux), aux = {lb_loss, z_loss, dropped_frac}."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    cap = capacity(cfg, S)
    f = ACTIVATIONS[act]

    logits = x @ params["router"]                              # (B, S, E)
    expert_idx, slot, weight, keep, probs = _route_one(x, logits, cfg, cap)

    # dispatch: every kept (token, choice) owns its (expert, slot); the
    # dropped ones go to the spare slot ``cap``, cut off below
    bidx = torch.arange(B, device=x.device)[:, None, None].expand(B, S, k)
    upd = x[:, :, None, :] * keep[..., None].to(x.dtype)       # (B,S,k,d)
    inp = x.new_zeros((B, E, cap + 1, d))
    inp[bidx, expert_idx, torch.where(keep, slot, cap)] = upd
    inp = inp[:, :, :cap]

    if mlp_kind == "swiglu":
        h = f(torch.einsum("becd,edf->becf", inp, params["wi_gate"])) \
            * torch.einsum("becd,edf->becf", inp, params["wi_up"])
    else:
        h = f(torch.einsum("becd,edf->becf", inp, params["wi"]))
    out_e = torch.einsum("becf,efd->becd", h, params["wo"])

    # combine: the gather clamped as JAX clamps it, weighted by keep,
    # accumulated over the k choices in order
    g = out_e[bidx, expert_idx, torch.clamp(slot, max=cap - 1)]  # (B,S,k,d)
    w = weight * keep.to(weight.dtype)
    y = out_e.new_zeros((B, S, d))
    for j in range(k):
        y = y + g[..., j, :] * w[..., j, None]

    # aux losses (float32): Switch load balance + router z-loss
    me = probs.mean(dim=(0, 1))                                # (E,)
    dispatch_frac = torch.nn.functional.one_hot(
        expert_idx[..., 0], E).float().mean(dim=(0, 1))
    lb = E * torch.sum(me * dispatch_frac)
    lse = torch.logsumexp(logits.float(), dim=-1)
    z = torch.mean(torch.square(lse))
    aux = {"lb_loss": cfg.lb_loss_weight * lb,
           "z_loss": cfg.router_z_weight * z,
           "dropped_frac": 1.0 - torch.mean(keep.float())}
    return y, aux
