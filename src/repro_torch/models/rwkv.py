"""RWKV-6 (Finch) blocks: data-dependent-decay linear attention and the
channel mix — counterpart of ``repro/models/rwkv.py``.

Time-mix recurrence (per head, k/v dims = head_dim):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with w_t = exp(-exp(w0 + lora_w(x~_t))) per channel, computed in float32,
and the five token-shift mixes (w, k, v, r, g) from a shared low-rank
MLP.  A prompt runs ``_wkv_chunked`` (the GLA form, the reference's
default ``impl``) or ``_wkv_scan`` (the per-token oracle), chunk
``min(cfg.chunk, S)``; decode runs one step of the recurrence.  The state
(``RwkvState``) is written in place: the time mix writes ``wkv`` and
``shift_tm``, the channel mix reads the old ``shift_cm`` and writes the
new one (the reference merges the two into one new state).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RwkvCfg
from repro_torch.models.common import Params, dense_param, zeros_param


class RwkvState(NamedTuple):
    wkv: torch.Tensor          # (B, H, hd, hd) float32
    shift_tm: torch.Tensor     # (B, d) last token seen by time-mix
    shift_cm: torch.Tensor     # (B, d) last token seen by channel-mix


#: Each leaf's logical axes (the reference's ``init_time_mix`` and
#: ``init_channel_mix``).
TIME_MIX_AXES = {
    "mu_x": (None,), "mix_w1": ("d_model", None),
    "mix_w2": (None, None, "d_model"), "mu": (None, None), "w0": (None,),
    "w_lora1": ("d_model", None), "w_lora2": (None, "d_model"),
    "wr": ("d_model", "rwkv_heads"), "wk": ("d_model", "rwkv_heads"),
    "wv": ("d_model", "rwkv_heads"), "wg": ("d_model", "rwkv_heads"),
    "u": (None, None), "ln_scale": (None,), "ln_bias": (None,),
    "wo": ("rwkv_heads", "d_model")}
CHANNEL_MIX_AXES = {"mu_k": (None,), "mu_r": (None,),
                    "wk": ("d_model", "d_ff"), "wv": ("d_ff", "d_model"),
                    "wr": ("d_model", None)}


def init_time_mix(gen: Optional[torch.Generator], d_model: int,
                  cfg: RwkvCfg, dtype, device=None) -> Params:
    """``mix_w2`` N(0, 1) cast to ``dtype`` then times 0.02; ``w0`` -0.6,
    ``u`` 0, ``ln_scale`` 1 and ``ln_bias`` 0 in float32 whatever
    ``dtype``."""
    H, hd, r = d_model // cfg.head_dim, cfg.head_dim, cfg.mix_lora
    f32 = dict(dtype=torch.float32, device=device)

    def dense(shape, scale=None):
        return dense_param(gen, shape, dtype, scale=scale, device=device)

    mix_w2 = torch.empty((5, r, d_model), **f32)
    if mix_w2.device.type != "meta":
        mix_w2.normal_(generator=gen)
    return {
        "mu_x": zeros_param((d_model,), dtype, device),
        "mix_w1": dense((d_model, 5 * r)),
        "mix_w2": mix_w2.to(dtype) * 0.02,
        "mu": zeros_param((5, d_model), dtype, device),
        "w0": torch.full((d_model,), -0.6, **f32),
        "w_lora1": dense((d_model, cfg.decay_lora)),
        "w_lora2": dense((cfg.decay_lora, d_model), scale=0.02),
        "wr": dense((d_model, d_model)),
        "wk": dense((d_model, d_model)),
        "wv": dense((d_model, d_model)),
        "wg": dense((d_model, d_model)),
        "u": torch.zeros((H, hd), **f32),
        "ln_scale": torch.ones((d_model,), **f32),
        "ln_bias": torch.zeros((d_model,), **f32),
        "wo": dense((d_model, d_model)),
    }


def init_channel_mix(gen: Optional[torch.Generator], d_model: int,
                     d_ff: int, dtype, device=None) -> Params:
    return {
        "mu_k": zeros_param((d_model,), dtype, device),
        "mu_r": zeros_param((d_model,), dtype, device),
        "wk": dense_param(gen, (d_model, d_ff), dtype, device=device),
        "wv": dense_param(gen, (d_ff, d_model), dtype, device=device),
        "wr": dense_param(gen, (d_model, d_model), dtype, device=device),
    }


def _token_shift(x, prev):
    """Shift right by one: position t sees token t-1.  prev: (B, d)."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _group_norm(x, scale, bias, H: int, eps: float = 64e-5):
    """Per-head LayerNorm over head_dim (official ln_x), population
    variance, in float32."""
    B, S, d = x.shape
    xh = x.reshape(B, S, H, d // H).float()
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, unbiased=False, keepdim=True)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(B, S, d) * scale + bias).to(x.dtype)


def _wkv_scan(r, k, v, w, u, h0, chunk: int):
    """The per-token recurrence (the oracle).

    r, k, v, w: (B, S, H, hd); u: (H, hd); h0: (B, H, hd, hd) float32."""
    S = r.shape[1]
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the chunk "
                         f"{chunk}")
    h, ys = h0, []
    for t in range(S):
        r_t, k_t, v_t, w_t = (x[:, t].float() for x in (r, k, v, w))
        kv = k_t[..., :, None] * v_t[..., None, :]              # (B,H,K,V)
        ys.append(torch.einsum("bhk,bhkv->bhv", r_t,
                               h + u[..., None] * kv))
        h = w_t[..., :, None] * h + kv
    return torch.stack(ys, dim=1), h


def _wkv_chunked(r, k, v, w, u, h0, chunk: int):
    """Chunked-parallel wkv (the flash-linear-attention / GLA form).

    Within a chunk of C tokens the recurrence unrolls to

        y_t = (r_t * e^{cum_{t-1}}) S_0
            + sum_{i<t} (r_t . (e^{cum_{t-1}-cum_i} * k_i)) v_i
            + (r_t . (u * k_t)) v_t

    with cum = cumsum(log w): every kept exponent is <= 0."""
    B, S, H, hd = r.shape
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the chunk "
                         f"{chunk}")
    C = chunk
    idx = torch.arange(C, device=r.device)
    tri = (idx[:, None] > idx[None, :])[None, :, :, None, None]  # t > i
    h, ys = h0, []
    for c0 in range(0, S, C):
        rc, kc, vc, wc = (x[:, c0:c0 + C].float() for x in (r, k, v, w))
        logw = torch.log(wc)
        cum = torch.cumsum(logw, dim=1)
        cum_prev = cum - logw                                   # cum[t-1]
        y_cross = torch.einsum("bchk,bhkv->bchv", rc * torch.exp(cum_prev),
                               h)
        diff = cum_prev[:, :, None] - cum[:, None]              # (B,t,i,H,K)
        Dm = torch.where(tri, torch.exp(diff), 0.0)
        Wti = torch.einsum("bthk,btihk,bihk->bthi", rc, Dm, kc)
        y_intra = torch.einsum("bthi,bihv->bthv", Wti, vc)
        bonus = torch.einsum("bthk,hk,bthk->bth", rc, u, kc)
        ys.append(y_cross + y_intra + bonus[..., None] * vc)
        cum_last = cum[:, -1]                                   # (B,H,K)
        E = torch.exp(cum_last[:, None] - cum)                  # <= 1
        h = torch.exp(cum_last)[..., None] * h \
            + torch.einsum("bchk,bchv->bhkv", kc * E, vc)
    return torch.cat(ys, dim=1), h


def _mixed_inputs(p: Params, x, shifted):
    """The five data-dependent token-shift mixes, order w, k, v, r, g."""
    B, S, d = x.shape
    xx = shifted - x
    base = x + xx * p["mu_x"]
    lora = torch.tanh(base @ p["mix_w1"])                       # (B,S,5r)
    r5 = lora.reshape(B, S, 5, -1)
    deltas = torch.einsum("bsnr,nrd->bsnd", r5, p["mix_w2"])    # (B,S,5,d)
    return [x + xx * (p["mu"][i] + deltas[:, :, i, :]) for i in range(5)]


def apply_time_mix(p: Params, x, cfg: RwkvCfg, *,
                   state: Optional[RwkvState] = None):
    """x: (B, S, d).  Returns (out, state), the state written in place
    (``wkv``, ``shift_tm``) when given."""
    B, S, d = x.shape
    H, hd = d // cfg.head_dim, cfg.head_dim
    prev = state.shift_tm if state is not None else x.new_zeros((B, d))
    xw, xk, xv, xr, xg = _mixed_inputs(p, x, _token_shift(x, prev))

    r = (xr @ p["wr"]).reshape(B, S, H, hd)
    k = (xk @ p["wk"]).reshape(B, S, H, hd)
    v = (xv @ p["wv"]).reshape(B, S, H, hd)
    g = F.silu(xg @ p["wg"])
    w_log = p["w0"] + torch.tanh(xw @ p["w_lora1"]) @ p["w_lora2"]
    w = torch.exp(-torch.exp(w_log.float())).reshape(B, S, H, hd)

    h0 = state.wkv if state is not None \
        else torch.zeros((B, H, hd, hd), dtype=torch.float32,
                         device=x.device)
    if S == 1 and state is not None:
        r1, k1, v1, w1 = (t[:, 0].float() for t in (r, k, v, w))
        kv = k1[..., :, None] * v1[..., None, :]
        y = torch.einsum("bhk,bhkv->bhv", r1,
                         h0 + p["u"][..., None] * kv)[:, None]
        h = w1[..., :, None] * h0 + kv
    else:
        impl = _wkv_chunked if cfg.impl == "chunked" else _wkv_scan
        y, h = impl(r, k, v, w, p["u"], h0, min(cfg.chunk, S))

    y = _group_norm(y.reshape(B, S, d).to(x.dtype), p["ln_scale"],
                    p["ln_bias"], H)
    out = (y * g) @ p["wo"]
    if state is not None:
        state.wkv.copy_(h)
        state.shift_tm.copy_(x[:, -1, :])
    return out, state


def apply_channel_mix(p: Params, x, *, state: Optional[RwkvState] = None):
    """x: (B, S, d).  Reads ``state.shift_cm`` and writes the new one in
    place.  Returns (out, state)."""
    B, S, d = x.shape
    prev = state.shift_cm if state is not None else x.new_zeros((B, d))
    xx = _token_shift(x, prev) - x
    xk = x + xx * p["mu_k"]
    xr = x + xx * p["mu_r"]
    kk = torch.square(F.relu(xk @ p["wk"]))
    out = torch.sigmoid(xr @ p["wr"]) * (kk @ p["wv"])
    if state is not None:
        state.shift_cm.copy_(x[:, -1, :])
    return out, state


def init_state(cfg: RwkvCfg, d_model: int, batch: int, dtype,
               device=None) -> RwkvState:
    H, hd = d_model // cfg.head_dim, cfg.head_dim
    return RwkvState(
        wkv=torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                        device=device),
        shift_tm=torch.zeros((batch, d_model), dtype=dtype, device=device),
        shift_cm=torch.zeros((batch, d_model), dtype=dtype, device=device),
    )
