"""Mamba-1 selective SSM block (jamba's mixer) — counterpart of
``repro/models/mamba.py``.

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t     (channel i, state j)
    y_t = C_t . h_t + D * x_t

with data-dependent (dt, B, C), a depthwise causal convolution and SiLU
gating.  The scan runs token by token in float32, as the reference's does
(its chunks are remat boundaries and change no value; their
``S % chunk == 0`` rule is kept).  Decode is one step of the recurrence;
its state (``MambaState``) is written in place.

Softplus is ``jax.nn.softplus``, ``logaddexp(x, 0)``: ``F.softplus``
turns linear above 20, so the exact form is used.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MambaCfg
from repro_torch.models.common import Params, dense_param, zeros_param


class MambaState(NamedTuple):
    ssm: torch.Tensor      # (B, d_inner, d_state) float32
    conv: torch.Tensor     # (B, d_conv - 1, d_inner) trailing inputs


#: Each leaf's logical axes (the reference's ``init_mamba``).
AXES = {"in_proj": ("d_model", "mamba_inner"), "conv_w": (None, "mamba_inner"),
        "conv_b": ("mamba_inner",), "x_proj": ("mamba_inner", None),
        "dt_proj": (None, "mamba_inner"), "dt_bias": ("mamba_inner",),
        "a_log": ("mamba_inner", None), "d": ("mamba_inner",),
        "out_proj": ("mamba_inner", "d_model")}


def dt_rank(cfg: MambaCfg, d_model: int) -> int:
    return cfg.dt_rank or max(1, -(-d_model // 16))


def init_mamba(gen: Optional[torch.Generator], d_model: int, cfg: MambaCfg,
               dtype, device=None) -> Params:
    """S4D-real ``a_log`` = log(1..d_state); ``dt_bias`` the inverse
    softplus of a log-uniform draw in [1e-3, 1e-1]; ``a_log`` and ``d``
    float32 whatever ``dtype``."""
    di, ds = cfg.d_inner, cfg.d_state
    rank = dt_rank(cfg, d_model)

    def dense(shape, scale=None):
        return dense_param(gen, shape, dtype, scale=scale, device=device)

    u = torch.empty((di,), dtype=torch.float32, device=device)
    a_log = torch.empty((di, ds), dtype=torch.float32, device=device)
    if u.device.type != "meta":
        u.uniform_(math.log(1e-3), math.log(1e-1), generator=gen)
        a_log.copy_(torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                           device=device)).expand(di, ds))
    return {
        "in_proj": dense((d_model, 2 * di)),
        "conv_w": dense((cfg.d_conv, di), scale=0.5),
        "conv_b": zeros_param((di,), dtype, device),
        "x_proj": dense((di, rank + 2 * ds)),
        "dt_proj": dense((rank, di)),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))).to(dtype),
        "a_log": a_log,
        "d": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": dense((di, d_model)),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, exact at every x."""
    return torch.logaddexp(x, x.new_zeros(()))


def _conv_causal(x, w, b, prev: Optional[torch.Tensor] = None):
    """Depthwise causal conv over seq.  x: (B, S, di); w: (K, di).

    ``prev``: (B, K-1, di) trailing context (decode); zeros for a
    prompt.  Taps summed 0..K-1 in order.  Returns (out, new trailing
    context)."""
    K = w.shape[0]
    S = x.shape[1]
    if prev is None:
        prev = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([prev, x], dim=1)
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return out + b, xp[:, -(K - 1):]


def _ssm_scan(dt, B_t, C_t, xin, a_log, d, h0, chunk: int):
    """Selective scan.  dt, xin: (B, S, di); B_t, C_t: (B, S, ds).

    Returns (y (B, S, di), h_final)."""
    S = xin.shape[1]
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the chunk "
                         f"{chunk}")
    A = -torch.exp(a_log)                                  # (di, ds)
    h, ys = h0, []
    for t in range(S):
        da = torch.exp(dt[:, t, :, None] * A)              # (B, di, ds)
        h = da * h + (dt[:, t] * xin[:, t])[..., None] * B_t[:, t, None, :]
        ys.append(torch.einsum("bis,bs->bi", h, C_t[:, t]))
    return torch.stack(ys, dim=1) + xin * d, h


def apply_mamba(params: Params, x, cfg: MambaCfg, *,
                state: Optional[MambaState] = None
                ) -> Tuple[torch.Tensor, Optional[MambaState]]:
    """x: (B, S, d_model).  A prompt when state is None; else single-step
    decode (S == 1) carrying (ssm, conv) state, written in place."""
    B, S, _ = x.shape
    di, ds = cfg.d_inner, cfg.d_state
    dtype = x.dtype

    xz = x @ params["in_proj"]
    xin, z = xz.chunk(2, dim=-1)
    xin, conv_tail = _conv_causal(xin, params["conv_w"], params["conv_b"],
                                  None if state is None else state.conv)
    xin = F.silu(xin)

    proj = xin @ params["x_proj"]
    rank = proj.shape[-1] - 2 * ds
    dt_raw, b_t, c_t = proj.split([rank, ds, ds], dim=-1)
    dt = softplus(dt_raw @ params["dt_proj"] + params["dt_bias"].to(dtype))

    dt32, b32, c32, x32 = (t.float() for t in (dt, b_t, c_t, xin))
    if state is None:
        h0 = torch.zeros((B, di, ds), dtype=torch.float32, device=x.device)
        y, _ = _ssm_scan(dt32, b32, c32, x32, params["a_log"], params["d"],
                         h0, min(cfg.chunk, S))
    else:
        A = -torch.exp(params["a_log"])
        da = torch.exp(dt32[:, 0, :, None] * A)
        h = da * state.ssm + (dt32[:, 0] * x32[:, 0])[..., None] \
            * b32[:, 0, None, :]
        y = torch.einsum("bis,bs->bi", h, c32[:, 0])[:, None, :] \
            + x32 * params["d"]
        state.ssm.copy_(h)
        state.conv.copy_(conv_tail)

    y = y.to(dtype) * F.silu(z)
    return y @ params["out_proj"], state


def init_state(cfg: MambaCfg, batch: int, dtype, device=None) -> MambaState:
    return MambaState(
        ssm=torch.zeros((batch, cfg.d_inner, cfg.d_state),
                        dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=dtype,
                         device=device),
    )
