"""Shared model components: initialisers, norms, RoPE, MLPs, softcap —
counterpart of ``repro/models/common.py``.

The reference's initialisers return ``Param(value, logical_axes)`` trees
for GSPMD; on one device the axes are no-ops, so here an initialiser
returns a tensor and the model keeps it as an ``nn.Parameter``.  Every
random initialiser takes an explicit ``torch.Generator`` (on the device
it draws on) and the reference's distribution:

* dense weights (``dense_param``): a standard normal truncated to
  [-2, 2], not renormalised, times ``1/sqrt(fan_in)``;
* embeddings: N(0, 1);
* RMS-norm scales: zeros (applied as ``1 + scale``); layer norms: ones
  and zeros.

The functions keep the reference's dtype steps (norms and RoPE in
float32, cast back to the input's dtype).  Where the model shares work
between layers it takes it precomputed, so that what a layer runs is
what the tests hold against the reference: ``rms_norm`` takes the norm's
``1 + scale`` (the reference's ``rms_norm_headwise``, and ``apply_norm``'s
RMS branch), ``rotate`` takes ``rope_tables`` (the reference's
``apply_rope``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def param_count(values) -> int:
    """Elements of a module's parameters, or of an iterable of tensors."""
    if isinstance(values, torch.nn.Module):
        values = values.parameters()
    return sum(int(v.numel()) for v in values)


# ---- initialisers ------------------------------------------------------------

def dense_param(gen: Optional[torch.Generator], shape, dtype,
                scale: Optional[float] = None, device=None) -> torch.Tensor:
    """Truncated-normal init with 1/sqrt(fan_in) default scale, drawn in
    float32 and cast to ``dtype``.  On the meta device nothing is drawn."""
    v = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    if v.device.type != "meta":
        torch.nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0, generator=gen)
        v.mul_(scale)
    return v.to(dtype)


def zeros_param(shape, dtype, device=None) -> torch.Tensor:
    """The reference's ``zeros_param``: a zero leaf (a bias, a mix, a
    zero-centred scale)."""
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


#: Each leaf's logical axes (the reference's ``Param.axes``), which
#: ``runtime/mesh_rules`` maps to mesh axes: a norm's, an MLP's, the
#: embedding table's.
NORM_AXES = {"scale": ("d_model",), "bias": ("d_model",)}
MLP_AXES = {"wi_gate": ("d_model", "d_ff"), "wi_up": ("d_model", "d_ff"),
            "wi": ("d_model", "d_ff"), "wo": ("d_ff", "d_model")}
EMBED_AXES = ("vocab", "d_model")


class LogicalAxes:
    """A leaf of a spec tree: one parameter's logical axis names, as the
    reference's ``models.common.LogicalAxes`` (not a tuple, so a tree
    walk does not descend into it)."""

    __slots__ = ("names",)

    def __init__(self, names):
        self.names = tuple(names)

    def __repr__(self):
        return f"LogicalAxes{self.names}"

    def __eq__(self, other):
        return isinstance(other, LogicalAxes) and self.names == other.names

    def __hash__(self):
        return hash(self.names)


def init_norm(d: int, dtype, kind: str, device=None) -> Params:
    if kind == "rms":          # weight stored zero-centered, applied as (1+w)
        return {"scale": zeros_param((d,), dtype, device)}
    if kind == "layer":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": zeros_param((d,), dtype, device)}
    raise ValueError(kind)


def init_mlp(gen: Optional[torch.Generator], d_model: int, d_ff: int, dtype,
             kind: str, device=None) -> Params:
    if kind == "swiglu":
        names = (("wi_gate", (d_model, d_ff)), ("wi_up", (d_model, d_ff)),
                 ("wo", (d_ff, d_model)))
    elif kind == "gelu_mlp":
        names = (("wi", (d_model, d_ff)), ("wo", (d_ff, d_model)))
    else:
        raise ValueError(kind)
    return {n: dense_param(gen, s, dtype, device=device) for n, s in names}


def init_embed(gen: Optional[torch.Generator], vocab: int, d_model: int,
               dtype, device=None) -> torch.Tensor:
    v = torch.empty((vocab, d_model), dtype=torch.float32, device=device)
    if v.device.type != "meta":
        v.normal_(generator=gen)
    return v.to(dtype)


def take_embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


# ---- normalization ----------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS over the last axis times ``weight``, float32 ``1 + scale`` of
    the reference's zero-centred scale (the model makes every layer's in
    one add per call).  Over head_dim this is the reference's QK-norm,
    ``rms_norm_headwise(x, scale)``."""
    xf = x.float()
    return F.rms_norm(xf, xf.shape[-1:], weight, eps).to(x.dtype)


def apply_norm(params: Params, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    if kind == "rms":
        return rms_norm(x, 1.0 + params["scale"].float(), eps)
    if kind == "layer":
        xf = x.float()
        return F.layer_norm(xf, xf.shape[-1:], params["scale"].float(),
                            params["bias"].float(), eps=eps).to(x.dtype)
    raise ValueError(kind)


# ---- rotary / sinusoidal positions ------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the rotation angles, each (..., seq, 1, head_dim):
    ``(cos, cos)`` and ``(-sin, sin)`` of the half's angles, in float32.
    One table serves every layer of a step that shares ``theta`` (the
    reference recomputes it per call: the same values)."""
    freqs = rope_freqs(head_dim, theta, device=positions.device)
    ang = positions[..., None].float() * freqs                # (..., s, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    return (torch.cat([cos, cos], dim=-1)[..., None, :],
            torch.cat([-sin, sin], dim=-1)[..., None, :])


def rotate(x: torch.Tensor, tables) -> torch.Tensor:
    """The reference's ``apply_rope(x, positions, theta)`` given
    ``rope_tables(positions, head_dim, theta)``; x (..., s, heads, hd).

    Pair layout: (x[..., :half], x[..., half:]) rotated jointly — the
    HF/NeoX convention used by all assigned archs.  ``x (cos, cos) +
    (x2, x1) (-sin, sin)`` is the reference's ``[x1 cos - x2 sin,
    x1 sin + x2 cos]`` (a negation and the order of one addition change
    no bit)."""
    cos, sin = tables
    xf = x.float()
    return (xf * cos + xf.roll(x.shape[-1] // 2, dims=-1) * sin).to(x.dtype)


def sinusoidal_embedding(positions: torch.Tensor, d: int) -> torch.Tensor:
    """MusicGen-style sinusoidal position embedding; positions (..., s)."""
    half = d // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32,
                                            device=positions.device) / half))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---- activations / capping --------------------------------------------------

def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """gemma2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "gelu": gelu_tanh,
    "silu": F.silu,
    "relu": F.relu,
}


# ---- MLPs --------------------------------------------------------------------

def apply_mlp(params: Params, x: torch.Tensor, kind: str,
              act: str = "silu") -> torch.Tensor:
    f = ACTIVATIONS[act]
    if kind == "swiglu":
        h = f(x @ params["wi_gate"]) * (x @ params["wi_up"])
    elif kind == "gelu_mlp":
        h = f(x @ params["wi"])
    else:
        raise ValueError(kind)
    return h @ params["wo"]
