"""Attention — counterpart of ``repro/models/attention.py``.

* GQA with optional sliding window (gemma local layers), attention-logit
  softcap (gemma2) and QK-norm (gemma3).
* MLA (minicpm3): low-rank q/kv compression with decoupled RoPE at
  ``rope_dim``; prefill materialises per-head keys and values (``v``
  padded to ``nope + rope`` for the shared chunked softmax, sliced after),
  decode runs the absorbed form against a ``(c_kv, k_rope)`` cache.
* Prefill uses the reference's chunked online softmax over key chunks
  (no S x S materialisation), with its ``Sk % chunk == 0`` rule.
* Decode uses a full cache or a ring (sliding-window) cache; masking is
  positional (``cache.pos``, -1 = empty), so ring wraparound needs no
  special casing.  The GQA query position is ``max(cache.pos)`` per batch
  row, as in the reference (``decode_attention``): entries a previous
  request left at later positions of the same cache stay unmasked.  The
  MLA query position is the step's own (``positions[:, :1]``, the
  reference's ``apply_mla``), so there such entries are masked.

Plain torch ops, the reference's math and dtype steps: ``q`` is scaled in
its own dtype, scores and softmax are float32, ``v`` is cast to float32.
No library attention kernel: the reference computes attention in
``jnp`` outside any Pallas kernel.

Where this differs from the reference: decode writes the new key, value
(or latent) and position into the cache tensors in place and returns the
same cache (the reference's ``.at[].set`` returns new arrays; the values
are the same, and a serving cache of gigabytes is not copied per step).
``apply_gqa``/``apply_mla`` take their RoPE tables, norm weights and
decode slot and mask made by the caller (``transformer.LMModel`` makes
each once per call for all the layers that share it), and
``decode_attention`` takes the mask (``decode_bias``) in place of the
window.

Cache layout: (batch, cache_len, kv_heads, head_dim); MLA (batch,
cache_len, kv_lora) and (batch, cache_len, rope_dim).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import AttnCfg
from repro_torch.models.common import (Params, dense_param, rms_norm,
                                       rotate, softcap, zeros_param)

NEG_INF = -2.0e38

# =============================================================================
# Caches
# =============================================================================

class KVCache(NamedTuple):
    """GQA cache; for window layers cache_len == window (ring buffer)."""
    k: torch.Tensor            # (B, L, KV, D)
    v: torch.Tensor            # (B, L, KV, D)
    pos: torch.Tensor          # (B, L) int32 absolute positions, -1 = empty


class MLACache(NamedTuple):
    c_kv: torch.Tensor         # (B, L, kv_lora)
    k_rope: torch.Tensor       # (B, L, rope_dim)
    pos: torch.Tensor          # (B, L) int32 absolute positions, -1 = empty


class RingStep(NamedTuple):
    """One decode step's write slot and mask for a cache whose ``pos``
    already holds the step's position (``write_positions``), made once
    for every layer sharing that ``pos`` tensor and window (GQA:
    ``decode_bias``; MLA: ``mla_decode_bias``)."""
    bidx: torch.Tensor         # (B,) batch rows
    slot: torch.Tensor         # (B,) int64 write slot of the position
    bias: torch.Tensor         # (B, L) float32 additive decode mask


def init_kv_cache(cfg: AttnCfg, batch: int, length: int, dtype,
                  device=None) -> KVCache:
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((batch, length), -1, dtype=torch.int32,
                       device=device),
    )


def init_mla_cache(cfg: AttnCfg, batch: int, length: int, dtype,
                   device=None) -> MLACache:
    return MLACache(
        c_kv=torch.zeros((batch, length, cfg.kv_lora), dtype=dtype,
                         device=device),
        k_rope=torch.zeros((batch, length, cfg.rope_dim), dtype=dtype,
                           device=device),
        pos=torch.full((batch, length), -1, dtype=torch.int32,
                       device=device),
    )


def _ring_slot(step: torch.Tensor, length: int) -> torch.Tensor:
    """Write slot for absolute position ``step`` in a length-L ring."""
    return torch.remainder(step, length)


def write_positions(pos: torch.Tensor, positions: torch.Tensor):
    """Write ``positions`` (B, 1) into the ring ``pos`` (B, L); returns
    (batch rows, write slots)."""
    slot = _ring_slot(positions[:, 0], pos.shape[1]).long()
    bidx = torch.arange(pos.shape[0], device=pos.device)
    pos[bidx, slot] = positions[:, 0].to(pos.dtype)
    return bidx, slot


def decode_bias(pos: torch.Tensor, window: Optional[int]) -> torch.Tensor:
    """The decode mask of a cache's positions as an additive float32 bias
    (B, L): entries at or before the query position ``max(pos)`` (and
    within the window)."""
    q_pos = pos.amax(dim=1, keepdim=True)                    # (B, 1)
    ok = (pos >= 0) & (pos <= q_pos)
    if window is not None:
        ok &= (q_pos - pos) < window
    return torch.where(ok, 0.0, NEG_INF)


def mla_decode_bias(pos: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """The MLA decode mask as an additive float32 bias (B, L): entries at
    or before the step's own position ``positions[:, :1]`` (not
    ``max(pos)``: a stale entry at a later position is masked)."""
    ok = (pos >= 0) & (pos <= positions[:, :1])
    return torch.where(ok, 0.0, NEG_INF)


def init_cache(cfg: AttnCfg, batch: int, length: int,
               window: Optional[int], dtype, device=None):
    """Window layers get a ring cache of size min(window, length)."""
    L = min(window, length) if window is not None else length
    if cfg.kind == "mla":
        return init_mla_cache(cfg, batch, L, dtype, device)
    return init_kv_cache(cfg, batch, L, dtype, device)


# =============================================================================
# Chunked online-softmax attention (prefill)
# =============================================================================

def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: Optional[int]) -> torch.Tensor:
    """Causal (+ sliding window) mask as an additive float32 bias.

    q_pos: (..., Sq), k_pos: (..., Sk) -> bias (..., Sq, Sk).
    """
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    ok = (dk <= dq) & (dk >= 0)
    if window is not None:
        ok &= (dq - dk) < window
    return torch.where(ok, 0.0, NEG_INF).float()


def chunked_attention(q, k, v, q_pos, k_pos, *, window: Optional[int],
                      cap: Optional[float], scale: float,
                      chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over key chunks.

    q: (B, Sq, H, D); k, v: (B, Sk, KV, D); positions integer (B, S*).
    Returns (B, Sq, H, D) in q's dtype.  H = KV * G.
    """
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    chunk = min(chunk, Sk)
    if Sk % chunk:
        raise ValueError(f"key length {Sk} is not a multiple of the chunk "
                         f"{chunk}")

    qg = (q * scale).reshape(B, Sq, KV, G, D).float()
    m = torch.full((B, Sq, KV, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Sq, KV, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, KV, G, D), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, Sk, chunk):
        kc = k[:, c0:c0 + chunk].float()
        vc = v[:, c0:c0 + chunk].float()
        s = torch.einsum("bskgd,bckd->bskgc", qg, kc)
        s = softcap(s, cap)
        bias = _mask_bias(q_pos, k_pos[:, c0:c0 + chunk], window)
        s = s + bias[:, :, None, None, :]           # broadcast over KV, G
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bskgc,bckd->bskgd", p,
                                                   vc)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-37)
    return out.reshape(B, Sq, H, D).to(q.dtype)


# =============================================================================
# GQA
# =============================================================================

#: Each leaf's logical axes (the reference's ``init_gqa``/``init_mla``).
GQA_AXES = {"wq": ("d_model", "heads"), "wk": ("d_model", "kv_heads"),
            "wv": ("d_model", "kv_heads"), "wo": ("heads", "d_model"),
            "q_scale": (None,), "k_scale": (None,)}
MLA_AXES = {"wq_a": ("d_model", None), "q_norm": (None,),
            "wq_b": (None, "heads"), "wkv_a": ("d_model", None),
            "kv_norm": (None,), "wk_b": (None, "heads"),
            "wv_b": (None, "heads"), "wo": ("heads", "d_model")}


def init_gqa(gen: Optional[torch.Generator], d_model: int, cfg: AttnCfg,
             dtype, device=None) -> Params:
    """Projections stored flattened 2-D ((d, H*hd) etc.), as the reference
    stores them; apply reshapes to (B, S, H, hd) after the matmul."""
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {name: dense_param(gen, shape, dtype, device=device)
         for name, shape in (("wq", (d_model, H * D)),
                             ("wk", (d_model, KV * D)),
                             ("wv", (d_model, KV * D)),
                             ("wo", (H * D, d_model)))}
    if cfg.qk_norm:
        p["q_scale"] = zeros_param((D,), dtype, device)
        p["k_scale"] = zeros_param((D,), dtype, device)
    return p


def _qk_scale(cfg: AttnCfg) -> float:
    return cfg.query_scale if cfg.query_scale is not None \
        else 1.0 / math.sqrt(cfg.head_dim)


def apply_gqa(params: Params, x, cfg: AttnCfg, *, positions,
              window: Optional[int], rope=None, qk_weights=None,
              cache: Optional[KVCache] = None,
              ring: Optional[RingStep] = None, chunk: int = 1024):
    """x: (B, S, d).  Prefill when cache is None; else one-step decode
    (S == 1) writing into the cache.  Returns (out, cache).

    What the model makes once per call for every layer comes in made:
    ``rope``, ``common.rope_tables`` of these positions at the layer's
    theta (with ``cfg.use_rope``); ``qk_weights``, the QK-norm's
    ``1 + q_scale`` and ``1 + k_scale`` in float32 (with ``cfg.qk_norm``);
    ``ring`` (decode), this step's slot and mask from ``write_positions``
    and ``decode_bias``, the position already written into ``cache.pos``.
    """
    B, S, _ = x.shape
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, S, H, D)
    k = (x @ params["wk"]).reshape(B, S, KV, D)
    v = (x @ params["wv"]).reshape(B, S, KV, D)

    if cfg.qk_norm:
        wq, wk = qk_weights
        q, k = rms_norm(q, wq), rms_norm(k, wk)
    if cfg.use_rope:
        # q's and k's heads side by side: one rotation (per head, so the
        # values are those of two separate calls)
        qk = rotate(torch.cat([q, k], dim=2), rope)         # (B, S, H+KV, D)
        q, k = qk[:, :, :H], qk[:, :, H:]
    scale = _qk_scale(cfg)

    if cache is None:
        out = chunked_attention(q, k, v, positions, positions, window=window,
                                cap=cfg.softcap, scale=scale, chunk=chunk)
    else:
        bidx, slot, bias = ring
        cache.k[bidx, slot] = k[:, 0]
        cache.v[bidx, slot] = v[:, 0]
        out = decode_attention(q, cache, bias=bias, cap=cfg.softcap,
                               scale=scale)
    return out.reshape(B, S, H * D) @ params["wo"], cache


def decode_attention(q, cache: KVCache, *, bias: torch.Tensor,
                     cap: Optional[float], scale: float) -> torch.Tensor:
    """Single-token attention over a (possibly ring) cache.

    q: (B, 1, H, D); ``bias``: ``decode_bias(cache.pos, window)``, whose
    query position is ``max(cache.pos)`` per row.  The cache is read as a
    heads-major float32 copy of K and of V (the reference's f32 scores
    and f32 ``v``): at a serving cache of thousands of entries that copy
    costs about three times the cache's bytes every layer and step
    (PERF.md section 7).
    """
    B, _, H, D = q.shape
    KV = cache.k.shape[2]
    G = H // KV

    def heads_major(t):      # (B, L, KV, D) -> float32 (B, KV, L, D)
        return t.transpose(1, 2).to(torch.float32,
                                    memory_format=torch.contiguous_format)

    qg = (q * scale).reshape(B, KV, G, D).float()
    s = qg @ heads_major(cache.k).transpose(-1, -2)        # (B, KV, G, L)
    s = softcap(s, cap)
    s = s + bias[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    out = p @ heads_major(cache.v)                         # (B, KV, G, D)
    return out.reshape(B, 1, H, D).to(q.dtype)


# =============================================================================
# MLA (minicpm3)
# =============================================================================

def init_mla(gen: Optional[torch.Generator], d_model: int, cfg: AttnCfg,
             dtype, device=None) -> Params:
    """Up-projections stored flattened (rank, H*dim), as the reference
    stores them; ``q_norm``/``kv_norm`` are zero-centred RMS scales."""
    H = cfg.n_heads
    qk_dim = cfg.nope_dim + cfg.rope_dim

    def dense(shape):
        return dense_param(gen, shape, dtype, device=device)

    return {
        "wq_a": dense((d_model, cfg.q_lora)),
        "q_norm": zeros_param((cfg.q_lora,), dtype, device),
        "wq_b": dense((cfg.q_lora, H * qk_dim)),
        "wkv_a": dense((d_model, cfg.kv_lora + cfg.rope_dim)),
        "kv_norm": zeros_param((cfg.kv_lora,), dtype, device),
        "wk_b": dense((cfg.kv_lora, H * cfg.nope_dim)),
        "wv_b": dense((cfg.kv_lora, H * cfg.v_dim)),
        "wo": dense((H * cfg.v_dim, d_model)),
    }


def _mla_qkr(params: Params, x, cfg: AttnCfg, rope, norm_weights):
    """Shared q / compressed-kv projections; ``rope``: the tables at
    ``rope_dim``; ``norm_weights``: ``1 + q_norm``, ``1 + kv_norm``."""
    B, S, _ = x.shape
    qk_dim = cfg.nope_dim + cfg.rope_dim
    wq, wkv = norm_weights
    ql = rms_norm(x @ params["wq_a"], wq)
    q = (ql @ params["wq_b"]).reshape(B, S, cfg.n_heads, qk_dim)
    q_nope = q[..., :cfg.nope_dim]
    q_rope = rotate(q[..., cfg.nope_dim:], rope)

    kv = x @ params["wkv_a"]
    c_kv = rms_norm(kv[..., :cfg.kv_lora], wkv)
    # the shared (per-token, head-less) rope key, on a singleton head axis
    k_rope = rotate(kv[..., None, cfg.kv_lora:], rope)[..., 0, :]
    return q_nope, q_rope, c_kv, k_rope


def apply_mla(params: Params, x, cfg: AttnCfg, *, positions, rope,
              norm_weights, cache: Optional[MLACache] = None,
              ring: Optional[RingStep] = None, chunk: int = 1024):
    """x: (B, S, d).  Prefill (materialised) when cache is None; else the
    absorbed one-step decode writing into the cache, ``ring`` holding the
    step's slot and ``mla_decode_bias``.  Returns (out, cache)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    qk_dim = cfg.nope_dim + cfg.rope_dim
    scale = cfg.query_scale if cfg.query_scale is not None \
        else 1.0 / math.sqrt(qk_dim)
    q_nope, q_rope, c_kv, k_rope = _mla_qkr(params, x, cfg, rope,
                                            norm_weights)

    if cache is None:
        k_nope = (c_kv @ params["wk_b"]).reshape(B, S, H, cfg.nope_dim)
        v = (c_kv @ params["wv_b"]).reshape(B, S, H, cfg.v_dim)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            B, S, H, cfg.rope_dim)], dim=-1)
        v_p = torch.nn.functional.pad(v, (0, qk_dim - cfg.v_dim))
        out = chunked_attention(q, k, v_p, positions, positions, window=None,
                                cap=None, scale=scale, chunk=chunk)
        out = out[..., :cfg.v_dim]
    else:
        bidx, slot, bias = ring
        cache.c_kv[bidx, slot] = c_kv[:, 0]
        cache.k_rope[bidx, slot] = k_rope[:, 0]
        # q_eff[h, l] = q_nope[h, :] @ wk_b[l, h, :]  (absorbed form)
        wk_b = params["wk_b"].reshape(cfg.kv_lora, H, cfg.nope_dim)
        q_eff = torch.einsum("bshk,lhk->bshl", q_nope, wk_b)
        s = torch.einsum("bshl,bLl->bshL", (q_eff * scale).float(),
                         cache.c_kv.float())
        s = s + torch.einsum("bshk,bLk->bshL", (q_rope * scale).float(),
                             cache.k_rope.float())
        s = s + bias[:, None, None, :]
        p = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bshL,bLl->bshl", p,
                           cache.c_kv.float()).to(x.dtype)
        wv_b = params["wv_b"].reshape(cfg.kv_lora, H, cfg.v_dim)
        out = torch.einsum("bshl,lhk->bshk", ctx, wv_b)
    return out.reshape(B, S, H * cfg.v_dim) @ params["wo"], cache


# =============================================================================
# Unified entry
# =============================================================================

def init_attention(gen: Optional[torch.Generator], d_model: int,
                   cfg: AttnCfg, dtype, device=None) -> Params:
    if cfg.kind == "mla":
        return init_mla(gen, d_model, cfg, dtype, device)
    return init_gqa(gen, d_model, cfg, dtype, device)


def apply_attention(params: Params, x, cfg: AttnCfg, *, positions,
                    window: Optional[int] = None, rope=None,
                    qk_weights=None, cache=None,
                    ring: Optional[RingStep] = None, chunk: int = 1024):
    """``qk_weights``: GQA's QK-norm weights, or MLA's ``1 + q_norm`` and
    ``1 + kv_norm`` (MLA has no window)."""
    if cfg.kind == "mla":
        return apply_mla(params, x, cfg, positions=positions, rope=rope,
                         norm_weights=qk_weights, cache=cache, ring=ring,
                         chunk=chunk)
    return apply_gqa(params, x, cfg, positions=positions, window=window,
                     rope=rope, qk_weights=qk_weights, cache=cache,
                     ring=ring, chunk=chunk)
