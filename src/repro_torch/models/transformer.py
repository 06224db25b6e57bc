"""LM model factory for the dense GQA family — counterpart of
``repro/models/transformer.py``.

A model is ``units`` repetitions of ``cfg.pattern`` plus a tail for
non-divisible layer counts (gemma3's 34 = 5 x [5 local + 1 global] + 4).
The reference stacks unit parameters on a leading axis and scans them;
here ``LMModel.layers`` holds one module per layer in the order the scan
runs them: layer ``u * P + p`` for unit ``u`` and pattern position ``p``,
then the tail (``convert.lm_params_from_numpy`` unstacks a reference
tree in that order).

Mixed precision as the reference does it (``_cast_layer_params``): layer
weights, norm scales included, are used in ``compute_dtype``.  A layer
holds its weights as that cast, made once when they are placed (at init
or load; the values equal a cast at use); norm scales and biases, which
the norms then read in float32, are held as the float32 copy of that
cast (the same values, one cast fewer per call).  The embedding table, the
untied head and ``final_norm`` stay in ``param_dtype``.  The tied head
multiplies a ``compute_dtype`` activation by the ``param_dtype`` table,
which JAX promotes: with float32 params it is a float32 product, which
PyTorch runs without TF32 by default.  Padded-vocab logits are -1e9.

Not ported yet (ROADMAP A10): MLA attention, MoE, Mamba and RWKV layers,
``num_codebooks > 1`` (musicgen) and the ``frontend_dim`` projector
(llava); building such a config raises ``NotImplementedError``.  The
serving path needs no autograd: parameters are made with
``requires_grad=False``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, LayerCfg
from repro_torch.executor import _resolve_device
from repro_torch.models import attention, common
from repro_torch.models.common import apply_norm, softcap

#: attention leaves that are norm scales (QK-norm), held like the norms
NORM_SCALES = frozenset({"q_scale", "k_scale"})


@dataclasses.dataclass(frozen=True)
class ModelOutputs:
    """The reference's forward output; ``aux`` (the MoE losses) comes
    with the MoE slice."""
    logits: torch.Tensor


def unported(cfg: ArchConfig) -> Optional[str]:
    """What of ``cfg`` the port cannot build yet, or None."""
    layers = cfg.pattern + cfg.tail
    if any(l.kind == "mamba" for l in layers):
        return "Mamba layers (ROADMAP A10, item 3)"
    if any(l.kind == "rwkv" for l in layers):
        return "RWKV layers (ROADMAP A10, item 3)"
    if any(l.ffn == "moe" for l in layers):
        return "MoE FFNs (ROADMAP A10, item 2)"
    if cfg.attn is not None and cfg.attn.kind == "mla":
        return "MLA attention (ROADMAP A10, item 1)"
    if cfg.frontend_dim:
        return "the frontend_dim projector (ROADMAP A10, item 1)"
    if cfg.num_codebooks > 1:
        return "num_codebooks > 1 (ROADMAP A10, item 4)"
    return None


class Layer(nn.Module):
    """One attention layer and its dense FFN, with the reference's norms;
    every weight held in ``compute_dtype``."""

    def __init__(self, cfg: ArchConfig, lcfg: LayerCfg,
                 gen: Optional[torch.Generator], device):
        super().__init__()
        self.cfg, self.lcfg = cfg, lcfg
        pdt = getattr(torch, cfg.param_dtype)
        compute = getattr(torch, cfg.compute_dtype)

        def placed(tensors, norm=False):
            # the reference keeps param_dtype and casts at use
            return nn.ParameterDict({
                n: nn.Parameter(t.to(pdt).to(compute).to(
                    torch.float32 if norm or n in NORM_SCALES else compute),
                    requires_grad=False)
                for n, t in tensors.items()})

        def norm():
            return placed(common.init_norm(cfg.d_model, pdt, cfg.norm,
                                           device), norm=True)

        self.pre_norm = norm()
        self.mixer = placed(attention.init_attention(gen, cfg.d_model,
                                                     cfg.attn, pdt, device))
        if cfg.post_norms:
            self.post_mixer_norm = norm()
        self.ffn_norm = norm()
        self.ffn = placed(common.init_mlp(gen, cfg.d_model, cfg.d_ff, pdt,
                                          cfg.mlp, device))
        if cfg.post_norms:
            self.post_ffn_norm = norm()

    def rms_scales(self) -> List[Tuple[str, torch.Tensor]]:
        """(name, scale) of every RMS scale of the layer."""
        names = [n for n in ("pre_norm", "post_mixer_norm", "ffn_norm",
                             "post_ffn_norm")
                 if self.cfg.norm == "rms" and hasattr(self, n)]
        out = [(n, getattr(self, n)["scale"]) for n in names]
        if self.cfg.attn.qk_norm:
            out += [(n, self.mixer[n]) for n in sorted(NORM_SCALES)]
        return out

    def forward(self, x, positions, weights, rope, cache=None, ring=None):
        """``weights``: ``1 + scale`` of the layer's RMS scales by name
        (``LMModel._rms_weights``); ``rope``: the RoPE tables at the
        layer's theta; ``ring``: the decode step's slot and mask."""
        cfg, lcfg = self.cfg, self.lcfg
        qk = (weights["q_scale"], weights["k_scale"]) \
            if cfg.attn.qk_norm else None

        def norm(name, t):
            if cfg.norm == "rms":
                return common.rms_norm(t, weights[name])
            return apply_norm(getattr(self, name), t, cfg.norm)

        h = norm("pre_norm", x)
        out, cache = attention.apply_attention(
            self.mixer, h, cfg.attn, positions=positions, window=lcfg.window,
            rope=rope, qk_weights=qk, cache=cache, ring=ring)
        if cfg.post_norms:
            out = norm("post_mixer_norm", out)
        x = x + out.to(x.dtype)

        h = norm("ffn_norm", x)
        out = common.apply_mlp(self.ffn, h, cfg.mlp, cfg.act)
        if cfg.post_norms:
            out = norm("post_ffn_norm", out)
        return x + out.to(x.dtype), cache


class LMModel(nn.Module):
    """The dense GQA language model; parameters on ``device`` (None: the
    card, RP110 without one; ``"cpu"`` and ``"meta"`` as asked), drawn
    from ``generator``."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = _resolve_device(device)
        self.cfg = cfg.validate()
        missing = unported(cfg)
        if missing:
            raise NotImplementedError(
                f"{cfg.name}: {missing} is not ported to PyTorch yet")
        pdt = getattr(torch, cfg.param_dtype)
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        pv = cfg.padded_vocab
        self.embed = nn.Parameter(common.init_embed(generator, pv,
                                                    cfg.d_model, pdt, device),
                                  requires_grad=False)
        self.lm_head = None if cfg.tie_embeddings else nn.Parameter(
            common.dense_param(generator, (cfg.d_model, pv), pdt,
                               device=device),
            requires_grad=False)
        self.final_norm = nn.ParameterDict({
            n: nn.Parameter(t, requires_grad=False) for n, t in
            common.init_norm(cfg.d_model, pdt, cfg.norm, device).items()})
        self.layer_cfgs: Tuple[LayerCfg, ...] = (
            cfg.pattern * cfg.units + cfg.tail)
        self.layers = nn.ModuleList(Layer(cfg, lcfg, generator, device)
                                    for lcfg in self.layer_cfgs)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------- embedding

    def _embed(self, tokens, positions):
        cfg = self.cfg
        x = common.take_embed(self.embed, tokens)
        if cfg.embed_scale:
            x = (x.float() * math.sqrt(float(cfg.d_model))).to(x.dtype)
        x = x.to(self.compute_dtype)
        if cfg.pos == "sinusoidal":
            pe = common.sinusoidal_embedding(positions, cfg.d_model)
            x = x + pe.to(x.dtype)
        return x

    def embed_inputs(self, tokens):
        """tokens: (B, S) -> (x, positions)."""
        B, S = tokens.shape[:2]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
        return self._embed(tokens, positions), positions

    def _ropes(self, positions) -> Dict[float, tuple]:
        """One rotation table per RoPE theta the layers use."""
        attn = self.cfg.attn
        if not attn.use_rope:
            return {}
        return {t: common.rope_tables(positions, attn.head_dim, t)
                for t in {self._theta(l) for l in self.layer_cfgs}}

    def _theta(self, lcfg: LayerCfg) -> float:
        return lcfg.rope_theta if lcfg.rope_theta is not None \
            else self.cfg.attn.rope_theta

    def _rms_weights(self) -> List[Dict[str, torch.Tensor]]:
        """Every layer's RMS weights ``1 + scale`` (float32, as the norms
        use them), made in one foreach add per call of the model rather
        than one add per norm."""
        named = [layer.rms_scales() for layer in self.layers]
        flat = [t for per in named for _, t in per]
        added = iter(torch._foreach_add(flat, 1.0) if flat else ())
        return [{n: next(added) for n, _ in per} for per in named]

    # ---------------------------------------------------------------- forward

    def forward(self, tokens) -> ModelOutputs:
        """tokens: (B, S) -> logits (B, S, padded_vocab), float32."""
        x, positions = self.embed_inputs(tokens)
        ropes = self._ropes(positions)
        for lcfg, layer, w in zip(self.layer_cfgs, self.layers,
                                  self._rms_weights()):
            x, _ = layer(x, positions, w, ropes.get(self._theta(lcfg)))
        x = apply_norm(self.final_norm, x, self.cfg.norm)
        return ModelOutputs(logits=self._head(x))

    def _head(self, x):
        cfg = self.cfg
        w = self.embed.T if cfg.tie_embeddings else self.lm_head
        dt = torch.promote_types(x.dtype, w.dtype)
        logits = softcap((x.to(dt) @ w.to(dt)).float(), cfg.logit_softcap)
        if cfg.padded_vocab != cfg.vocab:
            # padded-vocab logits (Megatron-style) are never sampled
            logits[..., cfg.vocab:] = -1e9
        return logits

    # ---------------------------------------------------------------- decode

    def init_caches(self, batch: int,
                    cache_len: int) -> List[attention.KVCache]:
        """One cache per layer, in layer order, in ``compute_dtype``.
        Layers whose caches have one length share one ``pos`` tensor:
        every layer writes the same positions, so theirs are equal."""
        caches, shared = [], {}
        for lcfg in self.layer_cfgs:
            c = attention.init_cache(self.cfg.attn, batch, cache_len,
                                     lcfg.window, self.compute_dtype,
                                     self.device)
            caches.append(c._replace(pos=shared.setdefault(c.pos.shape[1],
                                                           c.pos)))
        return caches

    def _ring_steps(self, caches, pos) -> List[attention.RingStep]:
        """Write this step's position into each ``pos`` tensor (one per
        ring length, ``init_caches``) once and make each (length, window)
        mask once: the slot and mask every layer would compute from it."""
        slots, steps = {}, {}
        keys = [(c.pos.shape[1], l.window)
                for l, c in zip(self.layer_cfgs, caches)]
        for (n, window), c in zip(keys, caches):
            if n not in slots:
                slots[n] = attention.write_positions(c.pos, pos)
            if (n, window) not in steps:
                steps[(n, window)] = attention.RingStep(
                    *slots[n], attention.decode_bias(c.pos, window))
        return [steps[k] for k in keys]

    def decode_step(self, caches, tokens, pos):
        """One decode step.  tokens: (B, 1); pos: (B, 1) absolute.

        Writes into ``caches`` and returns (logits (B, 1, V), caches)."""
        x = self._embed(tokens, pos)
        ropes = self._ropes(pos)
        rings = self._ring_steps(caches, pos)
        for lcfg, layer, cache, ring, w in zip(
                self.layer_cfgs, self.layers, caches, rings,
                self._rms_weights()):
            x, _ = layer(x, pos, w, ropes.get(self._theta(lcfg)),
                         cache=cache, ring=ring)
        x = apply_norm(self.final_norm, x, self.cfg.norm)
        return self._head(x), caches


def build(cfg: ArchConfig, *, device=None, seed: int = 0) -> LMModel:
    """The model on ``device`` (as ``LMModel``), its weights drawn there
    from ``torch.Generator(...).manual_seed(seed)``."""
    dev = _resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev).manual_seed(seed)
    return LMModel(cfg, device=dev, generator=gen)
