"""LM model factory for all ten architectures — counterpart of
``repro/models/transformer.py``.

A model is ``units`` repetitions of ``cfg.pattern`` plus a tail for
non-divisible layer counts (gemma3's 34 = 5 x [5 local + 1 global] + 4).
The reference stacks unit parameters on a leading axis and scans them;
here ``LMModel.layers`` holds one module per layer in the order the scan
runs them: layer ``u * P + p`` for unit ``u`` and pattern position ``p``,
then the tail (``convert.lm_params_from_numpy`` unstacks a reference
tree in that order).

Layer kinds: attention (GQA or MLA), Mamba, RWKV time mix; FFN kinds:
dense (SwiGLU/GeLU), MoE, RWKV channel mix.  llava's projector maps
precomputed frontend embeddings (``frontend_dim``) to ``d_model`` and
prepends them; musicgen embeds ``num_codebooks`` token streams (summed)
and predicts each with its own head, logits (B, S, K, V).

Mixed precision as the reference does it (``_cast_layer_params``): layer
weights, norm scales included, are used in ``compute_dtype``, except the
``KEEP_F32`` leaves (decay, SSM and group-norm parameters), which are
used as stored.  Two builds hold them differently and compute the same
values:

* the serving build (``train=False``) holds a layer's weights as that
  cast, made once when they are placed (at init or load), and its norm
  scales and biases, which the norms read in float32, as the float32
  copy of the cast; every parameter has ``requires_grad=False``;
* the training build (``train=True``) holds every parameter in
  ``param_dtype`` (the ``KEEP_F32`` leaves as the reference makes them)
  with ``requires_grad=True``, and casts the layer weights at each use,
  so the gradient reaches the stored value.  Its forward runs under
  ``cfg.remat`` while autograd records: ``"unit"`` one
  ``torch.utils.checkpoint`` over each unit of ``len(pattern)`` layers,
  ``"layer"`` one per layer; the tail is never recomputed, as in the
  reference.

The embedding table(s), the frontend projector, the untied head and
``final_norm`` stay in ``param_dtype``.  The tied head multiplies a
``compute_dtype`` activation by the ``param_dtype`` table, which JAX
promotes: with float32 params it is a float32 product, which PyTorch
runs without TF32 by default.  Padded-vocab logits are -1e9.

Decode state is written in place: attention caches (``KVCache``,
``MLACache``), ``MambaState`` and ``RwkvState``; the training forward
takes none.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, LayerCfg
from repro_torch.executor import _resolve_device
from repro_torch.models import attention, common, mamba, moe, rwkv
from repro_torch.models.common import apply_norm, softcap

#: mixer leaves that are zero-centred RMS scales (GQA's QK-norm, MLA's
#: latent norms), held like the norms
NORM_SCALES = frozenset({"q_scale", "k_scale", "q_norm", "kv_norm"})
#: leaves never cast to ``compute_dtype`` (the reference's ``_KEEP_F32``)
KEEP_F32 = frozenset({"a_log", "d", "w0", "u", "ln_scale", "ln_bias",
                      "dt_bias"})
#: the auxiliary losses a forward sums over its MoE layers
AUX_KEYS = ("lb_loss", "z_loss")


@dataclasses.dataclass(frozen=True)
class ModelOutputs:
    """The reference's forward output: logits and the summed MoE losses
    (``AUX_KEYS``, float32 zeros without MoE layers)."""
    logits: torch.Tensor
    aux: Dict[str, torch.Tensor]


class Layer(nn.Module):
    """One mixer (attention, Mamba or RWKV time mix) and its FFN (dense,
    MoE or RWKV channel mix), with the reference's norms; every weight
    held in ``compute_dtype`` but the ``KEEP_F32`` leaves, or with
    ``train`` in ``param_dtype`` and cast at use."""

    def __init__(self, cfg: ArchConfig, lcfg: LayerCfg,
                 gen: Optional[torch.Generator], device, train: bool = False):
        super().__init__()
        self.cfg, self.lcfg, self.train_build = cfg, lcfg, train
        pdt = getattr(torch, cfg.param_dtype)
        self.compute = getattr(torch, cfg.compute_dtype)
        d = cfg.d_model

        def held(name, t, norm):
            if name in KEEP_F32:
                return t                      # used as stored
            t = t.to(pdt)
            return t if train else self._cast(name, t, norm)

        def placed(tensors, norm=False):
            return nn.ParameterDict({
                n: nn.Parameter(held(n, t, norm), requires_grad=train)
                for n, t in tensors.items()})

        def norm():
            return placed(common.init_norm(d, pdt, cfg.norm, device),
                          norm=True)

        self.pre_norm = norm()
        if lcfg.kind == "attn":
            mixer = attention.init_attention(gen, d, cfg.attn, pdt, device)
            mixer_axes = attention.MLA_AXES if cfg.attn.kind == "mla" \
                else attention.GQA_AXES
        elif lcfg.kind == "mamba":
            mixer = mamba.init_mamba(gen, d, cfg.mamba, pdt, device)
            mixer_axes = mamba.AXES
        elif lcfg.kind == "rwkv":
            mixer = rwkv.init_time_mix(gen, d, cfg.rwkv, pdt, device)
            mixer_axes = rwkv.TIME_MIX_AXES
        else:
            raise ValueError(lcfg.kind)
        self.mixer = placed(mixer)
        if cfg.post_norms:
            self.post_mixer_norm = norm()
        self.ffn_norm = norm()
        if lcfg.ffn == "dense":
            ffn = common.init_mlp(gen, d, cfg.d_ff, pdt, cfg.mlp, device)
            ffn_axes = common.MLP_AXES
        elif lcfg.ffn == "moe":
            ffn = moe.init_moe(gen, d, cfg.moe, pdt, cfg.mlp, device)
            ffn_axes = moe.axes(cfg.moe)
        elif lcfg.ffn == "rwkv":
            ffn = rwkv.init_channel_mix(gen, d, cfg.d_ff, pdt, device)
            ffn_axes = rwkv.CHANNEL_MIX_AXES
        else:
            raise ValueError(lcfg.ffn)
        self.ffn = placed(ffn)
        if cfg.post_norms:
            self.post_ffn_norm = norm()
        #: each parameter's logical axes, as the reference's initialisers
        #: give them (``LMModel.logical_axes``)
        self.axes: Dict[str, tuple] = {}
        for module, table in (("mixer", mixer_axes), ("ffn", ffn_axes)):
            for n in getattr(self, module):
                self.axes[f"{module}.{n}"] = table[n]
        for module in ("pre_norm", "post_mixer_norm", "ffn_norm",
                       "post_ffn_norm"):
            for n in getattr(self, module, ()):
                self.axes[f"{module}.{n}"] = common.NORM_AXES[n]

    def _cast(self, name: str, t: torch.Tensor, norm: bool) -> torch.Tensor:
        """A stored weight as the layer uses it: cast to ``compute_dtype``
        (the reference's cast at use; a norm's scale or bias, and a
        mixer's RMS scale, then read in float32), a ``KEEP_F32`` leaf as
        it is."""
        if name in KEEP_F32:
            return t
        t = t.to(self.compute)
        return t.float() if norm or name in NORM_SCALES else t

    def _use(self, name: str, t: torch.Tensor, norm: bool) -> torch.Tensor:
        """A parameter as the layer uses it: held so by the serving build,
        cast from the stored value by the training build."""
        return self._cast(name, t, norm) if self.train_build else t

    def used(self, module: str) -> Dict[str, torch.Tensor]:
        """The weights of ``module`` (``"mixer"``, ``"ffn"`` or a norm) as
        the layer uses them (``_use``)."""
        params = getattr(self, module)
        if not self.train_build:
            return params
        norm = module not in ("mixer", "ffn")
        return {n: self._use(n, t, norm) for n, t in params.items()}

    def rms_scales(self) -> List[Tuple[str, torch.Tensor]]:
        """(name, scale as used) of every RMS scale of the layer."""
        names = [n for n in ("pre_norm", "post_mixer_norm", "ffn_norm",
                             "post_ffn_norm")
                 if self.cfg.norm == "rms" and hasattr(self, n)]
        out = [(n, self.used(n)["scale"]) for n in names]
        return out + [(n, self._use(n, self.mixer[n], False))
                      for n in sorted(NORM_SCALES) if n in self.mixer]

    def forward(self, x, positions, weights, rope, cache=None, ring=None):
        """``weights``: ``1 + scale`` of the layer's RMS scales by name
        (``LMModel._rms_weights``); ``rope``: the RoPE tables of an
        attention layer; ``cache``: the layer's decode state; ``ring``:
        an attention layer's decode slot and mask.  Returns (x, the MoE
        losses or None)."""
        cfg, lcfg = self.cfg, self.lcfg
        mixer, ffn = self.used("mixer"), self.used("ffn")

        def norm(name, t):
            if cfg.norm == "rms":
                return common.rms_norm(t, weights[name])
            return apply_norm(self.used(name), t, cfg.norm)

        h = norm("pre_norm", x)
        if lcfg.kind == "attn":
            names = ("q_norm", "kv_norm") if cfg.attn.kind == "mla" \
                else ("q_scale", "k_scale")
            out, _ = attention.apply_attention(
                mixer, h, cfg.attn, positions=positions,
                window=lcfg.window, rope=rope,
                qk_weights=tuple(weights[n] for n in names)
                if names[0] in mixer else None,
                cache=cache, ring=ring)
        elif lcfg.kind == "mamba":
            out, _ = mamba.apply_mamba(mixer, h, cfg.mamba, state=cache)
        else:
            out, _ = rwkv.apply_time_mix(mixer, h, cfg.rwkv, state=cache)
        if cfg.post_norms:
            out = norm("post_mixer_norm", out)
        x = x + out.to(x.dtype)

        h = norm("ffn_norm", x)
        aux = None
        if lcfg.ffn == "dense":
            out = common.apply_mlp(ffn, h, cfg.mlp, cfg.act)
        elif lcfg.ffn == "moe":
            out, aux = moe.apply_moe(ffn, h, cfg.moe, cfg.mlp, cfg.act)
        else:
            # reads the state's old shift_cm (the time mix left it)
            out, _ = rwkv.apply_channel_mix(ffn, h, state=cache)
        if cfg.post_norms:
            out = norm("post_ffn_norm", out)
        return x + out.to(x.dtype), aux


def reference_leaf(cfg: ArchConfig, name: str) -> Tuple[str, Optional[int]]:
    """The leaf of the reference's params tree that holds the parameter
    ``name``, and the unit it is stacked at: unit layer ``u * P + p``'s
    ``<rest>`` is slice ``u`` of ``units.<p>.<rest>`` (``P`` the pattern's
    length), tail layer ``units * P + p``'s is ``tail.<p>.<rest>``, the
    others keep their name."""
    top, _, rest = name.partition(".")
    if top != "layers":
        return name, None
    i, _, rest = rest.partition(".")
    P, i = len(cfg.pattern), int(i)
    if i < cfg.units * P:
        return f"units.{i % P}.{rest}", i // P
    return f"tail.{i - cfg.units * P}.{rest}", None


class LMModel(nn.Module):
    """The language model; parameters on ``device`` (None: the card,
    RP110 without one; ``"cpu"`` and ``"meta"`` as asked), drawn from
    ``generator``; the training build with ``train`` (module
    docstring)."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 generator: Optional[torch.Generator] = None,
                 train: bool = False):
        super().__init__()
        device = _resolve_device(device)
        self.cfg = cfg.validate()
        self.train_build = train
        pdt = getattr(torch, cfg.param_dtype)
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        pv, d, K = cfg.padded_vocab, cfg.d_model, cfg.num_codebooks

        def param(t):
            return nn.Parameter(t, requires_grad=train)

        if K > 1:
            self.embed = param(torch.stack([
                common.init_embed(generator, pv, d, pdt, device)
                for _ in range(K)]))                          # (K, pv, d)
        else:
            self.embed = param(common.init_embed(generator, pv, d, pdt,
                                                 device))
        self.frontend_proj = param(common.dense_param(
            generator, (cfg.frontend_dim, d), pdt, device=device)) \
            if cfg.frontend_dim else None
        head = (K, d, pv) if K > 1 else (d, pv)
        self.lm_head = None if cfg.tie_embeddings else param(
            common.dense_param(generator, head, pdt, device=device))
        self.final_norm = nn.ParameterDict({
            n: param(t) for n, t in
            common.init_norm(d, pdt, cfg.norm, device).items()})
        self._axes = {"embed": (None,) * (K > 1) + common.EMBED_AXES,
                      "frontend_proj": (None, "d_model"),
                      "lm_head": (None,) * (K > 1) + ("d_model", "vocab")}
        self._axes.update({f"final_norm.{n}": common.NORM_AXES[n]
                           for n in self.final_norm})
        self.layer_cfgs: Tuple[LayerCfg, ...] = (
            cfg.pattern * cfg.units + cfg.tail)
        self.layers = nn.ModuleList(Layer(cfg, lcfg, generator, device,
                                          train)
                                    for lcfg in self.layer_cfgs)
        # the padded-vocab entries (Megatron-style), which _head masks
        self.register_buffer(
            "vocab_pad", torch.arange(pv, device=device) >= cfg.vocab
            if pv != cfg.vocab else None, persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------- embedding

    def _embed_tokens(self, tokens):
        """tokens (B, S) or (B, S, K) -> their embedding (summed over the
        codebooks, in codebook order), scaled, in ``param_dtype``."""
        cfg = self.cfg
        if cfg.num_codebooks > 1:
            x = common.take_embed(self.embed[0], tokens[..., 0])
            for i in range(1, cfg.num_codebooks):
                x = x + common.take_embed(self.embed[i], tokens[..., i])
        else:
            x = common.take_embed(self.embed, tokens)
        if cfg.embed_scale:
            x = (x.float() * math.sqrt(float(cfg.d_model))).to(x.dtype)
        return x

    def _place(self, x, positions):
        """Cast to ``compute_dtype`` and add the sinusoidal positions."""
        x = x.to(self.compute_dtype)
        if self.cfg.pos == "sinusoidal":
            pe = common.sinusoidal_embedding(positions, self.cfg.d_model)
            x = x + pe.to(x.dtype)
        return x

    def embed_inputs(self, tokens, frontend_embeds=None):
        """tokens: (B, S) or (B, S, K); frontend_embeds: (B, T, F) or
        None, projected in ``param_dtype`` and prepended.  Returns (x,
        positions), positions covering T + S."""
        x = self._embed_tokens(tokens)
        if frontend_embeds is not None:
            proj = frontend_embeds.to(x.dtype) @ self.frontend_proj
            x = torch.cat([proj, x], dim=1)
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        return self._place(x, positions), positions

    def _ropes(self, positions) -> Dict[float, tuple]:
        """One rotation table per RoPE theta the attention layers use, at
        ``head_dim`` (GQA) or ``rope_dim`` (MLA)."""
        attn = self.cfg.attn
        if attn is None or not attn.use_rope:
            return {}
        dim = attn.rope_dim if attn.kind == "mla" else attn.head_dim
        return {t: common.rope_tables(positions, dim, t)
                for t in {self._theta(l) for l in self.layer_cfgs
                          if l.kind == "attn"}}

    def _theta(self, lcfg: LayerCfg) -> Optional[float]:
        """An attention layer's RoPE theta (MLA takes the config's, as
        the reference's ``apply_mla`` does); None for other layers."""
        attn = self.cfg.attn
        if lcfg.kind != "attn":
            return None
        if lcfg.rope_theta is not None and attn.kind != "mla":
            return lcfg.rope_theta
        return attn.rope_theta

    def _rms_weights(self, layers=None) -> List[Dict[str, torch.Tensor]]:
        """Every layer's (or each of ``layers``') RMS weights ``1 + scale``
        (float32, as the norms use them), made in one foreach add per call
        of the model rather than one add per norm."""
        named = [layer.rms_scales() for layer in
                 (self.layers if layers is None else layers)]
        flat = [t for per in named for _, t in per]
        added = iter(torch._foreach_add(flat, 1.0) if flat else ())
        return [{n: next(added) for n, _ in per} for per in named]

    # ---------------------------------------------------------------- forward

    def forward(self, tokens, frontend_embeds=None) -> ModelOutputs:
        """tokens: (B, S) or (B, S, K) -> logits (B, T + S, padded_vocab)
        or (B, S, K, padded_vocab), float32, and the MoE losses."""
        x, positions = self.embed_inputs(tokens, frontend_embeds)
        ropes = self._ropes(positions)
        aux = {k: torch.zeros((), dtype=torch.float32, device=x.device)
               for k in AUX_KEYS}
        layers = list(zip(self.layer_cfgs, self.layers, self._rms_weights()))

        def run(span, x, aux):
            for lcfg, layer, w in span:
                x, a = layer(x, positions, w, ropes.get(self._theta(lcfg)))
                if a is not None:
                    aux = {k: aux[k] + a[k] for k in AUX_KEYS}
            return x, aux

        for span, remat in self._spans(layers):
            if remat and self.train_build and torch.is_grad_enabled():
                # the forward draws no random numbers: no RNG state to keep
                x, aux = checkpoint(functools.partial(run, span), x, aux,
                                    use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux = run(span, x, aux)
        x = apply_norm(self.final_norm, x, self.cfg.norm)
        return ModelOutputs(logits=self._head(x), aux=aux)

    def _spans(self, layers: list):
        """``layers`` cut into (span, recomputed) by ``cfg.remat``: each
        unit (``"unit"``) or each unit layer (``"layer"``) recomputed in
        the backward pass; the tail, and everything under ``"none"``,
        not."""
        cfg = self.cfg
        n = cfg.units * len(cfg.pattern)
        size = {"unit": len(cfg.pattern), "layer": 1}.get(cfg.remat)
        if size is None:
            return [(layers, False)]
        spans = [(layers[i:i + size], True) for i in range(0, n, size)]
        return spans + ([(layers[n:], False)] if layers[n:] else [])

    def _head(self, x):
        cfg = self.cfg
        w = self.embed if cfg.tie_embeddings else self.lm_head
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
        if cfg.num_codebooks > 1:
            logits = torch.einsum("bsd,kvd->bskv", x, w) \
                if cfg.tie_embeddings else torch.einsum("bsd,kdv->bskv", x, w)
        else:
            logits = x @ (w.T if cfg.tie_embeddings else w)
        logits = softcap(logits.float(), cfg.logit_softcap)
        if self.vocab_pad is not None:
            # padded-vocab logits are never sampled and take no mass in
            # the loss; out of place, since the softcap's tanh saved its
            # output for the backward pass
            logits = logits.masked_fill(self.vocab_pad, -1e9)
        return logits

    # ------------------------------------------------------------------ loss

    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: tokens (B, S[, K]), labels (B, S[, K]) with -100 (any
        negative label) ignored, optional frontend_embeds.  Next-token
        cross entropy (labels already shifted by the data pipeline) plus
        the MoE losses: (total, {"ce", "lb_loss", "z_loss", "tokens"}),
        float32 0-d tensors."""
        cfg = self.cfg
        outs = self.forward(batch["tokens"], batch.get("frontend_embeds"))
        logits = outs.logits
        labels = batch["labels"]
        if cfg.frontend_dim and logits.shape[1] != labels.shape[1]:
            logits = logits[:, -labels.shape[1]:]     # drop image prefix
        valid = labels >= 0
        safe = torch.where(valid, labels, 0).long()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
        nll = torch.where(valid, nll, 0.0)
        denom = torch.clamp_min(valid.sum(), 1)
        ce = nll.sum() / denom
        total = ce + sum(outs.aux[k] for k in AUX_KEYS)
        metrics = {"ce": ce, **outs.aux, "tokens": denom.float()}
        return total, metrics

    def reference_leaves(self) -> Dict[str, str]:
        """Each parameter's leaf in the reference's params tree
        (``reference_leaf``)."""
        return {name: reference_leaf(self.cfg, name)[0]
                for name, _ in self.named_parameters()}

    def logical_axes(self) -> Dict[str, tuple]:
        """Each parameter's logical axes: its reference leaf's
        ``Param.axes`` without the leading ``"unit"`` axis of a unit
        layer (the reference stacks those, ``reference_leaf``)."""
        out = {}
        for name, _ in self.named_parameters():
            top, _, rest = name.partition(".")
            if top == "layers":
                i, _, rest = rest.partition(".")
                out[name] = self.layers[int(i)].axes[rest]
            else:
                out[name] = self._axes[name]
        return out

    def reference_logical_axes(self) -> dict:
        """The reference's spec tree (``common.split_params``): a
        ``common.LogicalAxes`` per leaf of its params tree, unit layers
        stacked on a leading ``"unit"`` axis, nested as its params
        (``units`` and ``tail`` tuples of one tree per position)."""
        tree: dict = {}
        axes = self.logical_axes()
        for name, leaf in self.reference_leaves().items():
            names = axes[name]
            if leaf.startswith("units."):
                names = ("unit",) + names
            node, parts = tree, leaf.split(".")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = common.LogicalAxes(names)
        P = len(self.cfg.pattern)
        tree["units"] = tuple(tree.get("units", {}).get(str(p), {})
                              for p in range(P))
        tree["tail"] = tuple(tree.get("tail", {}).get(str(p), {})
                             for p in range(len(self.cfg.tail)))
        return tree

    def weight_decay_mask(self) -> Dict[str, bool]:
        """Whether AdamW decays each parameter: the reference decays a
        leaf with two or more axes, and stacks unit layers on a leading
        unit axis, so a unit layer's parameter has one axis more there
        than here (its norm scales are decayed, a tail layer's are not)."""
        leaves = self.reference_leaves()
        return {name: p.ndim + leaves[name].startswith("units.") >= 2
                for name, p in self.named_parameters()}

    # ---------------------------------------------------------------- decode

    def init_caches(self, batch: int, cache_len: int) -> list:
        """Each layer's decode state, in layer order: a ``KVCache`` or
        ``MLACache`` (in ``compute_dtype``), a ``MambaState`` or an
        ``RwkvState``.  Attention caches of one length share one ``pos``
        tensor: every layer writes the same positions, so theirs are
        equal."""
        cfg, dt, dev = self.cfg, self.compute_dtype, self.device
        caches, shared = [], {}
        for lcfg in self.layer_cfgs:
            if lcfg.kind == "mamba":
                caches.append(mamba.init_state(cfg.mamba, batch, dt, dev))
            elif lcfg.kind == "rwkv":
                caches.append(rwkv.init_state(cfg.rwkv, cfg.d_model, batch,
                                              dt, dev))
            else:
                c = attention.init_cache(cfg.attn, batch, cache_len,
                                         lcfg.window, dt, dev)
                caches.append(c._replace(pos=shared.setdefault(
                    c.pos.shape[1], c.pos)))
        return caches

    def _ring_steps(self, caches, pos) -> list:
        """Write this step's position into each ``pos`` tensor (one per
        ring length, ``init_caches``) once and make each (length, window)
        mask once: the slot and mask every attention layer would compute
        from it (None for the recurrent layers).  GQA masks up to
        ``max(pos)`` (``decode_bias``), MLA up to the step's position
        (``mla_decode_bias``)."""
        mla = self.cfg.attn is not None and self.cfg.attn.kind == "mla"
        slots, steps, keys = {}, {}, []
        for l, c in zip(self.layer_cfgs, caches):
            if l.kind != "attn":
                keys.append(None)
                continue
            n = c.pos.shape[1]
            keys.append((n, l.window))
            if n not in slots:
                slots[n] = attention.write_positions(c.pos, pos)
            if keys[-1] not in steps:
                bias = attention.mla_decode_bias(c.pos, pos) if mla \
                    else attention.decode_bias(c.pos, l.window)
                steps[keys[-1]] = attention.RingStep(*slots[n], bias)
        return [None if k is None else steps[k] for k in keys]

    def decode_step(self, caches, tokens, pos):
        """One decode step.  tokens: (B, 1) or (B, 1, K); pos: (B, 1)
        absolute.

        Writes into ``caches`` and returns (logits (B, 1[, K], V),
        caches)."""
        x = self._place(self._embed_tokens(tokens), pos)
        ropes = self._ropes(pos)
        rings = self._ring_steps(caches, pos)
        for lcfg, layer, cache, ring, w in zip(
                self.layer_cfgs, self.layers, caches, rings,
                self._rms_weights()):
            x, _ = layer(x, pos, w, ropes.get(self._theta(lcfg)),
                         cache=cache, ring=ring)
        x = apply_norm(self.final_norm, x, self.cfg.norm)
        return self._head(x), caches


class PatternUnit(nn.Module):
    """Unit ``u`` of ``model`` (its layers ``u * P`` to ``u * P + P - 1``)
    as a module of its own: ``forward(x)`` runs them over positions
    0..S-1 as the model's forward does, without caches.  Every unit has
    the same parameter names, so one unit applied through
    ``torch.func.functional_call`` with another's parameters is that
    unit: the stage of a pipeline (``runtime/pipeline_parallel``)."""

    def __init__(self, model: LMModel, u: int):
        super().__init__()
        P = len(model.cfg.pattern)
        if not 0 <= u < model.cfg.units:
            raise ValueError(f"unit {u} of {model.cfg.units}")
        self.layers = nn.ModuleList(model.layers[u * P:(u + 1) * P])
        self.layer_cfgs = model.cfg.pattern
        self._model = (model,)          # not a submodule: no parameters

    def forward(self, x):
        model = self._model[0]
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        ropes = model._ropes(positions)
        for lcfg, layer, w in zip(self.layer_cfgs, self.layers,
                                  model._rms_weights(self.layers)):
            x, _ = layer(x, positions, w, ropes.get(model._theta(lcfg)))
        return x


def build(cfg: ArchConfig, *, device=None, seed: int = 0,
          train: bool = False) -> LMModel:
    """The model on ``device`` (as ``LMModel``, the training build with
    ``train``), its weights drawn there from
    ``torch.Generator(...).manual_seed(seed)``."""
    dev = _resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev).manual_seed(seed)
    return LMModel(cfg, device=dev, generator=gen, train=train)
