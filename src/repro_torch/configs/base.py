"""Architecture config schema — a copy of ``repro/configs/base.py``.

One ``ArchConfig`` describes everything the model factory needs: layer
pattern (supports hybrid interleaves like jamba's 1:7 attn:mamba and gemma's
local:global alternation), attention variant, MoE/Mamba/RWKV sub-configs, and
dtype/remat policies.  Every assigned arch in ``repro_torch/configs/<id>.py``
instantiates exactly one of these; ``reduced()`` derives the CPU smoke-test
version.  The dataclasses are data: they hold what the reference's hold,
field for field, so ``convert.arch_from_fields`` carries one across.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    kind: str = "gqa"              # "gqa" | "mla"
    rope_theta: float = 10000.0
    use_rope: bool = True          # jamba: no positional encoding
    softcap: Optional[float] = None       # gemma2 attn-logit softcap (50.0)
    qk_norm: bool = False                 # gemma3
    query_scale: Optional[float] = None   # default 1/sqrt(head_dim)
    # MLA (minicpm3 / deepseek-v2 style) dims:
    q_lora: int = 0
    kv_lora: int = 0
    rope_dim: int = 0
    nope_dim: int = 0
    v_dim: int = 0


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_ff: int
    capacity_factor: float = 1.25
    mode: str = "tp"               # "ep" (experts over model axis) | "tp"
    router_z_weight: float = 1e-3
    lb_loss_weight: float = 1e-2


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d_inner: int
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0               # 0 -> ceil(d_model / 16)
    chunk: int = 256               # scan chunk (remat boundary)


@dataclasses.dataclass(frozen=True)
class RwkvCfg:
    head_dim: int = 64
    decay_lora: int = 64
    mix_lora: int = 32
    chunk: int = 256
    # "chunked": GLA-style O(C^2 hd) matmul form (§Perf hillclimb — ~100x
    # less HBM traffic than the step scan); "scan": faithful per-token
    # recurrence (oracle for tests)
    impl: str = "chunked"


@dataclasses.dataclass(frozen=True)
class LayerCfg:
    """One position in the repeating layer pattern."""

    kind: str = "attn"             # "attn" | "mamba" | "rwkv"
    ffn: str = "dense"             # "dense" | "moe" | "rwkv"
    window: Optional[int] = None   # sliding-window size (None = global)
    rope_theta: Optional[float] = None  # per-layer override (gemma3 5:1)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense|moe|hybrid|ssm|vlm|audio
    vocab: int
    d_model: int
    n_layers: int
    d_ff: int
    pattern: Tuple[LayerCfg, ...]
    attn: Optional[AttnCfg] = None
    moe: Optional[MoECfg] = None
    mamba: Optional[MambaCfg] = None
    rwkv: Optional[RwkvCfg] = None

    norm: str = "rms"              # "rms" | "layer"
    mlp: str = "swiglu"            # "swiglu" | "gelu_mlp"
    act: str = "silu"
    pos: str = "rope"              # "rope" | "sinusoidal" | "none"
    post_norms: bool = False       # gemma2/3: post-attn and post-ffn norms
    logit_softcap: Optional[float] = None
    embed_scale: bool = False      # gemma: x *= sqrt(d_model)
    tie_embeddings: bool = True

    num_codebooks: int = 1         # musicgen: 4 parallel EnCodec codebooks
    img_tokens: int = 0            # llava stub: image-embedding prefix length
    frontend_dim: int = 0          # stub modality embedding dim (llava)

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    moment_dtype: str = "float32"  # bf16 for grok (fits HBM, see DESIGN §6)
    remat: str = "unit"            # "none" | "unit" | "layer"
    train_accum: int = 1           # gradient-accumulation microbatches
    accum_dtype: str = "float32"   # bf16 halves the grad buffer (grok)

    # long_500k eligibility (sub-quadratic path exists); see DESIGN §5
    supports_long_context: bool = False
    notes: str = ""

    # ---- derived ------------------------------------------------------------

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows, padded so the vocab dim shards over any
        production axis (Megatron-style padded vocab).  Logits at padded ids
        are masked to -inf; ``vocab`` stays the logical size."""
        m = 256
        return (self.vocab + m - 1) // m * m

    @property
    def units(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def tail(self) -> Tuple[LayerCfg, ...]:
        return self.pattern[: self.n_layers % len(self.pattern)]

    @property
    def uses_attention(self) -> bool:
        return any(l.kind == "attn" for l in self.pattern + self.tail)

    def validate(self):
        assert self.units >= 1, "pattern longer than layer count"
        kinds = {l.kind for l in self.pattern}
        if "attn" in kinds:
            assert self.attn is not None
        if "mamba" in kinds:
            assert self.mamba is not None
        if "rwkv" in kinds:
            assert self.rwkv is not None
        if any(l.ffn == "moe" for l in self.pattern):
            assert self.moe is not None
        if self.attn is not None and self.attn.kind == "mla":
            assert self.attn.kv_lora > 0 and self.attn.v_dim > 0
        return self

    def reduced(self, d_model: int = 128, vocab: int = 512) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        scale = d_model / self.d_model

        def r32(x: int) -> int:   # keep reduced dims shardable on test meshes
            return max(32, (int(x) + 31) // 32 * 32)
        attn = self.attn
        if attn is not None:
            n_heads = max(2, min(attn.n_heads, 4))
            n_kv = max(1, min(attn.n_kv_heads, 2))
            if attn.kind == "mla":
                attn = dataclasses.replace(
                    attn, n_heads=n_heads, n_kv_heads=n_heads, head_dim=32,
                    q_lora=64, kv_lora=32, rope_dim=16, nope_dim=16, v_dim=32)
            else:
                attn = dataclasses.replace(
                    attn, n_heads=n_heads, n_kv_heads=n_kv, head_dim=32)
            if attn.softcap is None:
                pass
        moe = self.moe
        if moe is not None:
            moe = dataclasses.replace(
                moe, num_experts=min(moe.num_experts, 4),
                top_k=min(moe.top_k, 2), d_ff=r32(moe.d_ff * scale))
        mamba = self.mamba
        if mamba is not None:
            mamba = dataclasses.replace(
                mamba, d_inner=2 * d_model, d_state=8, dt_rank=16, chunk=16)
        rwkv = self.rwkv
        if rwkv is not None:
            rwkv = dataclasses.replace(rwkv, head_dim=32, decay_lora=16,
                                       mix_lora=8, chunk=16)
        pattern = tuple(
            dataclasses.replace(l, window=None if l.window is None
                                else min(l.window, 16))
            for l in self.pattern)
        return dataclasses.replace(
            self,
            d_model=d_model,
            vocab=vocab,
            n_layers=max(len(pattern), min(self.n_layers, 2 * len(pattern))),
            d_ff=r32(self.d_ff * scale),
            pattern=pattern,
            attn=attn, moe=moe, mamba=mamba, rwkv=rwkv,
            param_dtype="float32", compute_dtype="float32",
            img_tokens=min(self.img_tokens, 8),
            frontend_dim=min(self.frontend_dim, 32),
            remat="none",
        )
