"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2.  Mamba:attn 7:1 (attn at offset 4 of each 8-layer
block), MoE every other layer.  No positional encoding (mamba provides
order).  16 experts % 16-way model axis == 0 -> true expert parallelism.
[arXiv:2403.19887]
"""

from repro_torch.configs.base import (ArchConfig, AttnCfg, LayerCfg, MambaCfg,
                                MoECfg)

_M = "mamba"
_PATTERN = tuple(
    LayerCfg(kind=("attn" if i == 4 else _M),
             ffn=("moe" if i % 2 == 1 else "dense"))
    for i in range(8)
)

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    vocab=65536,
    d_model=4096,
    n_layers=32,
    d_ff=14336,
    pattern=_PATTERN,
    attn=AttnCfg(n_heads=32, n_kv_heads=8, head_dim=128, use_rope=False),
    moe=MoECfg(num_experts=16, top_k=2, d_ff=14336, mode="ep"),
    mamba=MambaCfg(d_inner=8192, d_state=16, d_conv=4, dt_rank=256),
    norm="rms", mlp="swiglu", act="silu", pos="none",
    tie_embeddings=False,
    train_accum=8,
    # mamba chunk internals too big at unit granularity:
    remat="layer",
    supports_long_context=True,
)
