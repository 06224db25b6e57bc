"""gemma3-4b [dense] — 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144.  5:1 local(1024):global, QK-norm, no softcaps, local rope theta
10k / global 1M, 128k context.  34 = 5 x [5 local + 1 global] + 4-local tail.
[hf:google/gemma-3-*-pt]
"""

from repro_torch.configs.base import ArchConfig, AttnCfg, LayerCfg

_LOCAL = LayerCfg("attn", "dense", window=1024, rope_theta=10000.0)
_GLOBAL = LayerCfg("attn", "dense", rope_theta=1_000_000.0)

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    vocab=262144,
    d_model=2560,
    n_layers=34,
    d_ff=10240,
    pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    attn=AttnCfg(n_heads=8, n_kv_heads=4, head_dim=256, qk_norm=True),
    norm="rms", mlp="swiglu", act="gelu", pos="rope",
    post_norms=True, embed_scale=True,
    tie_embeddings=True,
    train_accum=8,   # 262k-vocab logits dominate activation memory
    supports_long_context=True,
)
