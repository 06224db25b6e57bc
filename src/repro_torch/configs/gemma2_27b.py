"""gemma2-27b [dense] — 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000.  Local(4096):global 1:1 alternation, attn softcap 50, final
logit softcap 30, pre+post norms, query scale 1/sqrt(d_model/n_heads).
[arXiv:2408.00118]

long_500k: runs — local layers use ring caches (the 1D-stencil reuse,
DESIGN §5); the 23 global layers keep full 500k caches, sharded.
"""

from repro_torch.configs.base import ArchConfig, AttnCfg, LayerCfg

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    vocab=256000,
    d_model=4608,
    n_layers=46,
    d_ff=36864,
    pattern=(
        LayerCfg("attn", "dense", window=4096),
        LayerCfg("attn", "dense"),
    ),
    attn=AttnCfg(
        n_heads=32, n_kv_heads=16, head_dim=128, rope_theta=10000.0,
        softcap=50.0, query_scale=(4608 / 32) ** -0.5,
    ),
    norm="rms", mlp="swiglu", act="gelu", pos="rope",
    post_norms=True, logit_softcap=30.0, embed_scale=True,
    tie_embeddings=True,
    train_accum=4,
    supports_long_context=True,
)
