"""starcoder2-7b [dense] — 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152.  LayerNorm + plain GeLU MLP, RoPE theta 1e5.  [arXiv:2402.19173]
"""

from repro_torch.configs.base import ArchConfig, AttnCfg, LayerCfg

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    vocab=49152,
    d_model=4608,
    n_layers=32,
    d_ff=18432,
    pattern=(LayerCfg("attn", "dense"),),
    attn=AttnCfg(n_heads=36, n_kv_heads=4, head_dim=128, rope_theta=1e5),
    norm="layer", mlp="gelu_mlp", act="gelu", pos="rope",
    tie_embeddings=True,
    train_accum=4,
    supports_long_context=False,
)
