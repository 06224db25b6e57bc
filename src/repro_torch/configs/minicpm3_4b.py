"""minicpm3-4b [dense, MLA] — 62L d_model=2560 40H d_ff=6400 vocab=73448.

MLA (multi-head latent attention) per the HF reference implementation:
q_lora 768, kv_lora 256, decoupled rope dim 32, nope 64, v 64.  kv=40 in the
assignment sheet == full MHA at the latent level.  [hf:openbmb/MiniCPM3-4B]
"""

from repro_torch.configs.base import ArchConfig, AttnCfg, LayerCfg

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    vocab=73448,
    d_model=2560,
    n_layers=62,
    d_ff=6400,
    pattern=(LayerCfg("attn", "dense"),),
    attn=AttnCfg(
        n_heads=40, n_kv_heads=40, head_dim=96, kind="mla",
        q_lora=768, kv_lora=256, rope_dim=32, nope_dim=64, v_dim=64,
        rope_theta=10000.0,
    ),
    norm="rms", mlp="swiglu", act="silu", pos="rope",
    tie_embeddings=True,
    train_accum=2,
    supports_long_context=False,   # pure full attention -> skip long_500k
    notes="MLA latent cache (kv_lora+rope_dim per token) is 7.5x smaller "
          "than a GQA kv=40 cache; decode uses the absorbed-matmul form.",
)
