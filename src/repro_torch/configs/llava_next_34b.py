"""llava-next-34b [vlm] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 (Yi-34B backbone).  Modality frontend is a STUB per the brief:
``input_specs()`` supplies precomputed anyres patch embeddings (frontend_dim
1152, 576 base-resolution tokens) which a linear projector maps to d_model.
[hf:llava-hf/llava-v1.6-*]
"""

from repro_torch.configs.base import ArchConfig, AttnCfg, LayerCfg

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    vocab=64000,
    d_model=7168,
    n_layers=60,
    d_ff=20480,
    pattern=(LayerCfg("attn", "dense"),),
    attn=AttnCfg(n_heads=56, n_kv_heads=8, head_dim=128, rope_theta=5e6),
    norm="rms", mlp="swiglu", act="silu", pos="rope",
    tie_embeddings=False,
    frontend_dim=1152,
    img_tokens=576,
    train_accum=8,
    supports_long_context=False,
    notes="anyres tiling is a data-pipeline concern in the stub: the "
          "frontend delivers (B, img_tokens, 1152) precomputed embeddings.",
)
