"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
(per expert) vocab=49155, MoE 40e top-8 every layer.
[hf:ibm-granite/granite-3.0-3b-a800m-base]

40 experts % 16-way model axis != 0 -> TP-mode experts (d_ff 512 / 16 = 32
per chip); the fine-grained-experts regime the brief pairs against jamba's
EP mode.
"""

from repro_torch.configs.base import ArchConfig, AttnCfg, LayerCfg, MoECfg

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    vocab=49155,
    d_model=1536,
    n_layers=32,
    d_ff=512,
    pattern=(LayerCfg("attn", "moe"),),
    attn=AttnCfg(n_heads=24, n_kv_heads=8, head_dim=64),
    moe=MoECfg(num_experts=40, top_k=8, d_ff=512, mode="tp",
               capacity_factor=1.25),
    norm="rms", mlp="swiglu", act="silu", pos="rope",
    tie_embeddings=True,
    train_accum=4,   # (B,E,C,d) dispatch buffers: 40 experts x top-8
    supports_long_context=False,
)
