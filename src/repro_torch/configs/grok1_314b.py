"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8e top-2 every layer.  GeGLU experts, attn-logit softcap 30, scaled
embeddings.  [hf:xai-org/grok-1]

Memory policy (DESIGN §6): 8 experts don't divide the 16-way model axis, so
experts run in TP mode (d_ff/16).  Training state fits 16 GiB/chip only with
bf16 params + bf16 Adam moments + 2-D (data x model) param sharding +
gradient accumulation; verified by the dry-run's memory_analysis.
"""

from repro_torch.configs.base import ArchConfig, AttnCfg, LayerCfg, MoECfg

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    vocab=131072,
    d_model=6144,
    n_layers=64,
    d_ff=32768,
    pattern=(LayerCfg("attn", "moe"),),
    attn=AttnCfg(n_heads=48, n_kv_heads=8, head_dim=128, softcap=30.0),
    moe=MoECfg(num_experts=8, top_k=2, d_ff=32768, mode="tp",
               capacity_factor=1.0),
    norm="rms", mlp="swiglu", act="gelu", pos="rope",
    embed_scale=True,
    tie_embeddings=False,
    param_dtype="bfloat16",
    moment_dtype="bfloat16",
    train_accum=16,
    accum_dtype="bfloat16",
    supports_long_context=False,
)
