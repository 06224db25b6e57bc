"""rwkv6-7b [ssm] — 32L d_model=4096 (attention-free) d_ff=14336 vocab=65536.

RWKV-6 "Finch": data-dependent per-channel decay, token-shift low-rank mixes,
O(1) recurrent state -> the canonical long_500k architecture.
[arXiv:2404.05892]
"""

from repro_torch.configs.base import ArchConfig, LayerCfg, RwkvCfg

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    vocab=65536,
    d_model=4096,
    n_layers=32,
    d_ff=14336,
    pattern=(LayerCfg("rwkv", "rwkv"),),
    rwkv=RwkvCfg(head_dim=64, decay_lora=64, mix_lora=32, chunk=64),
    norm="rms", pos="none",
    tie_embeddings=False,
    train_accum=2,
    supports_long_context=True,
)
