"""musicgen-large [audio] — 48L d_model=2048 32H (kv=32, MHA) d_ff=8192
vocab=2048.  Decoder-only over EnCodec tokens: 4 codebooks embedded additively
and predicted by 4 parallel heads (the delay-pattern interleave is a data
pipeline concern; the backbone is per the brief).  Sinusoidal positions,
LayerNorm, GeLU.  [arXiv:2306.05284]
"""

from repro_torch.configs.base import ArchConfig, AttnCfg, LayerCfg

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    vocab=2048,
    d_model=2048,
    n_layers=48,
    d_ff=8192,
    pattern=(LayerCfg("attn", "dense"),),
    attn=AttnCfg(n_heads=32, n_kv_heads=32, head_dim=64, use_rope=False),
    norm="layer", mlp="gelu_mlp", act="gelu", pos="sinusoidal",
    tie_embeddings=False,
    num_codebooks=4,
    supports_long_context=False,
)
