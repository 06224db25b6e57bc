"""The LM stack of the port: attention (GQA, MLA), common, MoE, Mamba,
RWKV and the model factory (transformer) for all ten architectures."""

from repro_torch.models.transformer import LMModel, build

__all__ = ["LMModel", "build"]
