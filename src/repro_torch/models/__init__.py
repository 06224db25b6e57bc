"""The LM stack of the port: the dense GQA family (attention, common,
transformer).  MoE, MLA, Mamba and RWKV come with later slices."""

from repro_torch.models.transformer import LMModel, build

__all__ = ["LMModel", "build"]
