"""Optimizers: AdamW (dtype policies), schedules, compression."""

from repro_torch.optim.adamw import AdamW, AdamWState, global_norm
from repro_torch.optim.compression import GradCompression
from repro_torch.optim.schedule import WarmupCosine

__all__ = ["AdamW", "AdamWState", "GradCompression", "WarmupCosine",
           "global_norm"]
