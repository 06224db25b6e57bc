"""LR schedules: linear warmup + cosine decay to a floor — counterpart of
``repro/optim/schedule.py``.

Computed in float32 on the host, as the reference computes it (its
weakly typed Python constants become float32 where they meet the step):
the learning rate is a 0-d float32 CPU tensor, which the optimizer reads
without a device round trip.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class WarmupCosine:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    floor_ratio: float = 0.1

    def __call__(self, step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = self.peak_lr * step / max(self.warmup_steps, 1)
        prog = torch.clamp((step - self.warmup_steps)
                           / max(self.total_steps - self.warmup_steps, 1),
                           0, 1)
        cos = self.peak_lr * (self.floor_ratio + (1 - self.floor_ratio)
                              * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < self.warmup_steps, warm, cos)
