"""Serve step builders — counterpart of ``repro/runtime/trainer.py``
(``make_prefill_step``, ``make_decode_step``; ``make_train_step`` comes
with the training slice).

The reference's steps take the params tree as their first argument; a
port model holds its parameters, so the steps close over the model.  They
run under ``torch.inference_mode()`` (no autograd bookkeeping per op).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.transformer import LMModel


def make_prefill_step(model: LMModel) -> Callable:
    @torch.inference_mode()
    def prefill(batch) -> torch.Tensor:
        return model.forward(batch["tokens"],
                             batch.get("frontend_embeds")).logits[:, -1]

    return prefill


def make_decode_step(model: LMModel) -> Callable:
    @torch.inference_mode()
    def decode(caches, tokens, pos):
        return model.decode_step(caches, tokens, pos)

    return decode
