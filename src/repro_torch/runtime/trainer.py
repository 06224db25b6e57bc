"""Train and serve step builders — counterpart of
``repro/runtime/trainer.py``.

The reference's steps take the params tree as their first argument; a
port model holds its parameters, so the steps close over the model.

``make_train_step`` builds ``(opt_state, comp_error, batch) -> (opt_state,
comp_error, metrics)`` for a training build (``LMModel(train=True)``),
updating the model's parameters in place: gradient accumulation over
``accum`` microbatches, compression with error feedback, AdamW.  The
serve steps run under ``torch.inference_mode()`` (no autograd
bookkeeping per op).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.models.transformer import LMModel
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.optim.compression import GradCompression


def _power_of_two(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def make_train_step(model: LMModel, optimizer: AdamW, accum: int = 1,
                    compression: Optional[GradCompression] = None
                    ) -> Callable:
    """The reference's train step for ``model``'s parameters.

    With ``accum > 1`` the batch's leading axis is cut into ``accum``
    microbatches in order, and each one's gradient divided by ``accum``
    is added into accumulators in ``cfg.accum_dtype``.  Where every
    parameter is in that dtype and ``accum`` is a power of two,
    backpropagating ``loss / accum`` into ``.grad`` gives exactly the
    reference's ``g / accum`` (a power-of-two scale rounds nothing) and
    ``.grad``'s own accumulation is the reference's ``a + g / accum``; else
    each microbatch's ``.grad`` is divided and added into a separate
    accumulator.  The metrics are the last microbatch's (the reference's
    scan carry), with the optimizer's ``grad_norm`` and ``lr``.
    """
    comp = compression or GradCompression("none")
    acc_dt = getattr(torch, model.cfg.accum_dtype)
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    if not params:
        raise ValueError("make_train_step needs a training build: "
                         "LMModel(cfg, train=True)")
    decay, leaves = model.weight_decay_mask(), model.reference_leaves()
    direct = accum == 1 or (_power_of_two(accum) and all(
        p.dtype == acc_dt for p in params.values()))

    def grads_of(batch) -> tuple:
        """(grads by name, the last microbatch's metrics)."""
        for p in params.values():
            p.grad = None
        n = next(iter(batch.values())).shape[0]
        if n % accum:
            raise ValueError(f"batch {n} is not a multiple of accum {accum}")
        size = n // accum
        acc = None if direct else {
            name: torch.zeros(p.shape, dtype=acc_dt, device=p.device)
            for name, p in params.items()}
        for i in range(accum):
            micro = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            total, metrics = model.loss(micro)
            if acc is None:
                (total / accum if accum > 1 else total).backward()
                continue
            total.backward()
            for name, p in params.items():
                if p.grad is not None:
                    acc[name].add_((p.grad / accum).to(acc_dt))
                p.grad = None
        if acc is None:
            acc = {name: p.grad if p.grad is not None
                   else torch.zeros_like(p) for name, p in params.items()}
        return acc, {k: v.detach() for k, v in metrics.items()}

    def train_step(opt_state: AdamWState, comp_error, batch: Dict):
        grads, metrics = grads_of(batch)
        grads, comp_error = comp.compress(grads, comp_error, leaves)
        _, opt_state, opt_metrics = optimizer.update(grads, opt_state,
                                                     params, decay=decay)
        del grads
        for p in params.values():
            p.grad = None
        return opt_state, comp_error, {**metrics, **opt_metrics}

    return train_step


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
