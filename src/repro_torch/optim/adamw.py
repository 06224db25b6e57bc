"""AdamW with dtype policies and global-norm clipping — counterpart of
``repro/optim/adamw.py``.

Parameters, gradients and moments are mappings of name to tensor (a
model's ``named_parameters()``).  Moments are stored in ``moment_dtype``
(bfloat16 halves grok-1's optimizer state); the update arithmetic runs in
float32, in the reference's order of operations, and clipping multiplies
every gradient by ``min(1, clip_norm / (gnorm + 1e-9))``.

The reference donates its buffers and returns new ones; here ``update``
writes the new parameters and moments into the same tensors under
``torch.no_grad()``, one leaf at a time, so that its scratch is a few
copies of the largest leaf rather than of the whole model.  The step
counter is a 0-d int32 CPU tensor: the learning rate and the bias
corrections ``1 - b ** step`` (float32) are host values, and a step
waits on the device for nothing.

Weight decay applies to leaves whose reference array has two or more
axes (``p.ndim >= 2`` there: norm scales and biases skip it).  The
reference stacks each pattern position's unit layers on a leading axis,
so a unit layer's norm scale is 2-D there and decayed while a tail
layer's is not; ``update`` takes that decision per name
(``LMModel.weight_decay_mask``), and falls back to the tensor's own ndim.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, NamedTuple, Optional

import torch

from repro_torch.optim.schedule import WarmupCosine

Tree = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor         # () int32, on the CPU
    mu: Tree
    nu: Tree


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares,
    summed in the tree's order (the reference's Python ``sum``)."""
    leaves = [torch.sum(torch.square(g.float())) for g in tree.values()]
    return torch.sqrt(sum(leaves))


@dataclasses.dataclass(frozen=True)
class AdamW:
    schedule: Callable = WarmupCosine()
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: str = "float32"

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        dt = getattr(torch, self.moment_dtype)

        def zeros():
            return {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                    for n, p in params.items()}

        return AdamWState(step=torch.zeros((), dtype=torch.int32),
                          mu=zeros(), nu=zeros())

    def update(self, grads: Mapping[str, torch.Tensor], state: AdamWState,
               params: Mapping[str, torch.Tensor],
               decay: Optional[Mapping[str, bool]] = None):
        """One step: writes the new values into ``params`` and into the
        state's moments; returns (params, the state with the new step,
        {"grad_norm", "lr"}).  ``decay``: whether each name takes weight
        decay (default: ``p.ndim >= 2``)."""
        step = state.step + 1
        lr = self.schedule(step)
        gnorm = global_norm(grads)
        scale = None
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        f32 = torch.float32
        c1 = 1.0 - torch.tensor(self.b1, dtype=f32) ** step.to(f32)
        c2 = 1.0 - torch.tensor(self.b2, dtype=f32) ** step.to(f32)
        with torch.no_grad():
            for name, p in params.items():
                decayed = decay[name] if decay is not None else p.ndim >= 2
                self._update_leaf(p, grads[name], state.mu[name],
                                  state.nu[name], scale, lr, c1, c2, decayed)
        return params, AdamWState(step, state.mu, state.nu), \
            {"grad_norm": gnorm, "lr": lr}

    def _update_leaf(self, p, g, mu, nu, scale, lr, c1, c2, decayed: bool):
        """The reference's ``upd`` for one leaf, in place, with two
        float32 scratch tensors (``a``, ``b``) of the leaf's size."""
        f32 = torch.float32
        b1, b2 = self.b1, self.b2
        a = g.to(f32, copy=True) if scale is None else g.float() * scale
        mu32 = mu if mu.dtype == f32 else mu.float()
        nu32 = nu if nu.dtype == f32 else nu.float()
        b = a * (1 - b1)
        mu32.mul_(b1).add_(b)                   # mu * b1 + (1 - b1) * g
        torch.square(a, out=b).mul_(1 - b2)
        nu32.mul_(b2).add_(b)                   # nu * b2 + (1 - b2) * g^2
        torch.div(mu32, c1, out=a)              # mhat
        torch.div(nu32, c2, out=b).sqrt_().add_(self.eps)
        a.div_(b)                               # mhat / (sqrt(vhat) + eps)
        p32 = p if p.dtype == f32 else p.float()
        if decayed:
            a.add_(torch.mul(p32, self.weight_decay, out=b))
        p32.sub_(a.mul_(lr))                    # p - lr * delta
        for dst, src in ((p, p32), (mu, mu32), (nu, nu32)):
            if dst is not src:
                dst.copy_(src)
