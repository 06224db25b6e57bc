"""Gradient compression with error feedback — counterpart of
``repro/optim/compression.py``.

Compresses the gradients before the optimizer consumes them and carries
the quantization error into the next step (1-bit-Adam-style error
feedback), at the gradient-accumulation/optimizer boundary, as the
reference does.  Modes: "none", "bf16" (2x), "int8" (4x, per-tensor
absmax scaling).  Gradients and errors are mappings of name to tensor.

"Per tensor" means per reference leaf: the reference stacks each pattern
position's unit layers on one leading axis, so all units of a position
share one int8 scale there.  ``compress`` takes each name's reference
leaf (``LMModel.reference_leaves``) and scales the names of one leaf by
the largest absolute value among them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class GradCompression:
    mode: str = "none"             # "none" | "bf16" | "int8"

    def init_error(self, params: Mapping[str, torch.Tensor]
                   ) -> Optional[Tree]:
        if self.mode == "none":
            return None
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}

    def compress(self, grads: Mapping[str, torch.Tensor],
                 error: Optional[Tree],
                 leaves: Optional[Mapping[str, str]] = None
                 ) -> Tuple[Tree, Optional[Tree]]:
        """Returns (decompressed grads as consumed downstream, new
        error).  ``leaves``: each name's reference leaf, the unit of the
        int8 scale (default: each name its own)."""
        if self.mode == "none":
            return dict(grads), error
        if self.mode not in ("bf16", "int8"):
            raise ValueError(self.mode)
        g32 = {n: g.float() + error[n] for n, g in grads.items()}
        scales = {}
        if self.mode == "int8":
            leaves = leaves or {n: n for n in grads}
            absmax: Dict[str, torch.Tensor] = {}
            for n, g in g32.items():
                m = torch.max(torch.abs(g))
                k = leaves[n]
                absmax[k] = m if k not in absmax \
                    else torch.maximum(absmax[k], m)
            scales = {n: torch.clamp_min(absmax[leaves[n]], 1e-12) / 127.0
                      for n in g32}
        new_grads, new_error = {}, {}
        for name, g in g32.items():
            if self.mode == "bf16":
                deq = g.to(torch.bfloat16).float()
            else:
                scale = scales[name]
                q = torch.clamp(torch.round(g / scale), -127, 127).to(
                    torch.int8)
                deq = q.float() * scale
            new_grads[name], new_error[name] = deq, g - deq
        return new_grads, new_error

    def wire_bytes_ratio(self) -> float:
        """Bytes on the wire relative to f32 (for the roofline's
        collective term when compression is enabled)."""
        return {"none": 1.0, "bf16": 0.5, "int8": 0.25}[self.mode]
