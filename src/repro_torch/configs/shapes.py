"""The 4 assigned input shapes + abstract input specs per (arch x shape)
— counterpart of ``repro/configs/shapes.py``.

  train_4k     seq 4,096   global_batch 256   -> train_step
  prefill_32k  seq 32,768  global_batch 32    -> serve_prefill
  decode_32k   seq 32,768  global_batch 128   -> serve_step (1 token, full cache)
  long_500k    seq 524,288 global_batch 1     -> serve_step, sub-quadratic archs only

``input_specs`` returns meta tensors (no allocation), where the reference
returns ``ShapeDtypeStruct``s: the dry run's standing inputs.  Decode
shapes also get the model's caches (``LMModel.init_caches`` on a model
built with ``device="meta"``): one state per layer, where the reference
stacks a pattern position's units on a leading axis.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"

    def cells(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> bool:
    """long_500k is skipped for pure full-attention archs (DESIGN §5)."""
    if shape.name == "long_500k":
        return cfg.supports_long_context
    return True


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _tokens(cfg: ArchConfig, batch: int, seq: int) -> torch.Tensor:
    if cfg.num_codebooks > 1:
        return _meta((batch, seq, cfg.num_codebooks), torch.int32)
    return _meta((batch, seq), torch.int32)


def input_specs(cfg: ArchConfig, shape: ShapeSpec, model=None,
                batch: Optional[int] = None):
    """Abstract inputs for the given cell (``batch``: a batch other than
    the shape's global one, as the dry run takes one batch shard's).

    train:   {tokens, labels[, frontend_embeds]}
    prefill: {tokens[, frontend_embeds]}
    decode:  {tokens (B,1[,K]), pos (B,1), caches}
    """
    B = shape.global_batch if batch is None else batch
    S = shape.seq_len
    if shape.kind in ("train", "prefill"):
        text = S - cfg.img_tokens if cfg.frontend_dim else S
        out = {"tokens": _tokens(cfg, B, text)}
        if shape.kind == "train":
            out["labels"] = _tokens(cfg, B, text)
        if cfg.frontend_dim:
            out["frontend_embeds"] = _meta(
                (B, cfg.img_tokens, cfg.frontend_dim), torch.float32)
        return out
    if shape.kind == "decode":
        assert model is not None, "decode specs need the model (cache tree)"
        if model.device.type != "meta":
            raise ValueError("decode specs need a model built with "
                             "device='meta'")
        return {"tokens": _tokens(cfg, B, 1),
                "pos": _meta((B, 1), torch.int32),
                "caches": model.init_caches(B, S)}
    raise ValueError(shape.kind)
