"""Carry a configuration and its data across from the reference package.

The tests build a configuration once as the reference's dataclasses and
numpy arrays, then hand both packages the same thing:

    prog = program_from_fields(**dataclasses.asdict(ref_program))
    plan = plan_from_fields(**dataclasses.asdict(ref_plan))
    coeffs = coeffs_from_numpy(ref_coeffs.center, ref_coeffs.taps, "cpu")

and an LM configuration and its weights:

    cfg = arch_from_fields(**dataclasses.asdict(ref_cfg))
    values, _ = repro.models.common.split_params(ref_model.init(key))
    model.load_state_dict(lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, values), "cpu"))

Only plain fields and numpy arrays cross, so this module imports nothing
of the reference.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from repro_torch.configs.base import (ArchConfig, AttnCfg, LayerCfg,
                                      MambaCfg, MoECfg, RwkvCfg)
from repro_torch.core.blocking import BlockPlan
from repro_torch.core.program import DTYPES, ProgramCoeffs, StencilProgram
from repro_torch.models.transformer import KEEP_F32, LMModel


def program_from_fields(**fields) -> StencilProgram:
    """A port program from the reference program's dataclass fields."""
    return StencilProgram(**fields)


def plan_from_fields(*, spec: Mapping, block_shape: Sequence[int],
                     par_time: int) -> BlockPlan:
    """A port plan from the reference plan's fields, ``spec`` being the
    reference program's fields (as ``dataclasses.asdict`` nests them)."""
    return BlockPlan(spec=program_from_fields(**spec),
                     block_shape=tuple(block_shape), par_time=int(par_time))


def _tensor_from_numpy(a, device) -> torch.Tensor:
    """A tensor of ``a`` in its own dtype where the kernels take it
    (float32, float16, and bfloat16 from ``ml_dtypes`` through float32,
    which holds it exactly), else in float32."""
    a = np.asarray(a)
    name = a.dtype.name
    if name not in DTYPES:
        return torch.tensor(a.astype(np.float32), device=device)
    t = torch.tensor(a.astype(np.float32) if name == "bfloat16" else a)
    return t.to(device=device, dtype=DTYPES[name])


def coeffs_from_numpy(center, taps, device="cpu") -> ProgramCoeffs:
    """Port coefficients on ``device`` from array-likes, each in its own
    dtype when the kernels take it (so the reference's bfloat16 center and
    float32 taps of a bfloat16 program cross as they are), else in
    float32."""
    return ProgramCoeffs(
        center=_tensor_from_numpy(center, device),
        taps=_tensor_from_numpy(np.asarray(taps).reshape(-1), device))


def arch_from_fields(**fields) -> ArchConfig:
    """A port ``ArchConfig`` from the reference config's dataclass fields
    (``dataclasses.asdict`` nests the sub-configs as dicts)."""
    subs = {"attn": AttnCfg, "moe": MoECfg, "mamba": MambaCfg,
            "rwkv": RwkvCfg}
    for name, cls in subs.items():
        if fields.get(name) is not None:
            fields[name] = cls(**fields[name])
    fields["pattern"] = tuple(LayerCfg(**l) for l in fields["pattern"])
    return ArchConfig(**fields)


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    else:
        out[prefix[:-1]] = tree


def lm_params_from_numpy(cfg: ArchConfig, tree: Mapping,
                         device="cpu") -> Dict[str, torch.Tensor]:
    """The port model's state dict from the reference's params tree (the
    values of ``common.split_params``, leaves as numpy arrays).

    ``tree["units"][p]`` stacks pattern position ``p`` over units; unit
    ``u`` becomes layer ``u * len(pattern) + p``, and ``tree["tail"][p]``
    layer ``units * len(pattern) + p``.  Each leaf is placed as the model
    places it: layer leaves cast from ``param_dtype`` to
    ``compute_dtype`` (the reference casts them at use; norm scales then
    held in float32) but the ``KEEP_F32`` leaves, which keep their own
    dtype; the rest (the embedding tables, ``frontend_proj``, the head,
    ``final_norm``) in ``param_dtype``.
    """
    held = {k: v.dtype for k, v in
            LMModel(cfg, device="meta").state_dict().items()}
    flat: Dict[str, np.ndarray] = {}
    P = len(cfg.pattern)
    for p, stacked in enumerate(tree["units"]):
        leaves: Dict[str, np.ndarray] = {}
        _flatten(stacked, "", leaves)
        for u in range(cfg.units):
            for name, v in leaves.items():
                flat[f"layers.{u * P + p}.{name}"] = v[u]
    for p, layer in enumerate(tree["tail"]):
        _flatten(layer, f"layers.{cfg.units * P + p}.", flat)
    for name in ("embed", "frontend_proj", "lm_head", "final_norm"):
        if name in tree:
            _flatten(tree[name], f"{name}.", flat)
    param = getattr(torch, cfg.param_dtype)
    compute = getattr(torch, cfg.compute_dtype)
    out = {}
    for name, v in flat.items():
        v = np.asarray(v)
        if v.dtype.name == "bfloat16":
            v = v.astype(np.float32)        # exact: ml_dtypes bfloat16
        t = torch.tensor(v)
        if name.rsplit(".", 1)[-1] not in KEEP_F32:
            t = t.to(param)
            if name.startswith("layers."):
                t = t.to(compute)
        out[name] = t.to(held[name]).to(device)
    return out
