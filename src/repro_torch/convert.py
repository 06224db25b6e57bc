"""Carry a configuration and its data across from the reference package.

The tests build a configuration once as the reference's dataclasses and
numpy arrays, then hand both packages the same thing:

    prog = program_from_fields(**dataclasses.asdict(ref_program))
    plan = plan_from_fields(**dataclasses.asdict(ref_plan))
    coeffs = coeffs_from_numpy(ref_coeffs.center, ref_coeffs.taps, "cpu")
    legacy = spec_coeffs_from_numpy(ref_spec_coeffs.center,
                                    ref_spec_coeffs.neighbors, "cpu")

and an LM configuration, its weights and a training state:

    cfg = arch_from_fields(**dataclasses.asdict(ref_cfg))
    values, _ = repro.models.common.split_params(ref_model.init(key))
    model.load_state_dict(lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, values), "cpu"))
    state = adamw_state_from_numpy(cfg, jax.tree.map(np.asarray, ref_state))

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
from repro_torch.core.spec import StencilCoeffs
from repro_torch.models.transformer import KEEP_F32, LMModel, reference_leaf
from repro_torch.optim.adamw import AdamWState


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
    """A tensor of ``a`` in its own dtype where the port computes in it
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


def spec_coeffs_from_numpy(center, neighbors,
                           device="cpu") -> StencilCoeffs:
    """The legacy pair's coefficients: a reference ``StencilCoeffs`` as
    array-likes (``center``, ``neighbors`` of shape (2*ndim, radius))
    becomes the port's ``StencilCoeffs`` on ``device``, each in its own
    dtype where the kernels take it, as :func:`coeffs_from_numpy`."""
    return StencilCoeffs(center=_tensor_from_numpy(center, device),
                         neighbors=_tensor_from_numpy(neighbors, device))


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
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        out[prefix[:-1]] = tree
        return
    for k, v in items:
        _flatten(v, f"{prefix}{k}.", out)


def _unstacked(cfg: ArchConfig, tree: Mapping) -> Dict[str, np.ndarray]:
    """A reference params-shaped tree (params, an AdamW moment, a
    compression error) as the port model's state-dict names, each
    parameter's leaf (or its unit's slice of it) as
    ``transformer.reference_leaf`` finds it."""
    leaves: Dict[str, np.ndarray] = {}
    _flatten(tree, "", leaves)
    flat = {}
    for name, _ in LMModel(cfg, device="meta").named_parameters():
        leaf, unit = reference_leaf(cfg, name)
        flat[name] = leaves[leaf] if unit is None else leaves[leaf][unit]
    return flat


def lm_params_from_numpy(cfg: ArchConfig, tree: Mapping, device="cpu",
                         train: bool = False) -> Dict[str, torch.Tensor]:
    """The port model's state dict from the reference's params tree (the
    values of ``common.split_params``, leaves as numpy arrays), unstacked
    as ``_unstacked`` does.

    Each leaf is placed as the model places it.  The serving build: layer
    leaves cast from ``param_dtype`` to ``compute_dtype`` (the reference
    casts them at use; norm scales then held in float32) but the
    ``KEEP_F32`` leaves, which keep their own dtype; the rest (the
    embedding tables, ``frontend_proj``, the head, ``final_norm``) in
    ``param_dtype``.  The training build (``train``): every leaf in
    ``param_dtype``, the ``KEEP_F32`` leaves in their own.
    """
    held = {k: v.dtype for k, v in
            LMModel(cfg, device="meta", train=train).state_dict().items()}
    param = getattr(torch, cfg.param_dtype)
    compute = getattr(torch, cfg.compute_dtype)
    out = {}
    for name, v in _unstacked(cfg, tree).items():
        t = _tensor_from_numpy(v, "cpu")
        if name.rsplit(".", 1)[-1] not in KEEP_F32:
            t = t.to(param)
            if name.startswith("layers.") and not train:
                t = t.to(compute)
        out[name] = t.to(held[name]).to(device)
    return out


def lm_tree_from_numpy(cfg: ArchConfig, tree: Mapping,
                       device="cpu") -> Dict[str, torch.Tensor]:
    """A params-shaped reference tree of float32 or bfloat16 leaves (an
    AdamW moment, a ``GradCompression`` error, a gradient), each leaf in
    its dtype, as tensors by the port model's parameter names."""
    return {name: _tensor_from_numpy(v, device)
            for name, v in _unstacked(cfg, tree).items()}


def adamw_state_from_numpy(cfg: ArchConfig, state,
                           device="cpu") -> AdamWState:
    """The port's ``AdamWState`` from the reference's (``step``, ``mu``,
    ``nu``; leaves as numpy arrays): the step a 0-d int32 CPU tensor, the
    moments in their dtype on ``device``."""
    step, mu, nu = state
    return AdamWState(step=torch.tensor(int(np.asarray(step)),
                                        dtype=torch.int32),
                      mu=lm_tree_from_numpy(cfg, mu, device),
                      nu=lm_tree_from_numpy(cfg, nu, device))
