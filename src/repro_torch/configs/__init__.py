"""Workload tables of the PyTorch port: the paper's stencil workloads
(``stencil2d``, ``stencil3d``), the ten LM architectures and the four
input shapes of the dry run.

``get_arch(name)`` / ``ARCHS`` hold the same ``ArchConfig`` values as the
reference's registry (``repro/configs/__init__.py``); ``SHAPES`` and
``input_specs`` are ``configs/shapes.py``'s.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import (SHAPES, ShapeSpec, input_specs,
                                        shape_applicable)
from repro_torch.configs import (  # noqa: E402
    gemma2_27b,
    gemma3_4b,
    granite_moe_3b_a800m,
    grok1_314b,
    jamba_v01_52b,
    llava_next_34b,
    minicpm3_4b,
    musicgen_large,
    rwkv6_7b,
    starcoder2_7b,
)

ARCHS: Dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG.validate()
    for m in (
        minicpm3_4b, starcoder2_7b, gemma2_27b, gemma3_4b, llava_next_34b,
        jamba_v01_52b, musicgen_large, grok1_314b, granite_moe_3b_a800m,
        rwkv6_7b,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ArchConfig", "SHAPES", "ShapeSpec", "get_arch",
           "input_specs", "shape_applicable"]
