"""The paper's 3D workloads as data — counterpart of ``repro/configs/stencil3d.py``.

``3d_r{1..4}_paper`` is about the paper's volume (696³ ≈ 3.4e8 cells) with
mesh-divisible extents; ``3d_r{1..4}_pod`` the cluster-scale grid.
``workloads(autotune=True)`` routes through the autotuner as the 2D
configs do.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.stencil2d import (StencilWorkload,
                                           autotune_workloads)
from repro_torch.core.program import StencilProgram

_POD_PAR_TIME = {1: 8, 2: 4, 3: 3, 4: 3}


def workloads(radius: int = 4, *, autotune: bool = False,
              **autotune_kwargs) -> Dict[str, StencilWorkload]:
    out = {}
    for rad in range(1, radius + 1):
        spec = StencilProgram(ndim=3, radius=rad)
        out[f"3d_r{rad}_paper"] = StencilWorkload(
            name=f"3d_r{rad}_paper", spec=spec, grid_shape=(512, 1024, 704),
            block_shape=(32, 64, 704), par_time=max(1, 4 // rad))
        out[f"3d_r{rad}_pod"] = StencilWorkload(
            name=f"3d_r{rad}_pod", spec=spec, grid_shape=(1024, 4096, 2048),
            block_shape=(32, 128, 1024),
            par_time=_POD_PAR_TIME.get(rad, 1))
    if autotune:
        out = autotune_workloads(out, **autotune_kwargs)
    return out
