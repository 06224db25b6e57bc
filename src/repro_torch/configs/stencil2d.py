"""The paper's 2D workloads as data — counterpart of ``repro/configs/stencil2d.py``.

``2d_r{1..4}_paper`` is the paper's single-device grid (~16k², Table III);
``2d_r{1..4}_pod`` the cluster-scale grid; ``2d_box_periodic_pod`` a 9-point
box with periodic wrap.  The (block_shape, par_time) pairs are the
reference's hand-written plans; ``workloads(autotune=True)`` swaps them
for the port's autotuner's pick (``repro_torch.tuning``, model-only by
default, measured on the card with ``measure=True``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core.blocking import BlockPlan
from repro_torch.core.program import StencilProgram


@dataclasses.dataclass(frozen=True)
class StencilWorkload:
    name: str
    spec: StencilProgram
    grid_shape: Tuple[int, ...]
    block_shape: Tuple[int, ...]
    par_time: int

    def plan(self) -> BlockPlan:
        return BlockPlan(spec=self.spec, block_shape=self.block_shape,
                         par_time=self.par_time)

    def compile(self, *, steps: int, plan=None, **compile_kwargs):
        """The front door's executable for this workload: ``plan``
        defaults to the workload's own, and every other ``compile`` knob
        (``device``, ``batch``, ``devices``, ``backend``, ``variant``, ...)
        passes through."""
        # local, as autotune_workloads' import: the configs stay light
        from repro_torch.executor import stencil
        return stencil(self.spec).compile(
            self.grid_shape, steps=steps,
            plan=self.plan() if plan is None else plan, **compile_kwargs)


def autotune_workloads(workloads: Dict[str, StencilWorkload], *,
                       chip=None, backend: Optional[str] = None,
                       cache_path: Optional[str] = None,
                       measure: bool = False,
                       device=None) -> Dict[str, StencilWorkload]:
    """Each workload with the autotuner's (block_shape, par_time) in place
    of the hand-written one.  ``measure=False`` is the model's pick;
    ``measure=True`` times the frontier on the card.  ``device`` as in
    ``tuning.autotune`` (None: the CUDA card; "cpu" plans on the CPU)."""
    # local: the tuner imports the backends, which import the kernels
    from repro_torch.tuning import autotune

    out = {}
    for name, w in workloads.items():
        tuned = autotune(w.spec, chip, grid_shape=w.grid_shape,
                         backend=backend, measure=measure,
                         cache_path=cache_path, device=device)
        out[name] = dataclasses.replace(
            w, block_shape=tuned.plan.block_shape,
            par_time=tuned.plan.par_time)
    return out


def workloads(radius: int = 4, *, autotune: bool = False,
              **autotune_kwargs) -> Dict[str, StencilWorkload]:
    out = {}
    for rad in range(1, radius + 1):
        spec = StencilProgram(ndim=2, radius=rad)
        out[f"2d_r{rad}_paper"] = StencilWorkload(
            name=f"2d_r{rad}_paper", spec=spec, grid_shape=(16384, 16384),
            block_shape=(1024, 1024), par_time=max(1, 8 // rad))
        out[f"2d_r{rad}_pod"] = StencilWorkload(
            name=f"2d_r{rad}_pod", spec=spec, grid_shape=(65536, 65536),
            block_shape=(1024, 1024), par_time=max(1, 8 // rad))
    out["2d_box_periodic_pod"] = StencilWorkload(
        name="2d_box_periodic_pod",
        spec=StencilProgram(ndim=2, radius=1, shape="box",
                            boundary="periodic"),
        grid_shape=(65536, 65536), block_shape=(1024, 1024), par_time=4)
    if autotune:
        out = autotune_workloads(out, **autotune_kwargs)
    return out
