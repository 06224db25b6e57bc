"""repro_torch: the stencil framework on PyTorch and hand-written CUDA for
an NVIDIA H100, beside the JAX reference package ``repro``.

One front door, as in the reference::

    import repro_torch

    program = repro_torch.StencilProgram(ndim=2, radius=4)
    cs = repro_torch.stencil(program).compile((16384, 16384), steps=9)
    out = cs.run(grid)          # grid: a tensor on the card in the
                                # program's dtype (float32 by default,
                                # or bfloat16, float16)

``compile`` plans with the autotuner by default (``plan="auto"``);
``plan="model"`` asks the H100 planner, and a ``BlockPlan`` pins a plan.
``repro_torch.obs`` is the flight recorder, ``lower`` the backends'
pre-padded surface, ``autotune`` the tuner: the reference's top-level
names.

The package imports torch and numpy only, never jax or ``repro``.
"""

from repro_torch import obs
from repro_torch.backends import (
    available_backends,
    backend_traits,
    default_backend_name,
    lower,
    pipelined_variant,
    register_backend,
)
from repro_torch.core.blocking import BlockPlan, plan_blocking
from repro_torch.core.program import ProgramCoeffs, StencilProgram
from repro_torch.executor import CompiledStencil, Stencil, stencil
from repro_torch.tuning import TunedPlan, autotune

__version__ = "0.3.0"

__all__ = [
    "BlockPlan",
    "CompiledStencil",
    "ProgramCoeffs",
    "Stencil",
    "StencilProgram",
    "TunedPlan",
    "autotune",
    "available_backends",
    "backend_traits",
    "default_backend_name",
    "lower",
    "obs",
    "pipelined_variant",
    "plan_blocking",
    "register_backend",
    "stencil",
    "__version__",
]
