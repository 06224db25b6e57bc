"""torch-reference backend: the port's naive oracle behind the registry —
counterpart of ``repro/backends/xla_ref.py``.

No blocking: boundary-pad the whole grid, apply the tap-set update,
repeat (``core/reference.program_nsteps``).  A ``plan`` is accepted so that
``superstep`` advances the same ``par_time`` steps as the cuda backends.
A leading batch axis passes through.
"""

from __future__ import annotations

from repro_torch.backends.registry import (BackendTraits, LoweredStencil,
                                           register_backend)
from repro_torch.core.reference import program_nsteps
from repro_torch.kernels.common import batch_dims


@register_backend("torch-reference", version=1,
                  traits=BackendTraits(local_kernel=False))
def torch_reference(program, plan, coeffs) -> LoweredStencil:
    par_time = plan.par_time if plan is not None else 1

    def superstep_fn(grid, c):
        batch_dims(program, grid.ndim)
        return program_nsteps(program, c, grid, par_time)

    def run_fn(grid, c, steps):
        batch_dims(program, grid.ndim)
        return program_nsteps(program, c, grid, steps)

    return LoweredStencil(program, plan, coeffs, superstep_fn, run_fn)
