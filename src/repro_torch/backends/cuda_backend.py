"""CUDA backends: the hand-written superstep kernels behind the registry —
counterpart of ``repro/backends/pallas_backend.py``.

``cuda`` runs B1 (and B5 for ``superstep``), ``cuda-pipelined`` the
prefetching B4/B6, ``cuda-temporal`` the chunk-fused B3 (its ``superstep``
is the plain B5: a lone superstep has no chunk to fuse).  ``run`` is the
fused run executor (``ops._stencil_run``).  A CUDA grid launches the
kernels; a CPU grid runs their plain PyTorch versions.  All accept a
leading batch axis.  ``lower`` hands them a plan (the planner's when the
caller gives none).
"""

from __future__ import annotations

from repro_torch.backends.registry import (BackendTraits, LoweredStencil,
                                           register_backend)
from repro_torch.core.blocking import BlockPlan
from repro_torch.core.program import ProgramCoeffs, StencilProgram
from repro_torch.kernels import ops


def _make(program: StencilProgram, plan: BlockPlan,
          coeffs: ProgramCoeffs, variant: str) -> LoweredStencil:
    def superstep_fn(grid, c):
        return ops.stencil_superstep(grid, program, c, plan, variant=variant)

    def run_fn(grid, c, steps):
        return ops._stencil_run(grid, program, c, plan, steps,
                                variant=variant)

    return LoweredStencil(program, plan, coeffs, superstep_fn, run_fn)


@register_backend("cuda", version=1,
                  traits=BackendTraits(local_kernel=True, fused_run=True))
def cuda_plain(program, plan, coeffs) -> LoweredStencil:
    """One CTA per tile: B1 for runs, B5 for a lone superstep."""
    return _make(program, plan, coeffs, "plain")


@register_backend("cuda-pipelined", version=1,
                  traits=BackendTraits(variant="pipelined", local_kernel=True,
                                       fused_run=True))
def cuda_pipelined(program, plan, coeffs) -> LoweredStencil:
    """Persistent CTAs prefetching the next window: B4 and B6."""
    return _make(program, plan, coeffs, "pipelined")


# The temporal variant's chunk-deep launch consumes TEMPORAL_CHUNK supersteps
# of halo per window load, which a per-superstep halo exchange cannot feed,
# so it declares local_kernel=False and a sharded run refuses it instead of
# computing garbage halos.

@register_backend("cuda-temporal", version=1,
                  traits=BackendTraits(variant="temporal", fused_run=True))
def cuda_temporal(program, plan, coeffs) -> LoweredStencil:
    """TEMPORAL_CHUNK supersteps fused per launch: B3."""
    return _make(program, plan, coeffs, "temporal")
