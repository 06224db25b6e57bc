"""The port's plain oracles for the stencil kernels (re-exported from
``core/reference``), as ``repro/kernels/ref.py`` re-exports the
reference's: the torch oracles (``program_*``, the legacy ``stencil_*``)
and the float64 numpy ones (``numpy_program_*``).  ``random_grid`` is a
torch draw, not the reference's JAX values."""

from __future__ import annotations

from repro_torch.core.reference import (  # noqa: F401
    numpy_program_nsteps,
    numpy_program_step,
    program_nsteps,
    program_nsteps_unrolled,
    program_step,
    random_grid,
    stencil_nsteps,
    stencil_nsteps_unrolled,
    stencil_step,
)

__all__ = [
    "stencil_step",
    "stencil_nsteps",
    "stencil_nsteps_unrolled",
    "program_step",
    "program_nsteps",
    "program_nsteps_unrolled",
    "numpy_program_step",
    "numpy_program_nsteps",
    "random_grid",
]
