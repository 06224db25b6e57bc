"""The port's plain oracles for the stencil kernels (re-exported from
``core/reference``), as ``repro/kernels/ref.py`` re-exports the
reference's."""

from __future__ import annotations

from repro_torch.core.reference import (  # noqa: F401
    program_nsteps,
    program_step,
)

__all__ = ["program_step", "program_nsteps"]
