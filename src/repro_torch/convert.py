"""Carry a configuration and its data across from the reference package.

The tests build a configuration once as the reference's dataclasses and
numpy arrays, then hand both packages the same thing:

    prog = program_from_fields(**dataclasses.asdict(ref_program))
    plan = plan_from_fields(**dataclasses.asdict(ref_plan))
    coeffs = coeffs_from_numpy(ref_coeffs.center, ref_coeffs.taps, "cpu")

Only plain fields and numpy arrays cross, so this module imports nothing
of the reference.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.blocking import BlockPlan
from repro_torch.core.program import ProgramCoeffs, StencilProgram


def program_from_fields(**fields) -> StencilProgram:
    """A port program from the reference program's dataclass fields."""
    return StencilProgram(**fields)


def plan_from_fields(*, spec: Mapping, block_shape: Sequence[int],
                     par_time: int) -> BlockPlan:
    """A port plan from the reference plan's fields, ``spec`` being the
    reference program's fields (as ``dataclasses.asdict`` nests them)."""
    return BlockPlan(spec=program_from_fields(**spec),
                     block_shape=tuple(block_shape), par_time=int(par_time))


def coeffs_from_numpy(center, taps, device="cpu") -> ProgramCoeffs:
    """Port coefficients (float32 tensors on ``device``) from array-likes."""
    return ProgramCoeffs(
        center=torch.tensor(np.asarray(center, dtype=np.float32),
                            device=device),
        taps=torch.tensor(np.asarray(taps, dtype=np.float32).reshape(-1),
                          device=device))
