"""IR, oracle and blocking geometry of the PyTorch port.

Layers (counterpart of ``repro.core``):
  program    — StencilProgram IR: shape/boundary-parametric tap sets
  spec       — legacy radius-parameterized star description (thin alias)
  codegen    — tap-set updates and boundary pads
  reference  — the naive PyTorch oracle
  blocking   — blocking plans and the H100 planner
  perf_model — the paper's FPGA performance model and the H100 model's GB/s
  temporal   — the deprecated ``StencilEngine`` shim over the front door
  distributed— the mesh executor and its deep-halo exchange
"""

from repro_torch.core.blocking import (BlockPlan, PlanEstimate, estimate,
                                       plan_blocking)
from repro_torch.core.program import ProgramCoeffs, StencilProgram
from repro_torch.core.spec import StencilCoeffs, StencilSpec

__all__ = [
    "BlockPlan",
    "PlanEstimate",
    "ProgramCoeffs",
    "StencilCoeffs",
    "StencilProgram",
    "StencilSpec",
    "estimate",
    "plan_blocking",
]
