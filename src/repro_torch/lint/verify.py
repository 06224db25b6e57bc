"""Pre-flight plan checks with the card's budgets — the part of
``repro/lint/verify.py`` that the port's front door runs.

RP105 there asks whether the kernel's VMEM scratch fits the TPU's budget;
here it asks whether one CTA of every superstep kernel the run launches
(``kernels/common.run_kernels``) fits the card's opt-in shared memory per
block at that kernel's smallest CTA tile.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.analysis.hw import GpuChip, H100_SXM
from repro_torch.core.blocking import BlockPlan, normalize_variant
from repro_torch.kernels.common import run_kernels
from repro_torch.kernels.cuda import smallest_tile
from repro_torch.lint.diagnostics import Diagnostic, error

#: How each body holds its data (``BlockPlan.body``), for the message.
_HOLDS = {
    "queue": "planes of its column tile",
    "streamed": "a ring of planes per fused step",
}


def smem_diagnostics(plan: BlockPlan, variant: str = "plain",
                     chip: GpuChip = H100_SXM,
                     grid_shape: Optional[Tuple[int, ...]] = None,
                     steps: Optional[int] = None) -> List[Diagnostic]:
    """RP105 when some kernel the run launches fits no CTA tile in
    ``chip.smem_optin``.

    The kernels are those of :func:`run_kernels` for ``grid_shape`` and
    ``steps`` (without them: the variant's main kernel and its longest
    remainder).  Each kernel's smallest tile candidate needs the least
    shared memory, so it alone decides.  One diagnostic names every kernel
    that does not fit.
    """
    v = normalize_variant(variant)
    over = []
    for kernel, kplan in run_kernels(plan.program, plan, grid_shape, steps,
                                     v):
        tile = smallest_tile(kplan, kernel)
        need = kplan.smem_bytes_for(tile, kernel)
        if need > chip.smem_optin:
            over.append(f"{kernel} ({kplan.kernel_steps(kernel)} fused "
                        f"steps, {_HOLDS[kplan.body(kernel)]}) needs "
                        f"{need} bytes even at its smallest tile {tile}")
    if not over:
        return []
    return [error(
        "RP105",
        f"the {v} run of block={plan.block_shape} par_time="
        f"{plan.par_time} does not fit {chip.name}'s "
        f"{chip.smem_optin} bytes of shared memory per block: "
        + "; ".join(over),
        hint="shrink par_time (every kernel holds par_time*halo_radius of "
             "halo per blocked axis, the temporal chunk 4x that), or pick "
             "variant='plain' for the smallest footprint")]
