"""Pre-flight plan checks with the card's budgets — the part of
``repro/lint/verify.py`` that the port's front door runs.

RP105 there asks whether the kernel's VMEM scratch fits the TPU's budget;
here it asks whether one CTA of the variant's superstep kernel fits the
card's opt-in shared memory per block with the smallest CTA tile.
"""

from __future__ import annotations

from typing import List

from repro_torch.analysis.hw import GpuChip, H100_SXM
from repro_torch.core.blocking import (BlockPlan, TEMPORAL_CHUNK,
                                       normalize_variant)
from repro_torch.kernels.cuda import smallest_tile
from repro_torch.lint.diagnostics import Diagnostic, error


def smem_diagnostics(plan: BlockPlan, variant: str = "plain",
                     chip: GpuChip = H100_SXM) -> List[Diagnostic]:
    """RP105 when no CTA tile of ``variant`` fits ``chip.smem_optin``.

    The smallest tile candidate needs the least shared memory, so it alone
    decides.  Under "temporal" the chunk-deep window binds both the fused
    launch (B3) and a wrap-degenerate run's pre-padded superstep (B5 with
    the chunk-deep plan); the shallower remainder needs less.
    """
    v = normalize_variant(variant)
    tile = smallest_tile(plan.program.ndim)
    need = plan.smem_bytes_for(tile, v)
    if need <= chip.smem_optin:
        return []
    described = {
        "pipelined": "pipelined (a computing and a prefetch window)",
        "temporal": (f"temporal (one window deepened by the "
                     f"{TEMPORAL_CHUNK}-superstep chunk halo)"),
    }.get(v, "plain (one window)")
    return [error(
        "RP105",
        f"the {described} kernel needs {need} bytes of shared memory per "
        f"CTA even at the smallest tile {tile} for block="
        f"{plan.block_shape} par_time={plan.par_time}, but {chip.name} "
        f"allows {chip.smem_optin} bytes per block",
        hint="shrink par_time (the halo'd window is tile + 2*par_time*"
             "halo_radius per axis, the temporal variant's halo "
             f"{TEMPORAL_CHUNK}x deeper), or pick variant='plain' for the "
             "smallest footprint")]
