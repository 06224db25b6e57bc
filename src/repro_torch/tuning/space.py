"""Design-space enumeration for the autotuner — counterpart of
``repro/tuning/space.py`` for one H100.

The reference tunes (bsize, par_time, backend) for a TPU and prunes by
the VMEM budget and by LANE/SUBLANE alignment.  Neither applies here:
each kernel picks its own CTA tile, so a plan's block only rounds the
padded layout, and what a plan must fit is the card's shared memory per
block.  So the space is (block, par_time, backend sibling):

* blocks: the grid's extents, halves and quarters and the
  configurations' own blocks (``blocking.candidate_blocks``);
* par_time: 1..``max_par_time``, pruned by ``blocking.candidate_plans``:
  every kernel of the variant fits a CTA tile for any step count
  (``lint/verify.smem_diagnostics``), and more than
  ``MIN_USEFUL_FRACTION`` of the cells the body computes are output;
* backends: the registered variant siblings asked for.

The reference's halo alignment is a TPU sublane rule and is dropped.  The
mesh decomposition axis (``MeshDecomposition``,
``enumerate_decompositions``) waits for the mesh executor (ROADMAP A9).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.analysis.hw import GpuChip, H100_SXM
from repro_torch.backends.registry import (backend_traits,
                                           default_backend_name,
                                           get_backend, variant_of)
from repro_torch.core.blocking import VARIANTS, BlockPlan, candidate_plans
from repro_torch.core.program import StencilProgram

Shape = Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the space: a plan on a backend (``csize`` is the
    plan's block, as in the reference)."""

    plan: BlockPlan
    backend: str
    backend_version: int
    variant: str = "plain"

    @property
    def csize(self) -> Shape:
        return self.plan.block_shape

    @property
    def par_time(self) -> int:
        return self.plan.par_time

    def describe(self) -> str:
        return (f"block={'x'.join(map(str, self.csize))} "
                f"par_time={self.par_time} backend={self.backend}"
                f"@v{self.backend_version}")


def enumerate_space(program: StencilProgram, chip: GpuChip = H100_SXM, *,
                    backends: Optional[Sequence[str]] = None,
                    backend_version: Optional[int] = None,
                    bsizes: Optional[Sequence[Shape]] = None,
                    grid_shape: Optional[Shape] = None,
                    max_par_time: int = 32) -> List[Candidate]:
    """Every legal (block, par_time, backend) point for ``program`` on
    ``chip``: ``bsizes`` (default ``blocking.candidate_blocks``) are the blocks
    searched, ``backends`` (default: every variant sibling of the default
    backend) the lowerings."""
    if backends is None:
        base = default_backend_name()
        backends = tuple(n for n in (variant_of(base, v) for v in VARIANTS)
                         if n is not None)
    blocks = None if bsizes is None else [
        tuple(b) for b in bsizes if len(b) == program.ndim]
    out: List[Candidate] = []
    for name in backends:
        version = get_backend(name, backend_version)[1]
        variant = backend_traits(name, version).variant
        for plan in candidate_plans(program, chip, max_par_time=max_par_time,
                                    block_candidates=blocks,
                                    variant=variant, grid_shape=grid_shape):
            out.append(Candidate(plan=plan, backend=name,
                                 backend_version=version, variant=variant))
    return out
