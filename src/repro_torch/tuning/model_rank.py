"""Model-guided ranking of design-space candidates — counterpart of
``repro/tuning/model_rank.py`` on the H100 model.

Each candidate is priced by ``core/blocking``'s model of the card: the
body and CTA tile its kernel runs, the cells that body loads and computes
per output cell, and, when the grid is known, the launch cost and the
round-up waste of a steady-state superstep (``blocking.plan_rate``).
Arithmetic only, so the ranking is the same on every CPU run.

Ordering, best first: predicted effective GB/s, then the least round-up
waste, the plain variant before the pipelined and the temporal one, the
smaller ``par_time``, and the larger block.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.analysis.hw import GpuChip, H100_SXM
from repro_torch.core import perf_model
from repro_torch.core.blocking import (VARIANTS, estimate,
                                       grid_useful_fraction, plan_rate)
from repro_torch.core.program import StencilProgram
from repro_torch.tuning.space import Candidate


@dataclasses.dataclass(frozen=True)
class RankedCandidate:
    candidate: Candidate
    predicted_gbps: float      # effective GB/s (model)
    predicted_gcells: float    # useful GCell/s (model)
    predicted_gflops: float    # useful GFLOP/s (model)
    bound: str                 # "compute" | "memory"
    body: str = ""             # the body its carry kernel runs

    def describe(self) -> str:
        return (f"{self.candidate.describe()} ({self.body}) -> "
                f"{self.predicted_gbps:.1f} GB/s "
                f"({self.predicted_gcells:.2f} GCell/s, {self.bound}-bound)")


def predict(program: StencilProgram, candidate: Candidate,
            chip: GpuChip = H100_SXM,
            grid_shape: Optional[Tuple[int, ...]] = None) -> RankedCandidate:
    """The model's prediction for one candidate (launch cost and
    round-up waste charged when ``grid_shape`` is given)."""
    plan, v = candidate.plan, candidate.variant
    est = estimate(plan, chip, v)
    rate = plan_rate(plan, chip, v, grid_shape)
    return RankedCandidate(
        candidate=candidate,
        predicted_gbps=perf_model.gbps_from_cells_per_s(
            rate, cell_bytes=program.bytes_per_cell),
        predicted_gcells=rate / 1e9,
        predicted_gflops=rate * program.flops_per_cell / 1e9,
        bound=est.bound, body=est.body)


def _key(r: RankedCandidate, grid_shape):
    c = r.candidate
    return (r.predicted_gbps,
            grid_useful_fraction(grid_shape, c.plan.block_shape),
            -VARIANTS.index(c.variant), -c.par_time, c.plan.block_shape)


def rank(program: StencilProgram, candidates: Sequence[Candidate],
         chip: GpuChip = H100_SXM, top_k: Optional[int] = None,
         grid_shape: Optional[Tuple[int, ...]] = None
         ) -> List[RankedCandidate]:
    """Candidates ranked best first (non-increasing ``predicted_gbps``);
    ``top_k`` truncates to the measurement frontier."""
    ranked = [predict(program, c, chip, grid_shape) for c in candidates]
    ranked.sort(key=lambda r: _key(r, grid_shape), reverse=True)
    return ranked if top_k is None else ranked[:top_k]
