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

A candidate on a mesh (``candidate.decomp``) is priced per superstep as
one shard's steady-state superstep on its local extent plus its exchange:
``plan.halo``-deep strips sent both ways along every sharded axis, over
NVLink (``GpuChip.nvlink_bytes_per_s``, each way) where the shards have
cards of their own, or read and written through HBM where they share a
card.  The mesh runs the exchange before the kernel on the same stream,
so the two add (the reference overlaps them under ``max``); shards that
share a card run one after another, so ``cards`` below the device count
multiplies the time.  A mesh whose exchange outweighs its kernels is
``exchange``-bound.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from repro_torch.analysis.hw import GpuChip, H100_SXM
from repro_torch.core import perf_model
from repro_torch.core.blocking import (VARIANTS, estimate,
                                       grid_useful_fraction, plan_rate,
                                       superstep_seconds)
from repro_torch.core.program import StencilProgram
from repro_torch.tuning.space import Candidate


@dataclasses.dataclass(frozen=True)
class RankedCandidate:
    candidate: Candidate
    predicted_gbps: float      # effective GB/s (model)
    predicted_gcells: float    # useful GCell/s (model)
    predicted_gflops: float    # useful GFLOP/s (model)
    bound: str                 # "compute" | "memory" | "exchange"
    body: str = ""             # the body its carry kernel runs

    def describe(self) -> str:
        return (f"{self.candidate.describe()} ({self.body}) -> "
                f"{self.predicted_gbps:.1f} GB/s "
                f"({self.predicted_gcells:.2f} GCell/s, {self.bound}-bound)")


def exchange_bytes_per_superstep(program: StencilProgram, plan, decomp,
                                 grid_shape: Tuple[int, ...]) -> int:
    """Bytes one shard sends per superstep: a ``plan.halo``-deep strip of
    its local extent each way along every sharded axis."""
    local = decomp.local_shape(grid_shape)
    total = 0
    for d, shards in enumerate(decomp.axis_shards):
        if shards > 1:
            strip = plan.halo * math.prod(
                local[e] for e in range(program.ndim) if e != d)
            total += 2 * strip * plan.itemsize
    return total


def exchange_seconds(program: StencilProgram, plan, decomp,
                     grid_shape: Tuple[int, ...], chip: GpuChip,
                     shared: bool) -> float:
    """One shard's exchange per superstep: over NVLink, or (``shared``:
    the shards share a card) a read and a write through HBM."""
    moved = exchange_bytes_per_superstep(program, plan, decomp, grid_shape)
    if shared or not chip.nvlink_bytes_per_s:
        return 2 * moved / chip.hbm_bytes_per_s
    return moved / chip.nvlink_bytes_per_s


def predict(program: StencilProgram, candidate: Candidate,
            chip: GpuChip = H100_SXM,
            grid_shape: Optional[Tuple[int, ...]] = None,
            cards: Optional[int] = None) -> RankedCandidate:
    """The model's prediction for one candidate (launch cost and
    round-up waste charged when ``grid_shape`` is given).  A candidate on
    a mesh needs ``grid_shape``; ``cards`` is how many cards its shards
    share (None: a card each)."""
    plan, v = candidate.plan, candidate.variant
    est = estimate(plan, chip, v)
    decomp = candidate.decomp
    if decomp is not None and decomp.n_devices > 1:
        if grid_shape is None:
            raise ValueError("pricing a candidate on a mesh needs "
                             "grid_shape (the exchange and the kernels "
                             "read the local extent)")
        n = decomp.n_devices
        cards = n if cards is None else max(1, min(cards, n))
        local = decomp.local_shape(grid_shape)
        t_local = superstep_seconds(plan, local, chip, v)
        t_ex = exchange_seconds(program, plan, decomp, grid_shape, chip,
                                shared=cards < n)
        t_superstep = -(-n // cards) * (t_local + t_ex)
        rate = math.prod(grid_shape) * plan.par_time / t_superstep
        return RankedCandidate(
            candidate=candidate,
            predicted_gbps=perf_model.gbps_from_cells_per_s(
                rate, cell_bytes=program.bytes_per_cell),
            predicted_gcells=rate / 1e9,
            predicted_gflops=rate * program.flops_per_cell / 1e9,
            bound="exchange" if t_ex > t_local else est.bound,
            body=est.body)
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
    local = grid_shape if c.decomp is None or grid_shape is None \
        else c.decomp.local_shape(grid_shape)
    return (r.predicted_gbps,
            grid_useful_fraction(local, c.plan.block_shape),
            -VARIANTS.index(c.variant), -c.par_time, c.plan.block_shape,
            () if c.decomp is None else c.decomp.axis_shards)


def rank(program: StencilProgram, candidates: Sequence[Candidate],
         chip: GpuChip = H100_SXM, top_k: Optional[int] = None,
         grid_shape: Optional[Tuple[int, ...]] = None,
         cards: Optional[int] = None) -> List[RankedCandidate]:
    """Candidates ranked best first (non-increasing ``predicted_gbps``);
    ``top_k`` truncates to the measurement frontier; ``cards`` as
    :func:`predict`'s."""
    ranked = [predict(program, c, chip, grid_shape, cards)
              for c in candidates]
    ranked.sort(key=lambda r: _key(r, grid_shape), reverse=True)
    return ranked if top_k is None else ranked[:top_k]
