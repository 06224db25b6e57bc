"""Empirical measurement harness — counterpart of ``repro/tuning/measure.py``.

Each model-ranked candidate is lowered through the port's registry
(``backends.lower``) and timed as fused runs on a random grid of the
tuned shape: ``warmup`` runs, then ``reps`` runs in one timed window.  A
frontier's runs all take the same steps, ``supersteps`` full supersteps
(chunks under "temporal") of its deepest candidate, so that the run
executor's fills and copies weigh alike on every candidate.  On a CUDA
device the window is two CUDA events and the run launches the
hand-written kernels (a run that launches none is a failed measurement,
never a time of the plain versions); on the CPU, which the caller asks
for with ``device="cpu"``, it is the host clock around the plain
versions, and the measurement says so in ``device``.

Reported, as the paper's Table III does for its card: useful GCell/s,
effective GB/s (Table I bytes per cell), GFLOP/s, the model's and the
measured ms of the timed run, and the model accuracy (measured over
predicted GB/s).  A candidate that fails to lower or run gives a
``Measurement`` with ``ok=False`` and its error.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.hw import GpuChip, H100_SXM
from repro_torch.backends import lower
from repro_torch.core.blocking import TEMPORAL_CHUNK, run_seconds
from repro_torch.core.program import StencilProgram
from repro_torch.tuning.model_rank import RankedCandidate, predict
from repro_torch.tuning.space import Candidate


@dataclasses.dataclass(frozen=True)
class Measurement:
    """Empirical result for one candidate (``ok=False``: it failed)."""

    ranked: RankedCandidate
    ok: bool
    error: Optional[str] = None
    error_class: Optional[str] = None
    stage: Optional[str] = None        # lower / warmup / timed
    device: str = ""                   # the card's name, or "cpu"
    steps: int = 0                     # steps of one timed run
    us_per_superstep: float = 0.0
    achieved_gcells: float = 0.0       # useful GCell/s
    achieved_gbps: float = 0.0         # effective GB/s
    achieved_gflops: float = 0.0       # useful GFLOP/s
    model_accuracy: float = 0.0        # measured / predicted GB/s
    predicted_ms: float = 0.0          # the model's time of one timed run
    measured_ms: float = 0.0           # the measured time of one

    @property
    def candidate(self):
        return self.ranked.candidate

    def describe(self) -> str:
        if not self.ok:
            where = f" at {self.stage}" if self.stage else ""
            return f"{self.candidate.describe()} -> FAILED{where}: {self.error}"
        return (f"{self.candidate.describe()} ({self.ranked.body}) on "
                f"{self.device}: {self.steps} steps predicted "
                f"{self.predicted_ms:.4f} ms, measured "
                f"{self.measured_ms:.4f} ms (accuracy "
                f"{self.model_accuracy:.3f}), {self.achieved_gbps:.1f} GB/s")


def _launched() -> int:
    # local: the kernel wrappers are not needed to measure on the CPU
    from repro_torch.kernels import cuda
    return sum(cuda.launches().values())


def _timed_ms(run, reps: int, device: torch.device) -> float:
    """Mean ms of ``reps`` calls of ``run`` in one window: CUDA events on
    a card, the host clock on the CPU (where a call returns when done)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    return (time.perf_counter() - t0) * 1e3 / reps


def measure_candidate(program: StencilProgram, ranked: RankedCandidate,
                      grid_shape: Tuple[int, ...], *,
                      chip: GpuChip = H100_SXM, device="cuda",
                      warmup: int = 1, reps: int = 2, supersteps: int = 2,
                      steps: Optional[int] = None,
                      seed: int = 0) -> Measurement:
    """Time one candidate: runs of ``steps`` (default ``supersteps`` of
    its own supersteps).  ``reps``, ``supersteps`` or ``steps`` below 1 or
    a negative ``warmup`` are caller errors and raise; a broken candidate
    is returned with ``ok=False``."""
    if reps < 1:
        raise ValueError(f"reps must be >= 1 (got {reps})")
    if warmup < 0:
        raise ValueError(f"warmup must be >= 0 (got {warmup})")
    if supersteps < 1 or (steps is not None and steps < 1):
        raise ValueError(f"supersteps and steps must be >= 1 (got "
                         f"{supersteps}, {steps})")
    dev = torch.device(device)
    cand = ranked.candidate
    period = _period(cand)
    if steps is None:
        steps = period * supersteps
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    stage = "lower"
    try:
        low = lower(program, cand.plan, backend=cand.backend,
                    version=cand.backend_version)
        gen = torch.Generator(device=dev).manual_seed(seed)
        grid = torch.rand(tuple(grid_shape), generator=gen, device=dev)
        stage = "warmup"
        for _ in range(warmup):
            low.run(grid, steps)
        stage = "timed"
        before = _launched()
        ms = _timed_ms(lambda: low.run(grid, steps), reps, dev)
        if dev.type == "cuda" and _launched() == before:
            raise RuntimeError("the timed runs launched no kernel")
    except Exception as e:  # a broken candidate is recorded, not raised
        return Measurement(ranked=ranked, ok=False,
                           error=f"{type(e).__name__}: {e}",
                           error_class=type(e).__name__, stage=stage,
                           device=name, steps=steps)
    predicted_ms = 1e3 * run_seconds(cand.plan, tuple(grid_shape), steps,
                                     chip, cand.variant)
    cells = math.prod(grid_shape) * steps
    gcells = cells / (ms / 1e3) / 1e9
    gbps = gcells * program.bytes_per_cell
    return Measurement(
        ranked=ranked, ok=True, device=name, steps=steps,
        us_per_superstep=ms * 1e3 * period / steps, achieved_gcells=gcells,
        achieved_gbps=gbps, achieved_gflops=gcells * program.flops_per_cell,
        model_accuracy=predicted_ms / ms, predicted_ms=predicted_ms,
        measured_ms=ms)


def _period(cand) -> int:
    """Steps of one superstep (one chunk under "temporal")."""
    return cand.plan.par_time * (
        TEMPORAL_CHUNK if cand.variant == "temporal" else 1)


def measure_frontier(program: StencilProgram,
                     frontier: Sequence[RankedCandidate],
                     grid_shape: Tuple[int, ...], *, supersteps: int = 2,
                     **kwargs) -> List[Measurement]:
    """Measure every frontier candidate on runs of the same steps,
    ``supersteps`` supersteps of the deepest; failures are kept."""
    steps = supersteps * max(_period(r.candidate) for r in frontier)
    return [measure_candidate(program, r, grid_shape, steps=steps, **kwargs)
            for r in frontier]


def measure_candidates(program: StencilProgram,
                       candidates: Sequence[Candidate],
                       grid_shape: Tuple[int, ...],
                       chip: GpuChip = H100_SXM,
                       **kwargs) -> List[Measurement]:
    """Predict, then measure, raw candidates (a whole small space rather
    than a ranked frontier), in their order; failures are kept
    (``ok=False``).  ``kwargs`` go to :func:`measure_frontier` (``device``
    too: the card unless the caller asks for the CPU)."""
    frontier = [predict(program, c, chip, tuple(grid_shape))
                for c in candidates]
    return measure_frontier(program, frontier, grid_shape, chip=chip,
                            **kwargs)


def best_measurement(measurements: Sequence[Measurement]
                     ) -> Optional[Measurement]:
    """The highest measured throughput among the candidates that ran."""
    ok = [m for m in measurements if m.ok]
    return max(ok, key=lambda m: m.achieved_gcells) if ok else None
