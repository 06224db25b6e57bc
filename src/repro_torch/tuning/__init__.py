"""Plan autotuning on the H100 — counterpart of ``repro/tuning``.

The paper's §V.A methodology as four steps:

    enumerate (space.py)   — every (block, par_time, backend sibling) whose
                             kernels fit a CTA tile for any step count
    rank      (model_rank) — the H100 model (``core/blocking``); keep the
                             top-K frontier worth measuring
    measure   (measure.py) — lower and time each frontier candidate on the
                             card (CUDA events); predicted against measured
    cache     (cache.py)   — keep the winner, keyed by program, grid, GPU
                             name, device and backend@version

One call does all four::

    from repro_torch.tuning import autotune
    tuned = autotune(program, grid_shape=(16384, 16384))
    lowered = lower(program, tuned.plan, backend=tuned.backend)

or from a shell: ``python -m repro_torch.tuning tune --ndim 2 --radius 4
--grid 16384,16384``.  ``autotune(n_devices=N)`` searches the
decomposition axis too (``space.enumerate_decompositions``, each pair
priced with its exchange by ``model_rank.predict``), and
``decomposition=`` pins the split; a mesh is tuned by the model only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.analysis.hw import GpuChip, H100_SXM
from repro_torch.backends.registry import (default_backend_name,
                                           get_backend, variant_of)
from repro_torch.core.blocking import VARIANTS, BlockPlan, candidate_blocks
from repro_torch.core.program import StencilProgram
from repro_torch.tuning.cache import (PlanCache, cache_key,
                                      program_fingerprint)
from repro_torch.tuning.measure import (Measurement, best_measurement,
                                        measure_candidates,
                                        measure_frontier)
from repro_torch.tuning.model_rank import RankedCandidate, predict, rank
from repro_torch.tuning.space import (Candidate, MeshDecomposition,
                                     enumerate_decompositions,
                                     enumerate_space)

__all__ = [
    "Candidate",
    "Measurement",
    "MeshDecomposition",
    "PlanCache",
    "RankedCandidate",
    "TunedPlan",
    "autotune",
    "best_measurement",
    "cache_key",
    "enumerate_decompositions",
    "enumerate_space",
    "measure_candidates",
    "measure_frontier",
    "predict",
    "program_fingerprint",
    "rank",
]

#: The ``Measurement`` fields a cache record keeps.
_MEASURED = ("device", "steps", "us_per_superstep", "achieved_gcells",
             "achieved_gbps", "achieved_gflops", "model_accuracy",
             "predicted_ms", "measured_ms")


@dataclasses.dataclass(frozen=True)
class TunedPlan:
    """The autotuner's answer: a plan, where it came from, and what it
    measured (``measurement`` is None when it ran model-only)."""

    program: StencilProgram
    plan: BlockPlan
    backend: str
    backend_version: int
    predicted_gbps: float
    measurement: Optional[Measurement]
    from_cache: bool
    key: str
    space_size: int = 0
    frontier_size: int = 0
    variant: str = "plain"
    searched_max_par_time: int = 0
    searched_bsizes: Optional[Tuple[Tuple[int, ...], ...]] = None
    # every frontier candidate's measurement, in rank order (not cached)
    measurements: Tuple[Measurement, ...] = ()
    # the winning mesh split (shards per grid axis); None: one device
    decomp: Optional[Tuple[int, ...]] = None

    @property
    def measured_gbps(self) -> float:
        return self.measurement.achieved_gbps if self.measurement else 0.0

    def to_record(self) -> dict:
        """JSON-serializable cache record."""
        m = self.measurement
        return {
            "program": dataclasses.asdict(self.program),
            "block_shape": list(self.plan.block_shape),
            "par_time": self.plan.par_time,
            "backend": self.backend,
            "backend_version": self.backend_version,
            "predicted_gbps": self.predicted_gbps,
            "space_size": self.space_size,
            "frontier_size": self.frontier_size,
            "variant": self.variant,
            "decomp": None if self.decomp is None else list(self.decomp),
            "search": {
                "max_par_time": self.searched_max_par_time,
                "bsizes": None if self.searched_bsizes is None
                else [list(b) for b in self.searched_bsizes],
            },
            "measurement": None if m is None else {
                f: getattr(m, f) for f in _MEASURED},
        }


def _from_record(program: StencilProgram, record: dict,
                 key: str) -> TunedPlan:
    plan = BlockPlan(spec=program, block_shape=tuple(record["block_shape"]),
                     par_time=int(record["par_time"]))
    variant = record.get("variant", "plain")
    decomp = record.get("decomp")
    m = record.get("measurement")
    measurement = None
    if m is not None:
        ranked = RankedCandidate(
            candidate=Candidate(plan=plan, backend=record["backend"],
                                backend_version=record["backend_version"],
                                variant=variant),
            predicted_gbps=record["predicted_gbps"], predicted_gcells=0.0,
            predicted_gflops=0.0, bound="cached")
        measurement = Measurement(ranked=ranked, ok=True, **m)
    search = record.get("search") or {}
    return TunedPlan(program=program, plan=plan, backend=record["backend"],
                     backend_version=record["backend_version"],
                     predicted_gbps=record["predicted_gbps"],
                     measurement=measurement, from_cache=True, key=key,
                     space_size=record.get("space_size", 0),
                     frontier_size=record.get("frontier_size", 0),
                     variant=variant,
                     searched_max_par_time=int(search.get("max_par_time",
                                                          0)),
                     searched_bsizes=None if search.get("bsizes") is None
                     else tuple(tuple(b) for b in search["bsizes"]),
                     decomp=None if decomp is None else tuple(decomp))


def _record_satisfies(record: dict, program: StencilProgram,
                      grid_shape: Tuple[int, ...], *, measure: bool,
                      bsizes: Optional[Sequence[Tuple[int, ...]]],
                      max_par_time: int, top_k: int) -> bool:
    """Whether a cached record honours this request (as the reference):
    a measuring request is never served by a model-only record, and a
    partly measured one only under the same bounds and a frontier no
    wider; the requested space must lie within the searched one, and the
    cached winner within the requested one."""
    search = record.get("search") or {}
    cached_bs = search.get("bsizes")
    if measure:
        if record.get("measurement") is None:
            return False
        frontier = int(record.get("frontier_size", 0))
        if frontier < int(record.get("space_size", 0)):
            same = (max_par_time == int(search.get("max_par_time", 0))
                    and (None if bsizes is None
                         else sorted(tuple(b) for b in bsizes))
                    == (None if cached_bs is None
                        else sorted(tuple(b) for b in cached_bs)))
            if not (same and top_k <= frontier):
                return False
    if max_par_time > int(search.get("max_par_time", 0)):
        return False
    if bsizes is None:
        if cached_bs is not None:
            return False
    else:
        cover = candidate_blocks(program.ndim, grid_shape) \
            if cached_bs is None else cached_bs
        if not {tuple(b) for b in bsizes} <= {tuple(b) for b in cover}:
            return False
    if int(record["par_time"]) > max_par_time:
        return False
    return bsizes is None or tuple(record["block_shape"]) in {
        tuple(b) for b in bsizes}


def autotune(program: StencilProgram, chip: Optional[GpuChip] = None, *,
             grid_shape: Tuple[int, ...],
             backend: Optional[str] = None,
             variant: Optional[str] = None,
             top_k: int = 5,
             measure: bool = True,
             cache: bool = True,
             cache_path: Optional[str] = None,
             force: bool = False,
             bsizes: Optional[Sequence[Tuple[int, ...]]] = None,
             max_par_time: int = 32,
             warmup: int = 1,
             reps: int = 2,
             supersteps: int = 2,
             seed: int = 0,
             device=None,
             n_devices: Optional[int] = None,
             decomposition: Optional[Tuple[int, ...]] = None,
             cards: Optional[int] = None) -> TunedPlan:
    """Tune ``program`` on a ``grid_shape`` workload: search, rank,
    measure, cache.

    ``device`` None is the current CUDA device (a ``ValueError`` when
    none is visible); pass ``device="cpu"`` to plan, or measure the plain
    versions, on the CPU.  ``chip`` None is the visible card's
    (``GpuChip.from_device``) on CUDA and ``H100_SXM`` on the CPU.

    A cache hit (a record that honours the request, see
    :func:`_record_satisfies`) skips everything; ``force`` re-tunes.
    ``measure=False`` keeps the model's best; ``measure=True`` times the
    top ``top_k`` on runs of ``supersteps`` supersteps of the deepest of
    them (``warmup`` and ``reps`` runs each) and keeps the fastest, and
    raises when every one of them fails.  ``variant``: None keeps ``backend`` as named, "auto"
    searches its ``cuda``, ``cuda-pipelined`` and ``cuda-temporal``
    siblings, a variant name pins that sibling.  ``bsizes`` are the block
    shapes searched (default ``blocking.candidate_blocks``); there are no
    padded windows to search, since each kernel picks its own CTA tile.

    ``n_devices`` puts the mesh decomposition on the search axis (every
    factorization that divides the grid, pruned per shard), and
    ``decomposition`` pins shards per axis; the winner's split lands in
    ``TunedPlan.decomp`` under a key of its own.  A mesh is tuned by the
    model only (``measure=True`` raises), ``cards`` being how many cards
    its shards share (``model_rank.predict``).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise ValueError("autotune() runs on a CUDA device by default "
                             "and none is visible; pass device='cpu'")
        device = torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if chip is None:
        chip = GpuChip.from_device(dev.index or 0) \
            if dev.type == "cuda" else H100_SXM
    grid_shape = tuple(int(g) for g in grid_shape)
    name = backend or default_backend_name()
    if variant is None or variant == "auto":
        search = (name,)
        if variant == "auto":
            search = tuple(n for n in (variant_of(name, v) for v in VARIANTS)
                           if n is not None)
    else:
        sibling = variant_of(name, variant)
        if sibling is None:
            raise ValueError(f"backend {name!r} has no {variant!r} lowering "
                             f"to tune; pick a cuda backend or "
                             f"variant='auto'")
        name = sibling
        search = (name,)
    _, version = get_backend(name)

    decomp_req = None
    if decomposition is not None:
        decomp_req = tuple(int(s) for s in decomposition)
    elif n_devices is not None:
        decomp_req = f"ndev={n_devices}"
    if decomp_req is not None and measure:
        raise ValueError("mesh-aware tuning is model-only (the harness "
                         "times one device's run); pass measure=False")

    key = cache_key(program, grid_shape, chip.name, name, version,
                    variant=variant, device=dev.type, decomp=decomp_req)
    store = PlanCache(cache_path) if cache else None
    if store is not None and not force:
        for record in store.get_all(key):
            if _record_satisfies(record, program, grid_shape,
                                 measure=measure, bsizes=bsizes,
                                 max_par_time=max_par_time, top_k=top_k):
                return _from_record(program, record, key)

    decomps = None if decomposition is None \
        else (MeshDecomposition(tuple(int(s) for s in decomposition)),)
    candidates = enumerate_space(
        program, chip, backends=search, bsizes=bsizes,
        grid_shape=grid_shape, max_par_time=max_par_time,
        n_devices=None if decomps is not None else n_devices,
        decompositions=decomps)
    if not candidates:
        raise ValueError(f"empty design space for {program} on {chip.name} "
                         f"(grid {grid_shape}): no plan of the searched "
                         f"variants fits a CTA tile"
                         + (" and a shard of the mesh"
                            if decomp_req is not None else ""))
    frontier = rank(program, candidates, chip, grid_shape=grid_shape,
                    cards=cards)[:max(top_k, 1)]
    winner: RankedCandidate = frontier[0]
    measurement = None
    results: Tuple[Measurement, ...] = ()
    if measure:
        results = tuple(measure_frontier(
            program, frontier, grid_shape, chip=chip, device=dev,
            warmup=warmup, reps=reps, supersteps=supersteps, seed=seed))
        measurement = best_measurement(results)
        if measurement is None:
            raise RuntimeError(
                "every frontier candidate failed to run: " + "; ".join(
                    m.describe() for m in results))
        winner = measurement.ranked
    tuned = TunedPlan(
        program=program, plan=winner.candidate.plan,
        backend=winner.candidate.backend,
        backend_version=winner.candidate.backend_version,
        predicted_gbps=winner.predicted_gbps, measurement=measurement,
        from_cache=False, key=key, space_size=len(candidates),
        frontier_size=len(frontier), variant=winner.candidate.variant,
        searched_max_par_time=max_par_time,
        searched_bsizes=None if bsizes is None
        else tuple(tuple(b) for b in bsizes),
        measurements=results,
        decomp=None if winner.candidate.decomp is None
        else winner.candidate.decomp.axis_shards)
    if store is not None:
        store.add(key, tuned.to_record())
    return tuned
