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

The reference's halo alignment is a TPU sublane rule and is dropped.

With ``n_devices`` (or explicit ``decompositions``) the space gains the
reference's mesh decomposition axis: every way of factoring the device
count over the grid's axes (:func:`enumerate_decompositions`), each
(plan, decomposition) pair pruned per shard (:func:`fits_shard`: the
grid divides into the shards, the local extent tiles by the block, the
halo stays within the shard).  The blocks are then those of the local
extent that divide it, and the temporal variant never lands on a mesh
(its chunk would need ``TEMPORAL_CHUNK`` supersteps of halo exchanged at
once).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, List, Optional, Sequence, Tuple

from repro_torch.analysis.hw import GpuChip, H100_SXM
from repro_torch.backends.registry import (backend_traits,
                                           default_backend_name,
                                           get_backend, variant_of)
from repro_torch.core.blocking import (VARIANTS, BlockPlan, candidate_blocks,
                                       candidate_plans)
from repro_torch.core.program import StencilProgram

Shape = Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class MeshDecomposition:
    """Shards per grid axis: how a mesh is laid over the grid (mesh axis
    names are the executor's concern, ``core/distributed.py``)."""

    axis_shards: Shape

    def __post_init__(self):
        if not self.axis_shards or any(s < 1 for s in self.axis_shards):
            raise ValueError(f"bad axis_shards {self.axis_shards}")

    @property
    def n_devices(self) -> int:
        return math.prod(self.axis_shards)

    def local_shape(self, grid_shape: Shape) -> Shape:
        return tuple(g // s for g, s in zip(grid_shape, self.axis_shards))

    def describe(self) -> str:
        return "x".join(map(str, self.axis_shards))


def _factorizations(n: int, ndim: int) -> Iterator[Shape]:
    """All ordered factorizations of ``n`` into ``ndim`` positive factors."""
    if ndim == 1:
        yield (n,)
        return
    for d in range(1, n + 1):
        if n % d == 0:
            for rest in _factorizations(n // d, ndim - 1):
                yield (d,) + rest


def enumerate_decompositions(ndim: int, n_devices: int,
                             grid_shape: Optional[Shape] = None
                             ) -> List[MeshDecomposition]:
    """Every way of splitting ``n_devices`` over ``ndim`` grid axes; with
    a grid, only the splits that divide every axis evenly (the mesh
    refuses the others)."""
    out = []
    for shards in _factorizations(n_devices, ndim):
        if grid_shape is not None and any(
                g % s != 0 for g, s in zip(grid_shape, shards)):
            continue
        out.append(MeshDecomposition(axis_shards=shards))
    return out


def shard_violations(plan: BlockPlan, decomp: MeshDecomposition,
                     grid_shape: Shape) -> List[str]:
    """Why a (plan, decomposition) pair is infeasible per shard ([] if it
    is not), in the reference's words: the reasons of the verifier's
    RP107, and :func:`fits_shard`'s test."""
    bad: List[str] = []
    for d, (g, s, c) in enumerate(zip(grid_shape, decomp.axis_shards,
                                      plan.block_shape)):
        if g % s != 0:
            bad.append(f"axis {d}: grid extent {g} does not divide into "
                       f"{s} shards")
            continue
        local = g // s
        if local % c != 0:
            bad.append(f"axis {d}: local extent {local} does not tile by "
                       f"csize {c}")
        if local < plan.halo:
            bad.append(f"axis {d}: exchange halo {plan.halo} "
                       f"(par_time={plan.par_time} x halo_radius) is deeper "
                       f"than the local extent {local}")
    return bad


def fits_shard(plan: BlockPlan, decomp: MeshDecomposition,
               grid_shape: Shape) -> bool:
    """Whether the pair runs on the mesh (``DistributedStencil`` checks
    the same at construction)."""
    return not shard_violations(plan, decomp, grid_shape)


def mesh_blocks(ndim: int, local: Shape,
                bsizes: Optional[Sequence[Shape]] = None
                ) -> List[Shape]:
    """The blocks of a shard: ``bsizes`` (default
    ``blocking.candidate_blocks`` of the local extent) that divide the
    local extent, as the mesh needs (a shard has no round-up slack)."""
    blocks = candidate_blocks(ndim, local) if bsizes is None else bsizes
    return [tuple(b) for b in blocks
            if len(b) == ndim and all(x >= 1 and n % x == 0
                                      for n, x in zip(local, b))]


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the space: a plan on a backend (``csize`` is the
    plan's block, as in the reference)."""

    plan: BlockPlan
    backend: str
    backend_version: int
    variant: str = "plain"
    #: the mesh it is placed on (None: one device)
    decomp: Optional[MeshDecomposition] = None

    @property
    def csize(self) -> Shape:
        return self.plan.block_shape

    @property
    def par_time(self) -> int:
        return self.plan.par_time

    def describe(self) -> str:
        mesh = "" if self.decomp is None \
            else f" mesh={self.decomp.describe()}"
        return (f"block={'x'.join(map(str, self.csize))} "
                f"par_time={self.par_time} backend={self.backend}"
                f"@v{self.backend_version}{mesh}")


def enumerate_space(program: StencilProgram, chip: GpuChip = H100_SXM, *,
                    backends: Optional[Sequence[str]] = None,
                    backend_version: Optional[int] = None,
                    bsizes: Optional[Sequence[Shape]] = None,
                    grid_shape: Optional[Shape] = None,
                    max_par_time: int = 32,
                    n_devices: Optional[int] = None,
                    decompositions: Optional[
                        Sequence[MeshDecomposition]] = None
                    ) -> List[Candidate]:
    """Every legal (block, par_time, backend) point for ``program`` on
    ``chip``: ``bsizes`` (default ``blocking.candidate_blocks``) are the blocks
    searched, ``backends`` (default: every variant sibling of the default
    backend) the lowerings.  ``n_devices`` (or explicit
    ``decompositions``) adds the decomposition axis (module docstring),
    which needs ``grid_shape``."""
    decomps = decompositions
    if decomps is None and n_devices is not None:
        decomps = enumerate_decompositions(program.ndim, n_devices,
                                           grid_shape)
    if decomps is not None:
        if grid_shape is None:
            raise ValueError("mesh-aware enumeration needs grid_shape (the "
                             "per-shard pruning reads the local extent)")
        for dc in decomps:
            if len(dc.axis_shards) != program.ndim:
                raise ValueError(f"decomposition {dc.axis_shards} is not "
                                 f"{program.ndim}-D")
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
        if decomps is not None:
            if variant == "temporal":
                continue
            for dc in decomps:
                local = dc.local_shape(grid_shape)
                for plan in candidate_plans(
                        program, chip, max_par_time=max_par_time,
                        block_candidates=mesh_blocks(program.ndim, local,
                                                     blocks),
                        variant=variant, grid_shape=local):
                    if fits_shard(plan, dc, grid_shape):
                        out.append(Candidate(plan=plan, backend=name,
                                             backend_version=version,
                                             variant=variant, decomp=dc))
            continue
        for plan in candidate_plans(program, chip, max_par_time=max_par_time,
                                    block_candidates=blocks,
                                    variant=variant, grid_shape=grid_shape):
            out.append(Candidate(plan=plan, backend=name,
                                 backend_version=version, variant=variant))
    return out
