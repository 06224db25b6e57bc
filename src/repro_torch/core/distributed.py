"""The mesh executor: domain decomposition and the deep-halo exchange —
counterpart of ``repro/core/distributed.py``.

The paper's overlapped temporal blocking, lifted from one card to a mesh
of shards: each shard keeps its part of the grid as a padded carry
(``kernels/common.PaddedLayout``, ring ``H = plan.halo`` deep) and, once
per superstep of ``par_time`` steps, receives ``h``-deep strips of its
neighbours' interior into that ring (``h`` = the superstep's halo, less
for the remainder), instead of a radius-deep halo every step.  The strip
depth follows the program's tap set; the boundary follows the program:
a sharded periodic axis closes its exchange ring (the last shard feeds
the first), and on a clamp or constant grid the cells outside the global
grid are left as they are and healed by the carry kernel's t=0 fixup at
global coordinates (the sharded instantiations of B1 and B4).

One process drives the mesh, as the reference's ``shard_map`` is one
controller: a shard is a padded ping-pong pair on its mesh device, and per
superstep, in this order,

1. the exchange along each sharded axis, in axis order
   (:func:`_exchange_into_ring`, the strips of ``common.exchange_copies``):
   tensor copies between shard buffers, a peer copy where two shards sit
   on different cards.  A strip spans the whole padded extent of the other
   axes, so a later axis forwards the corners an earlier one brought;
2. the wrap refresh (B2) of the device-local periodic axes, over the
   freshly exchanged ring;
3. the carry kernel of the variant (B1 or B4) with the shard's origin and
   the global extent.

Every shard's launches go to the current stream of its card, so shards
that share a card run one after another on one stream, and a copy between
two cards is ordered after both cards' earlier work by PyTorch's peer copy
(which waits on both devices' current streams); nothing synchronises the
host inside the superstep loop.  The run takes the global grid on the
compile's device, scatters it into the shards once and gathers the
result once.

:func:`visible_devices` lays the mesh over the cards: one mesh device per
card, or with ``REPRO_TORCH_FORCE_DEVICE_COUNT=N`` N of them round-robin
over the visible cards (N CPU devices with ``device="cpu"``), the
counterpart of the reference's forced host device count
(``XLA_FLAGS=--xla_force_host_platform_device_count``).  So four shards
run on one card, their launches serialised; on a host with four cards the
same code puts one on each.
"""

from __future__ import annotations

import dataclasses
import math
import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.core.blocking import BlockPlan
from repro_torch.core.codegen import boundary_pad
from repro_torch.core.program import (ProgramCoeffs, StencilProgram,
                                      torch_dtype)
from repro_torch.kernels import common

AxisNames = Tuple[str, ...]

#: How many mesh devices to lay over the visible cards (or the CPU).
ENV_DEVICE_COUNT = "REPRO_TORCH_FORCE_DEVICE_COUNT"


def visible_devices(device=None) -> Tuple[torch.device, ...]:
    """The devices a mesh may use beside ``device`` (None: the current
    CUDA card; "cpu": the CPU).  With ``REPRO_TORCH_FORCE_DEVICE_COUNT=N``,
    N devices round-robin over the visible cards from ``device``'s on (N
    CPU devices for the CPU); unset, one per card (one CPU device)."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    raw = os.environ.get(ENV_DEVICE_COUNT, "").strip()
    forced = None
    if raw:
        try:
            forced = int(raw)
        except ValueError:
            forced = 0
        if forced < 1:
            raise ValueError(f"{ENV_DEVICE_COUNT}={raw!r}: give a positive "
                             f"device count")
    if dev.type != "cuda":
        return (dev,) * (forced or 1)
    cards = torch.cuda.device_count()
    base = torch.cuda.current_device() if dev.index is None else dev.index
    return tuple(torch.device("cuda", (base + i) % cards)
                 for i in range(forced or cards))


class Mesh:
    """Named mesh axes over an explicit list of devices, row-major (the
    last axis fastest), as ``jax.sharding.Mesh`` lays its device array;
    one device may appear more than once."""

    def __init__(self, devices: Sequence[torch.device],
                 axis_shape: Sequence[int], axis_names: Sequence[str]):
        self.axis_names = tuple(axis_names)
        self.devices = tuple(torch.device(d) for d in devices)
        dims = tuple(int(s) for s in axis_shape)
        if len(dims) != len(self.axis_names) or min(dims, default=1) < 1:
            raise ValueError(f"mesh shape {dims} does not name "
                             f"{len(self.axis_names)} positive axes")
        if math.prod(dims) != len(self.devices):
            raise ValueError(f"a mesh of shape {dims} needs "
                             f"{math.prod(dims)} devices, got "
                             f"{len(self.devices)}")
        #: {axis name: size}, as ``jax.sharding.Mesh.shape``
        self.shape: Dict[str, int] = dict(zip(self.axis_names, dims))

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, index: int) -> Dict[str, int]:
        """The mesh coordinates of device ``index``."""
        out = {}
        for name in reversed(self.axis_names):
            index, out[name] = divmod(index, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    def cards(self) -> Tuple[torch.device, ...]:
        """The distinct devices of the mesh, in first-seen order."""
        return tuple(dict.fromkeys(self.devices))


def make_mesh(axis_shards: Sequence[int],
              devices: Sequence[torch.device]) -> Mesh:
    """A mesh of ``axis_shards`` over the first ``prod(axis_shards)`` of
    ``devices``, axes named ``d0, d1, ...``."""
    n = math.prod(axis_shards)
    if len(devices) < n:
        raise ValueError(f"a {'x'.join(map(str, axis_shards))} mesh needs "
                         f"{n} devices, {len(devices)} given")
    return Mesh(list(devices)[:n], axis_shards,
                [f"d{i}" for i in range(len(axis_shards))])


@dataclasses.dataclass(frozen=True)
class Decomposition:
    """How grid axes map onto mesh axes: ``partition[d]`` names the mesh
    axes (maybe none) that shard grid axis d, e.g. ``(("d0",), ("d1",))``
    for a 2D grid over a 2D mesh."""

    partition: Tuple[AxisNames, ...]

    def shards(self, mesh: Mesh, d: int) -> int:
        return math.prod(mesh.shape[a] for a in self.partition[d]) \
            if self.partition[d] else 1

    def index(self, mesh: Mesh, coords: Dict[str, int], d: int) -> int:
        """The shard index along grid axis d of the device at ``coords``
        (row-major over the axis's mesh axes)."""
        i = 0
        for a in self.partition[d]:
            i = i * mesh.shape[a] + coords[a]
        return i


# ---- the exchanges ----------------------------------------------------------


def _edge_halo(program: StencilProgram, block: torch.Tensor, axis: int,
               h: int, side: str) -> torch.Tensor:
    """The ``h``-deep halo of a global edge: the border slab repeated
    (clamp) or the boundary value (constant)."""
    size = block.shape[axis]
    if program.boundary == "constant":
        shape = list(block.shape)
        shape[axis] = h
        return block.new_full(shape, program.boundary_value)
    slab = block.narrow(axis, 0 if side == "lo" else size - 1, 1)
    reps = [1] * block.ndim
    reps[axis] = h
    return slab.repeat(reps)


def exchange_halo(block: torch.Tensor, left: Optional[torch.Tensor],
                  right: Optional[torch.Tensor], axis: int, h: int,
                  program: StencilProgram) -> torch.Tensor:
    """``block`` grown by ``h`` on both sides of ``axis``: the left
    neighbour's high strip below it and the right neighbour's low strip
    above it (copied to ``block``'s device), or at an open global edge
    (``None``) the halo the program's boundary synthesises.  A periodic
    axis passes its wrap-around neighbours, so it has no open edge."""
    if left is None:
        lo = _edge_halo(program, block, axis, h, "lo")
    else:
        lo = left.narrow(axis, left.shape[axis] - h, h).to(block.device)
    if right is None:
        hi = _edge_halo(program, block, axis, h, "hi")
    else:
        hi = right.narrow(axis, 0, h).to(block.device)
    return torch.cat([lo, block, hi], dim=axis)


def _exchange_into_ring(pairs: Sequence[torch.Tensor],
                        neighbours: Sequence[Tuple[Optional[int],
                                                   Optional[int]]],
                        axis: int, h: int, H: int, nloc: int) -> None:
    """Refresh the ring of every shard's padded source along ``axis`` in
    place: the strips of ``common.exchange_copies`` (``h`` deep, at ring
    offset ``H - h``, spanning the whole padded extent of the other axes),
    shard ``j`` receiving from ``neighbours[j] = (left, right)`` (None: an
    open global edge, whose ring the kernel's t=0 fixup heals).  ``axis``
    counts the batch axis.  Receives write only ring cells and sends read
    only interior cells, so the copies of one axis commute."""
    into_lo, into_hi = common.exchange_copies(axis, h, H, nloc)
    for j, (left, right) in enumerate(neighbours):
        dst = pairs[j]
        for c, src in ((into_lo, left), (into_hi, right)):
            if src is None:
                continue
            dst.narrow(axis, c.dst[0], c.width).copy_(
                pairs[src].narrow(axis, c.src[0], c.width))


def _local_superstep(blocks: Sequence[torch.Tensor], center, taps, *,
                     program: StencilProgram, plan: BlockPlan,
                     neighbours, offsets, global_shape, nb: int = 0,
                     variant: Optional[str] = None) -> List[torch.Tensor]:
    """One superstep of every shard in the concat form (the reference's
    ``_local_superstep``): halos exchanged axis by axis (a later axis
    carries the halos of the earlier ones), boundary padding on the
    unsharded axes, then the pre-padded superstep (B5/B6) with the shard's
    origin in the global grid.  ``neighbours[d][j]`` is shard j's
    ``(left, right)`` along grid axis d, or None on an unsharded axis."""
    h = plan.halo
    haloed = list(blocks)
    for d in range(program.ndim):
        if neighbours[d] is None:
            pads = [(0, 0)] * haloed[0].ndim
            pads[nb + d] = (h, h)
            haloed = [boundary_pad(program, b, pads) for b in haloed]
            continue
        prev = haloed
        haloed = [exchange_halo(
            b, None if left is None else prev[left],
            None if right is None else prev[right], nb + d, h, program)
            for b, (left, right) in zip(prev, neighbours[d])]
    out = []
    for b, offs in zip(haloed, offsets):
        out.append(common.superstep_call(
            b.contiguous(), center.to(b.device), taps.to(b.device),
            program=program, plan=plan, true_shape=tuple(global_shape),
            offsets=offs, variant=variant))
    return out


# ---- the executor -----------------------------------------------------------


class MeshRun:
    """The mesh executable of one (remainder, batch rank): the padded
    layout, every shard's origin and neighbours, and per superstep depth
    the exchanges, built once; ``__call__(grid, full)`` runs ``full``
    supersteps and the remainder."""

    def __init__(self, dist: "DistributedStencil", rem: int, nb: int):
        program, plan = dist.program, dist.plan
        self.dist, self.nb = dist, nb
        self.sched = common.ring_schedule(
            program, plan, dist.global_shape, plan.par_time + rem,
            variant=dist.variant, decomp=dist.axis_shards)
        self.layout = self.sched.layout
        self.rem_plan = dataclasses.replace(plan, par_time=rem) \
            if rem else None
        self.local = self.layout.local_shape
        H = self.layout.halo
        self.interior = (Ellipsis,) + tuple(slice(H, H + n)
                                            for n in self.local)

    def scatter(self, grid: torch.Tensor) -> List[List[torch.Tensor]]:
        """Every shard's padded pair, its source holding its part of
        ``grid`` (the one copy in)."""
        lead = tuple(grid.shape[:self.nb])
        pairs = []
        for dev, sl in zip(self.dist.mesh.devices, self.dist.slices):
            src = torch.zeros(lead + self.layout.padded_shape,
                              dtype=grid.dtype, device=dev)
            src[self.interior].copy_(grid[(Ellipsis,) + sl])
            pairs.append([src, torch.zeros_like(src)])
        return pairs

    def gather(self, pairs, like: torch.Tensor) -> torch.Tensor:
        """The shards' interiors as one grid on ``like``'s device (the one
        copy out)."""
        out = torch.empty_like(like)
        for (src, _), sl in zip(pairs, self.dist.slices):
            out[(Ellipsis,) + sl].copy_(src[self.interior])
        return out

    def exchange(self, pairs, h: int) -> None:
        """Step 1 of a superstep: the ``h``-deep exchange along every
        sharded axis, in axis order, into the sources' rings."""
        srcs = [p[0] for p in pairs]
        for d in self.sched.sharded_axes:
            _exchange_into_ring(srcs, self.dist.neighbours[d], self.nb + d,
                                h, self.layout.halo, self.local[d])

    def superstep(self, pairs, step_plan: BlockPlan) -> None:
        """One superstep of every shard: the exchange, the wrap refresh of
        the device-local periodic axes, the carry kernel; then each pair
        swaps."""
        dist = self.dist
        self.exchange(pairs, step_plan.halo)
        for j, pair in enumerate(pairs):
            src, dst = pair
            if self.layout.wrap_axes:
                common.refresh_wrap_halo(src, self.layout)
            c = dist.coeffs_on(src.device)
            common.padded_superstep(
                src, dst, c.center, c.taps, program=dist.program,
                plan=step_plan, layout=self.layout, variant=dist.variant,
                offsets=dist.offsets[j], global_shape=dist.global_shape)
            pair.reverse()

    def __call__(self, grid: torch.Tensor, full: int) -> torch.Tensor:
        pairs = self.scatter(grid)
        for _ in range(full):
            self.superstep(pairs, self.dist.plan)
        if self.rem_plan is not None:
            self.superstep(pairs, self.rem_plan)
        return self.gather(pairs, grid)


@dataclasses.dataclass
class DistributedStencil:
    """A stencil problem decomposed over a mesh.

    Direct construction is deprecated (it warns): the front door,
    ``repro_torch.stencil(...).compile(grid_shape, steps=...,
    devices=...)``, resolves the decomposition, builds the mesh and
    dispatches here.  ``backend``/``variant`` resolve the local kernel
    through the registry as the front door does; the temporal chunk
    (whose launch would read ``TEMPORAL_CHUNK`` supersteps of halo) and a
    backend without ``local_kernel`` (the oracle pads its own boundaries)
    are refused with RP110.  ``coeffs`` default to the program's.
    """

    spec: StencilProgram
    coeffs: Optional[ProgramCoeffs]
    plan: BlockPlan
    mesh: Mesh
    decomp: Decomposition
    global_shape: Tuple[int, ...]
    backend: Optional[str] = None
    variant: Optional[str] = None
    # Internal constructions (the front door) pass _warn=False.
    _warn: bool = True

    def __post_init__(self):
        # local: backends import the kernels, which the executor imports
        from repro_torch.backends import resolve_backend
        if self._warn:
            warnings.warn(
                "constructing DistributedStencil directly is deprecated; "
                "use repro_torch.stencil(program, coeffs).compile("
                "grid_shape, steps=..., devices=<count or shards per "
                "axis>) — the front door builds the mesh and dispatches "
                "to the same executor",
                DeprecationWarning, stacklevel=3)
        self.program = self.spec
        if self.coeffs is None:
            self.coeffs = self.program.default_coeffs()
        self.global_shape = tuple(int(g) for g in self.global_shape)
        name, version, traits = resolve_backend(self.backend,
                                                variant=self.variant)
        if traits.variant == "temporal":
            raise ValueError(
                f"RP110: backend {name!r} (the temporally-fused variant) "
                f"cannot run sharded: its launch advances a whole superstep "
                f"chunk per kernel, but the mesh exchanges halos once per "
                f"superstep — the chunk would read neighbor cells that were "
                f"never exchanged (fix: variant='plain' or 'pipelined' on "
                f"the mesh)")
        if not traits.local_kernel:
            raise ValueError(
                f"RP110: backend {name!r} cannot serve as the distributed "
                f"local kernel (no local_kernel trait); use a cuda backend")
        self.backend_name, self.backend_version = name, version
        self.variant = traits.variant
        ndim = self.program.ndim
        self.axis_shards = tuple(self.decomp.shards(self.mesh, d)
                                 for d in range(ndim))
        for d in range(ndim):
            n = self.axis_shards[d]
            if self.global_shape[d] % n != 0:
                raise ValueError(
                    f"grid axis {d} ({self.global_shape[d]}) not divisible "
                    f"by {n} shards")
            local = self.global_shape[d] // n
            if local % self.plan.block_shape[d] != 0:
                raise ValueError(
                    f"local extent {local} on axis {d} not divisible by "
                    f"block {self.plan.block_shape[d]}; shrink the block")
            if local < self.plan.halo:
                raise ValueError(
                    f"halo {self.plan.halo} exceeds local extent {local}; "
                    f"reduce par_time or shards")
        local = tuple(g // s for g, s in zip(self.global_shape,
                                             self.axis_shards))
        # per shard (mesh device order): grid-axis indices, origin, slices
        at, indices = {}, []
        self.offsets, self.slices = [], []
        for j in range(self.mesh.size):
            coords = self.mesh.coords(j)
            idx = tuple(self.decomp.index(self.mesh, coords, d)
                        for d in range(ndim))
            at[idx] = j
            indices.append(idx)
            self.offsets.append(tuple(i * n for i, n in zip(idx, local)))
            self.slices.append(tuple(slice(o, o + n) for o, n in
                                     zip(self.offsets[-1], local)))
        periodic = self.program.boundary == "periodic"
        #: per grid axis, every shard's (left, right) neighbour, or None on
        #: an axis of one shard; a periodic axis's ring closes
        self.neighbours = []
        for d in range(ndim):
            n = self.axis_shards[d]
            if n == 1:
                self.neighbours.append(None)
                continue
            pairs = []
            for idx in indices:

                def shard(i, idx=idx):
                    if not 0 <= i < n:
                        if not periodic:
                            return None
                        i %= n
                    k = list(idx)
                    k[d] = i
                    return at[tuple(k)]

                pairs.append((shard(idx[d] - 1), shard(idx[d] + 1)))
            self.neighbours.append(tuple(pairs))
        self._coeffs = {}
        #: mesh executables, keyed by (remainder, batch rank): the only
        #: things that change what a run does (the full superstep count
        #: is an argument)
        self._exes: Dict[Tuple[int, int], MeshRun] = {}

    def coeffs_on(self, device: torch.device) -> ProgramCoeffs:
        """The coefficients on ``device`` in the grid's dtype (the
        kernels' cast, ``common.grid_coeffs``), made there once."""
        c = self._coeffs.get(device)
        if c is None:
            dt = torch_dtype(self.program.dtype)
            c = self._coeffs[device] = ProgramCoeffs(
                self.coeffs.center.to(device, dt),
                self.coeffs.taps.to(device, dt))
        return c

    def run_fn(self, rem: int = 0, nb: int = 0) -> MeshRun:
        """The mesh executable of remainder ``rem`` and batch rank ``nb``,
        built once per instance."""
        key = (rem, nb)
        exe = self._exes.get(key)
        if exe is None:
            exe = self._exes[key] = MeshRun(self, rem, nb)
        return exe

    def superstep(self, grid: torch.Tensor) -> torch.Tensor:
        """One superstep in the concat form: every shard's halo exchanged
        (``exchange_halo``), then the pre-padded superstep (B5, or B6 for
        "pipelined") with its origin; the result gathered on ``grid``'s
        device."""
        nb = common.batch_dims(self.program, grid.ndim)
        blocks = [grid[(Ellipsis,) + sl].to(dev)
                  for dev, sl in zip(self.mesh.devices, self.slices)]
        c = self.coeffs
        outs = _local_superstep(
            blocks, c.center, c.taps, program=self.program, plan=self.plan,
            neighbours=self.neighbours, offsets=self.offsets,
            global_shape=self.global_shape, nb=nb, variant=self.variant)
        out = torch.empty_like(grid)
        for o, sl in zip(outs, self.slices):
            out[(Ellipsis,) + sl].copy_(o)
        return out

    def run(self, grid: torch.Tensor, steps: int) -> torch.Tensor:
        """Advance ``steps`` time steps: ``steps // par_time`` full
        supersteps and the remainder, one scatter and one gather.  ``grid``
        (optionally ``(B, *grid)``) is not written; the result is a new
        tensor on its device."""
        if steps < 0:
            raise ValueError("steps must be >= 0")
        nb = common.batch_dims(self.program, grid.ndim)
        if steps == 0:
            return grid.clone()
        full, rem = divmod(steps, self.plan.par_time)
        rec = obs.active()
        if rec is not None and not torch.compiler.is_compiling():
            # what each superstep's exchange moves: the full supersteps a
            # plan.halo-deep strip per sharded axis, the remainder a
            # rem*halo_radius-deep one
            rec.event(
                "exchange", depth=self.plan.halo,
                rem_depth=rem * self.program.halo_radius,
                supersteps=int(full), rem=rem,
                decomp=list(self.axis_shards), batch_rank=nb,
                backend=f"{self.backend_name}@{self.backend_version}",
                boundary=self.program.boundary)
        return self.run_fn(rem, nb)(grid, full)
