"""RP4xx symbolic half: abstract interpretation of the padded ring
schedule — counterpart of ``repro/lint/dataflow.py``.

The fused executor (``kernels/common.run_call``, and on a mesh
``core/distributed.DistributedStencil.run``) never re-pads a boundary:
its correctness rests on a schedule of ping-pong buffers, wrap refreshes
of the source's ring (B2, ordered before the superstep on the same
stream), exchange strips into a shard's ring, ring-offset windows for a
remainder superstep and the temporal chunk's deeper ring.
:func:`verify_dataflow` proves that schedule sound for one (program,
plan, grid, variant, steps[, decomp]) configuration by interpreting
``kernels/common.ring_schedule`` — the metadata the executors launch
from — over a per-axis timestamp lattice:

* every cell a superstep's windows read must hold the current time's
  value: from the initial copy into the carry, a prior superstep's
  write, a wrap or exchange copy, or (out of the grid under
  clamp/constant, on an axis one shard holds) the kernel's t=0
  ``boundary_fixup`` — else **RP401**, or **RP405** when a periodic wrap
  copy is missing or ordered after the read;
* the output tiles write every interior cell exactly once per superstep
  — **RP402** for holes, **RP403** for overlaps or writes outside;
* the superstep writes the other buffer of the pair, never the one its
  windows read — **RP404**.

Axes are independent under the axis-ordered ring schedule (a wrap copy
spans the whole padded extent of the other axes, windows are Cartesian
products), so the interpreter runs per axis on 1-D integer arrays: numpy
and integers only, well under the front door's 2 ms budget.  A sharded
axis's exchange strips are modelled by symmetry, as the reference does:
every shard sees the same state pattern, so a neighbour's strip carries
this shard's own timestamps, and a sharded axis gets no fixup exemption
(an inner shard's ring holds other shards' interior, which must arrive
by exchange).

The dynamic half is ``lint/sanitize.py``: tests seed the same schedule
bugs into both (they share ``kernels.common.wrap_copies`` and
``ping_pong_aliases``) and require the same code from each.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.core.blocking import BlockPlan
from repro_torch.lint.diagnostics import Diagnostic, error, raise_on_error

#: Timestamp of a cell that no copy, write or fixup initialised.
STALE = -1


def verify_dataflow(program, plan: BlockPlan, grid_shape, *,
                    steps: int, variant: Optional[str] = None,
                    decomp=None, schedule=None) -> List[Diagnostic]:
    """Prove the padded ring schedule of one run configuration correct.

    Returns every RP4xx finding (an empty list: the schedule is sound).
    ``decomp`` (shards per axis or a ``tuning.space.MeshDecomposition``)
    proves a mesh's schedule.  ``schedule`` overrides the derived
    ``kernels.common.RunSchedule``, the hook mutation tests seed
    schedule-level bugs through.  A wrap-degenerate layout has no ring
    schedule (the run re-pads every superstep, which RP108 warns of):
    nothing to prove.
    """
    # local: the module is looked up at call time, so a patched
    # wrap_copies/ping_pong_aliases reaches the schedule
    from repro_torch.kernels import common

    if schedule is None:
        schedule = common.ring_schedule(program, plan, tuple(grid_shape),
                                        int(steps), variant=variant,
                                        decomp=decomp)
    if schedule.fallback or not schedule.supersteps:
        return []

    out: List[Diagnostic] = []
    for ss in schedule.supersteps:
        if ss.write_buffer == ss.read_buffer:
            out.append(error(
                "RP404",
                f"superstep {ss.index}: the aliases {dict(ss.aliases)} "
                f"route the tile output into buffer {ss.read_buffer} — the "
                f"buffer the halo'd windows read from — so tiles written "
                f"early are read back, already overwritten, by later "
                f"windows",
                hint="write the other buffer of the ping-pong pair "
                     "(ping_pong_aliases: the tiles to the destination)"))
    for d in range(program.ndim):
        out.extend(_verify_axis(schedule, program, plan, d))
    return out


def check_dataflow(program, plan: BlockPlan, grid_shape, *,
                   steps: int, variant: Optional[str] = None,
                   decomp=None, schedule=None) -> List[Diagnostic]:
    """:func:`verify_dataflow`, raising ``DiagnosticError`` on errors;
    counted as ``lint.dataflow.*``."""
    return raise_on_error(
        verify_dataflow(program, plan, grid_shape, steps=steps,
                        variant=variant, decomp=decomp, schedule=schedule),
        source="dataflow")


def _apply_copy(vec: np.ndarray, copy) -> None:
    """One ring copy's timestamp transfer along this axis."""
    s0, s1 = copy.src
    d0, d1 = copy.dst
    w = min(s1 - s0, d1 - d0)
    if w <= 0:
        return
    P = vec.shape[0]
    # clip to the buffer, so a seeded out-of-range copy is a partial
    # (and so detectably stale) refresh instead of an exception
    if s0 < 0 or d0 < 0 or s0 + w > P or d0 + w > P:
        lo = max(0, -min(s0, d0))
        w = min(w, P - max(s0, d0)) - lo
        s0, d0 = s0 + lo, d0 + lo
        if w <= 0:
            return
    vec[d0:d0 + w] = vec[s0:s0 + w]


def _write_diagnostics(ss, d: int, R: int, nblocks: int):
    """RP402/RP403 of superstep ``ss`` on axis ``d``, and the interior
    cells its ``nblocks`` tiles ``[i*stride, i*stride + tile)`` write
    (None: all ``R`` of them, once each)."""
    stride, tile = ss.write_stride[d], ss.write_tile[d]
    if stride == tile and nblocks * tile == R:
        return [], None        # an exact tiling: every schedule not seeded
    ws = np.arange(nblocks, dtype=np.int64) * stride
    we = ws + tile
    lo, hi = np.clip(ws, 0, R), np.clip(we, 0, R)
    keep = lo < hi
    diff = np.zeros(R + 1, dtype=np.int64)
    np.add.at(diff, lo[keep], 1)
    np.add.at(diff, hi[keep], -1)
    counts = np.cumsum(diff[:R])
    out = []
    if nblocks and ((ws < 0).any() or (we > R).any()):
        out.append(error(
            "RP403",
            f"superstep {ss.index}, axis {d}: an output tile writes "
            f"outside the rounded interior [0, {R})",
            hint="tiles must stay inside the destination interior"))
    holes = counts == 0
    if holes.any():
        out.append(error(
            "RP402",
            f"superstep {ss.index}, axis {d}: "
            f"{int(holes.sum())} interior cell(s) never written, "
            f"first at interior offset {int(holes.argmax())}",
            hint="write tiles must tile the rounded interior exactly"))
    overlaps = counts > 1
    if overlaps.any():
        out.append(error(
            "RP403",
            f"superstep {ss.index}, axis {d}: "
            f"{int(overlaps.sum())} interior cell(s) written more "
            f"than once, first at interior offset "
            f"{int(overlaps.argmax())}",
            hint="output tiles never overlap within a superstep"))
    return out, counts > 0


def _verify_axis(sched, prog, plan: BlockPlan, d: int) -> List[Diagnostic]:
    layout = sched.layout
    H = layout.halo
    P = layout.padded_shape[d]
    n = layout.local_shape[d]
    R = layout.rounded[d]
    b = plan.block_shape[d]
    nblocks = R // b
    r = prog.halo_radius
    wrap_axis = d in layout.wrap_axes
    sharded = d in sched.sharded_axes
    out: List[Diagnostic] = []

    # state[buf][cell]: the time the cell's value belongs to, or STALE.
    # Buffer 0 starts with the true interior at time 0; both rings, the
    # round-up slack and all of buffer 1 start uninitialised.
    state = np.full((2, P), STALE, dtype=np.int64)
    state[0, H:H + n] = 0
    tau = 0

    for ss in sched.supersteps:
        rb = ss.read_buffer
        # a mis-aliased superstep (RP404, reported above) is modelled as
        # writing the other buffer, so the later ones stay analysable
        wb = 1 - rb if ss.write_buffer == rb else ss.write_buffer
        ring_here = [c for c in ss.ring if c.axis == d]
        missing_wrap = wrap_axis and not any(
            c.kind == "wrap" for c in ring_here)
        late_ring = bool(ss.ring_deferred)
        if not late_ring:
            for c in ring_here:
                _apply_copy(state[rb], c)

        if ss.halo < ss.steps * r:
            out.append(error(
                "RP401",
                f"superstep {ss.index}, axis {d}: halo depth {ss.halo} "
                f"cannot feed {ss.steps} fused steps of radius {r} — "
                f"inner step {ss.halo // r + 1} over-reads past the "
                f"shrinking valid region",
                hint="a superstep advancing s steps needs halo "
                     "s * halo_radius"))

        # window reads: block i reads [i*b + off, i*b + off + w); their
        # union is one interval (the windows overlap)
        off = ss.window_offset
        w = ss.window_shape[d]
        lo = off
        hi = (nblocks - 1) * b + off + w
        if lo < 0 or hi > P:
            out.append(error(
                "RP401",
                f"superstep {ss.index}, axis {d}: block windows span "
                f"[{lo}, {hi}) outside the padded buffer [0, {P})",
                hint="window offset must be layout.halo - plan.halo and "
                     "the window block + 2*halo wide"))
        else:
            a, e = lo, hi
            if ss.fixup and not sharded:
                # boundary_fixup rebuilds every out-of-grid position from
                # in-grid cells at t=0: only in-grid cells must be live.
                # A sharded axis has no such exemption: an inner shard's
                # ring is other shards' interior, which the exchange brings
                a, e = max(lo, H), min(hi, H + n)
            stale = state[rb, a:max(a, e)] != tau
            if stale.any():
                cell = a + int(stale.argmax())
                code = "RP405" if (wrap_axis and
                                   (missing_wrap or late_ring)) else "RP401"
                why = ("no wrap refresh rewrites the periodic ring before "
                       "the windows load" if code == "RP405" else
                       "no copy into the carry, prior write, ring copy or "
                       "boundary_fixup initialised the cell at this time")
                out.append(error(
                    code,
                    f"superstep {ss.index}, axis {d}: window reads stale "
                    f"cell at padded offset {cell} (ring-relative "
                    f"{cell - H}) — {why}",
                    hint="refresh the ring to the superstep halo before "
                         "the first window load"))

        found, written = _write_diagnostics(ss, d, R, nblocks)
        out += found
        if late_ring:
            for c in ring_here:
                _apply_copy(state[rb], c)
        if written is None:
            state[wb, H:H + R] = tau + ss.steps
        else:
            state[wb, H:H + R][written] = tau + ss.steps
        tau += ss.steps

    return out
