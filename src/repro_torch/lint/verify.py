"""The plan/program verifier with the card's rules — counterpart of
``repro/lint/verify.py``.

:func:`verify` re-checks a (program, plan, grid) configuration statically
and reports RP1xx diagnostics with fix hints; :func:`check` raises on the
errors.  The front door (``executor.py``) runs :func:`check` after
planning and before anything is built or launched.  The checks and their
order are the reference's, less RP114 (the port has no ``pipelined=``);
RP107 holds a mesh's shards to the same rules as the reference
(``tuning/space.shard_violations``).  Where the TPU's rule does not
apply, the card's takes its place:

* RP105 asks whether one CTA of every superstep kernel the run launches
  (``kernels/common.run_kernels``) fits the card's opt-in shared memory
  per block at that kernel's smallest CTA tile, not whether a window fits
  VMEM;
* RP106 warns when the carry's row pitch is not a multiple of 16 bytes
  (4 cells in float32, 8 in 16 bits), which turns the kernels' 16-byte
  row copies off, not about lane/sublane alignment;
* RP113 reads the useful share of the CTA tile the card runs
  (``core/blocking.launch_work``), the quantity ``candidate_plans`` prunes
  on, not the TPU window's.

On a mesh (``decomp=``) the card's checks read one shard: its local
extent, the sharded ring schedule and its carry pitch.

All of it is integer arithmetic on the plan; nothing touches a device.
"""

from __future__ import annotations

import operator
from typing import List, Optional, Tuple, Union

from repro_torch.analysis.hw import GpuChip, H100_SXM
from repro_torch.core.blocking import (CARRY_KERNELS, MIN_USEFUL_FRACTION,
                                       TEMPORAL_CHUNK, VEC_BYTES, BlockPlan,
                                       launch_work, normalize_variant)
from repro_torch.core.program import DTYPES
from repro_torch.kernels.common import ring_schedule, run_kernels
from repro_torch.kernels.cuda import smallest_tile
from repro_torch.lint.diagnostics import (Diagnostic, error, raise_on_error,
                                          warning)

#: shards per grid axis, or a ``tuning.space.MeshDecomposition``
Decomp = Union[None, Tuple[int, ...], "MeshDecomposition"]  # noqa: F821

#: dtypes the port's kernels (and their plain versions) take: the
#: reference's set, in its order.
SUPPORTED_DTYPES = tuple(DTYPES)

#: Where each body turns its 16-byte row copies off for a row pitch that is
#: not a multiple of 16 bytes: the register queues load every row with
#: plain loads (``g.bulk``), the streamed kernel copies 16 bytes only from
#: a 16-byte aligned address, so at a pitch of 8 bytes (mod 16) half its
#: rows, at an odd float32 pitch three in four, load cell by cell.
_PITCH_RULES = {
    "queue": "csrc/queued_superstep.cu:925 turns the cp.async.bulk row "
             "copies off",
    "streamed": "csrc/streamed_superstep.cu:353 takes 16-byte cp.async "
                "only from 16-byte aligned rows",
}

#: How each body holds its data (``BlockPlan.body``), for the message.
_HOLDS = {
    "queue": "planes of its column tile",
    "streamed": "a ring of planes per fused step",
}


def dtype_diagnostics(program) -> List[Diagnostic]:
    """RP109 when the program's dtype is outside :data:`SUPPORTED_DTYPES`
    (no arithmetic on the dtype: the front door asks this before it
    plans)."""
    if program.dtype in SUPPORTED_DTYPES:
        return []
    return [error(
        "RP109",
        f"program dtype {program.dtype!r} is outside the kernels' "
        f"supported set {SUPPORTED_DTYPES}",
        hint="use float32 (the paper's dtype), bfloat16 or float16; the "
             "port has no float64 kernels")]


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


def verify(program, plan: BlockPlan, grid_shape,
           chip: Optional[GpuChip] = H100_SXM, *,
           decomp: Decomp = None,
           variant: Optional[str] = None,
           batch: Optional[int] = None,
           steps: Optional[int] = None) -> List[Diagnostic]:
    """Statically check a (program, plan, grid) configuration.

    ``variant`` names the kernels the plan will run under ("plain",
    "pipelined", "temporal"); ``steps`` (when given) the run, whose
    kernels (``run_kernels``, a remainder's included) the card's checks
    read; without it, a full superstep and the longest remainder.
    ``chip`` is the card RP105 holds the kernels to; ``None`` skips RP105
    (the plain versions on the CPU have no per-block limit) and prices
    RP113's tiles on ``H100_SXM``.  Returns every finding, errors and
    warnings; an empty list means the configuration is as legal as a
    planner candidate.  In order:

    RP109  program dtype in the kernels' supported set (float32,
           bfloat16, float16); with it, the checks stop before RP105:
           every later one sizes cells by the dtype
    RP101  grid matches the program's spatial rank, positive extents
    RP102  steps >= 1 (when given)
    RP103  batch None or >= 1 (when given)
    RP111  plan block rank == program rank
    RP104  eq. 2: every block extent >= 1
    RP105  every kernel of the run fits a CTA tile in ``chip``'s shared
           memory per block
    RP106  (warning) the carry's row pitch is a multiple of 16 bytes
    RP113  (warning) each kernel's CTA tile keeps more than
           ``MIN_USEFUL_FRACTION`` of the cells it computes
    RP107  per-shard bounds of ``decomp``: divisibility, block tiling,
           halo within the shard
    RP108  (warning) a wrap-degenerate periodic layout re-pads instead
    """
    prog = program
    out: List[Diagnostic] = dtype_diagnostics(prog)

    grid: Optional[Tuple[int, ...]] = None
    try:
        grid = tuple(operator.index(s) for s in grid_shape)
    except TypeError:
        out.append(error(
            "RP101",
            f"grid_shape must be a sequence of ints (got {grid_shape!r})",
            hint="pass the spatial extents, e.g. (4096, 4096)"))
    if grid is not None and (len(grid) != prog.ndim
                             or any(s < 1 for s in grid)):
        out.append(error(
            "RP101",
            f"grid_shape {grid} does not describe a {prog.ndim}-D grid "
            f"with positive extents for this {prog.ndim}-D program",
            hint=f"give {prog.ndim} positive extents; a leading batch axis "
                 f"is declared separately (batch=B), never in grid_shape"))
        grid = None

    run_steps = None
    if steps is not None:
        run_steps = _as_int(steps)
        if run_steps is None or run_steps < 1:
            run_steps = None
            out.append(error(
                "RP102", f"steps must be an int >= 1 (got {steps!r})",
                hint="run at least one time step; fractional or zero step "
                     "counts have no executable"))
    if batch is not None:
        b = _as_int(batch)
        if b is None or b < 1:
            out.append(error(
                "RP103",
                f"batch must be None (unbatched) or an int >= 1 "
                f"(got {batch!r})",
                hint="batch is the extent of the leading (B, *grid) axis "
                     "of independent grids"))

    if len(plan.block_shape) != prog.ndim:
        out.append(error(
            "RP111",
            f"plan block_shape {plan.block_shape} is "
            f"{len(plan.block_shape)}-D but the program is {prog.ndim}-D",
            hint="give one output-tile extent per grid axis"))
        return out

    out += _block_extents(prog, plan)
    if any(d.code in ("RP104", "RP109") for d in out):
        return out

    v = normalize_variant(variant)
    shards, found = _shards(prog, plan, grid, decomp)
    # one shard's extent: the kernels a mesh launches run on it
    local = grid if shards is None or found else tuple(
        g // s for g, s in zip(grid, shards))
    if chip is not None:
        out += smem_diagnostics(plan, v, chip, grid_shape=local,
                                steps=run_steps)
    out += found
    if grid is None or found:
        return out
    if run_steps is None:
        # a full superstep (or chunk) and the longest remainder
        run_steps = 2 * plan.par_time * (
            TEMPORAL_CHUNK if v == "temporal" else 1) - 1
    sched = ring_schedule(prog, plan, grid, run_steps, variant=v,
                          decomp=shards)
    kernels = run_kernels(prog, plan, local, run_steps, v)
    out += _pitch_warnings(plan, sched, kernels)
    out += _overlap_warnings(plan, v, kernels, chip or H100_SXM)
    if sched.fallback:
        out.append(warning(
            "RP108",
            f"periodic wrap is degenerate for local extents {local} under "
            f"block={plan.block_shape} par_time={plan.par_time}: some wrap "
            f"axis is shallower than the halo ring ({sched.layout.halo}) "
            f"or the round-up slack",
            hint="the run re-pads every superstep through "
                 + ("B6 (pipelined_superstep)" if v == "pipelined"
                    else "B5 (superstep)")
                 + " instead of refreshing the ring in place; grow the "
                   "axis, shrink par_time, or pick a block that divides "
                   "the axis"))
    return out


def check(program, plan: BlockPlan, grid_shape,
          chip: Optional[GpuChip] = H100_SXM, *,
          decomp: Decomp = None,
          variant: Optional[str] = None,
          batch: Optional[int] = None,
          steps: Optional[int] = None) -> List[Diagnostic]:
    """:func:`verify`, then raise ``DiagnosticError`` on any error;
    returns the warnings.  Counted through the flight recorder as
    ``lint.verify.*`` and ``lint.code.*``."""
    return raise_on_error(verify(program, plan, grid_shape, chip,
                                 decomp=decomp, variant=variant, batch=batch,
                                 steps=steps),
                          source="verify")


def _shards(prog, plan: BlockPlan, grid: Optional[Tuple[int, ...]],
            decomp: Decomp):
    """``(shards per axis or None, RP107 findings)`` of ``decomp``, with
    the reference's messages."""
    # local: the tuner's space imports the backends, which import this
    from repro_torch.tuning.space import MeshDecomposition, shard_violations
    if decomp is None:
        return None, []
    shards = tuple(int(s) for s in getattr(decomp, "axis_shards", decomp))
    if len(shards) != prog.ndim or any(s < 1 for s in shards):
        return None, [error(
            "RP107",
            f"decomposition {shards} does not give one positive shard "
            f"count per axis of a {prog.ndim}-D grid",
            hint="one positive shards-per-axis entry per grid axis")]
    if grid is None:
        return shards, []
    return shards, [error(
        "RP107",
        f"decomposition {shards} cannot take block={plan.block_shape} "
        f"par_time={plan.par_time} on grid {grid}: {reason}",
        hint="every sharded axis must divide the grid, the local extent "
             "must tile by csize, and the halo must stay shallower than "
             "the shard; devices=<count> or plan='auto' searches blocking "
             "and split together")
        for reason in shard_violations(plan, MeshDecomposition(shards),
                                       grid)]


def _block_extents(prog, plan: BlockPlan) -> List[Diagnostic]:
    """RP104, with the reference's message: a block extent below 1 is a
    window whose ``par_time`` halo leaves no output."""
    r = prog.halo_radius
    bsize = plan.padded_shape
    out = []
    for d, c in enumerate(plan.block_shape):
        if c < 1:
            max_pt = max((bsize[d] - 1) // (2 * r), 1)
            out.append(error(
                "RP104",
                f"par_time={plan.par_time} shrinks csize to {c} on axis "
                f"{d} (bsize={bsize[d]}, halo={plan.par_time}x{r} per "
                f"side)",
                hint=f"give axis {d} a block extent >= 1, or keep its "
                     f"window {bsize[d]} and cut par_time to <= {max_pt} "
                     f"(eq. 2: csize = bsize - 2*par_time*halo_radius "
                     f"must stay positive)"))
    return out


def _pitch_warnings(plan: BlockPlan, sched, kernels) -> List[Diagnostic]:
    """RP106: the kernels of the run whose row pitch is not a multiple of
    16 bytes (4 cells in float32, 8 in 16 bits).  The carry kernels read
    the padded pair, of pitch ``rounded + 2H``; the pre-padded ones (a
    wrap-degenerate run's) a grid padded by their own halo.  With the
    rounded minor extent a multiple of 4 (8), that is an odd ``H`` (an
    ``H`` that is not a multiple of 4).  ``tools/planner_calibration.py``
    timed B1 on the register queues 2.4-2.7x slower at such points than
    at their neighbours in float32 (PERF.md, NVIDIA H100 80GB HBM3,
    700.00 W)."""
    rounded = sched.layout.rounded[-1]
    size = plan.itemsize
    slow = []
    for kernel, kplan in kernels:
        carry = kernel in CARRY_KERNELS.values()
        H = sched.layout.halo if carry else kplan.halo
        pitch = rounded + 2 * H
        if pitch * size % VEC_BYTES:
            body = kplan.body(kernel)
            slow.append(f"{kernel} ({kplan.kernel_steps(kernel)} fused "
                        f"steps, {body} body: {_PITCH_RULES[body]}) reads "
                        f"rows of pitch {pitch} cells, {pitch * size} bytes "
                        f"(H={H})")
    if not slow:
        return []
    return [warning(
        "RP106",
        f"row pitch not a multiple of {VEC_BYTES} bytes "
        f"({VEC_BYTES // size} cells of {plan.spec.dtype}): "
        + "; ".join(slow),
        hint="pick par_time so that the pitch rounded + 2*par_time*radius "
             "is a multiple of 16 bytes (par_time*radius even in float32, "
             "a multiple of 4 in 16 bits); at an odd halo B1 on the "
             "register queues ran 2.4-2.7x slower in float32 than at its "
             "even neighbours (PERF.md, NVIDIA H100 80GB HBM3, 700.00 W)")]


def _overlap_warnings(plan: BlockPlan, variant: str, kernels,
                      chip: GpuChip) -> List[Diagnostic]:
    """RP113: the kernels whose CTA tile keeps no more than
    ``MIN_USEFUL_FRACTION`` of the cells it computes as output.  A kernel
    no tile fits is RP105's, not this check's."""
    low = []
    for kernel, kplan in kernels:
        try:
            tile, _, _, useful = launch_work(kplan, kernel, chip)
        except ValueError:
            continue
        if useful <= MIN_USEFUL_FRACTION:
            low.append(f"{kernel} ({kplan.kernel_steps(kernel)} fused "
                       f"steps) keeps {useful:.3f} at its CTA tile {tile}")
    if not low:
        return []
    return [warning(
        "RP113",
        f"useful fraction at or below the planner floor "
        f"{MIN_USEFUL_FRACTION} (overlap tax) in the {variant} run of "
        f"block={plan.block_shape} par_time={plan.par_time} on "
        f"{chip.name}: " + "; ".join(low),
        hint="cut par_time: past ~4x redundancy a deeper superstep never "
             "wins (paper Fig. 3), and the CTA tile the card runs, not "
             "the block, sets the overlap")]


def _as_int(value) -> Optional[int]:
    if isinstance(value, bool):
        return None
    try:
        return operator.index(value)
    except TypeError:
        return None
