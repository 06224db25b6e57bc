"""RP4xx dynamic half: the NaN canary — counterpart of
``repro/lint/sanitize.py``, run by the real kernels.

Where ``lint/dataflow.py`` proves the padded ring schedule by abstract
interpretation, :func:`sanitize_run` executes it: the supersteps of the
schedule one by one, on the device the buffers lie on — the CUDA kernels
(B1, B3 or B4 for the superstep, B2 for the wrap refresh) on the card,
their plain PyTorch versions on the CPU — with every cell outside the
true interior poisoned with NaN and the destination filled with a
sentinel, both renewed between supersteps:

* a NaN in the advanced interior means some window read a ring or slack
  cell nothing wrote — **RP401**, or **RP405** when a periodic axis's low
  ring is still all NaN (no wrap refresh ran);
* a sentinel left in the interior means no output tile wrote that cell —
  **RP402**;
* a change to the source's interior means tiles reached the window
  source — **RP404**, as does a schedule that writes the buffer it reads
  (reported from the schedule, and the run stops there).

NaN is the right canary because every fused step reads its window with
fixed offsets, no wraparound and no clamping inside the window: a
poisoned cell either reaches the output through the shrinking valid
region, or is first healed by the t=0 ``boundary_fixup`` or the wrap
refresh — the initialisation set the symbolic half models.  On the card
that makes it the proof that no kernel reads a ring or slack cell before
something writes it.

The checks run on the device (``torch.isnan(...).any()``,
``torch.equal``); only the first offending index comes to the host.  No
CUDA error is caught: a kernel that fails to build or launch fails the
canary.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.blocking import BlockPlan
from repro_torch.core.program import torch_dtype
from repro_torch.lint.diagnostics import (Diagnostic, DiagnosticError,
                                          error)

#: Destination fill: exact in float32, bfloat16 and float16 (-1984 =
#: -0b11111000000, six significant bits) and out of reach of the stencil on
#: the canary grid (uniform in [0.5, 1.5), coefficient magnitudes summing
#: to 1), so a sentinel left in the interior is a cell nothing wrote.
SENTINEL = -1984.0


@dataclasses.dataclass(frozen=True)
class SanitizeReport:
    """Outcome of one canary run: its diagnostics and the run's shape.

    ``interior`` is the true interior after the supersteps the canary
    executed (None for the fallback, or when an error stopped the run).
    A schedule models at most four full supersteps, so when ``full <= 4``
    the canary executes the whole run and ``interior`` is the run's
    result on :func:`canary_grid`.
    """

    diagnostics: Tuple[Diagnostic, ...]
    supersteps: int
    grid_shape: Tuple[int, ...]
    steps: int
    variant: str
    fallback: bool = False
    interior: Optional[torch.Tensor] = dataclasses.field(
        default=None, compare=False, repr=False)

    @property
    def ok(self) -> bool:
        return not any(d.is_error for d in self.diagnostics)

    def describe(self) -> str:
        head = (f"sanitize: {len(self.grid_shape)}D grid "
                f"{'x'.join(map(str, self.grid_shape))}, {self.steps} "
                f"steps, variant={self.variant}, "
                f"{self.supersteps} superstep(s) executed")
        if self.fallback:
            return head + " — wrap-degenerate re-pad fallback, no ring " \
                          "schedule to sanitize"
        if self.ok:
            return head + " — clean"
        return head + "\n" + "\n".join(d.describe() for d in self.diagnostics)

    def to_json(self) -> dict:
        return {
            "diagnostics": [d.to_json() for d in self.diagnostics],
            "supersteps": self.supersteps,
            "grid_shape": list(self.grid_shape),
            "steps": self.steps,
            "variant": self.variant,
            "fallback": self.fallback,
            "ok": self.ok,
        }


def canary_grid(grid_shape, seed: int = 0,
                dtype: str = "float32") -> np.ndarray:
    """The canary's true interior: uniform in [0.5, 1.5), drawn from
    ``seed`` with numpy as the reference draws it."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 1.5, size=tuple(grid_shape)).astype(dtype)


def _device(device) -> torch.device:
    """``None``: the current CUDA device, RP110 when no GPU is visible."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise DiagnosticError([error(
            "RP110",
            "sanitize_run() runs the CUDA kernels by default and no CUDA "
            "device is visible",
            hint="run on a GPU host, or pass device='cpu' for the plain "
                 "PyTorch versions of the kernels")])
    return torch.device("cuda", torch.cuda.current_device())


def _poison_outside(buf: torch.Tensor, H: int,
                    local: Tuple[int, ...]) -> None:
    """NaN in every ring and round-up-slack cell of ``buf``, in place."""
    for d, n in enumerate(local):
        buf.narrow(d, 0, H).fill_(float("nan"))
        buf.narrow(d, H + n, buf.shape[d] - H - n).fill_(float("nan"))


def _first(mask: torch.Tensor) -> Tuple[int, ...]:
    """The index of the first True of ``mask`` (one scalar to the host)."""
    flat = int(mask.reshape(-1).to(torch.uint8).argmax())
    return tuple(int(i) for i in np.unravel_index(flat, tuple(mask.shape)))


def sanitize_run(program, plan: BlockPlan, grid_shape, *,
                 steps: int, coeffs=None, variant: Optional[str] = None,
                 seed: int = 0, schedule=None,
                 device=None) -> SanitizeReport:
    """Execute the scheduled supersteps with poisoned halos; report leaks.

    ``device`` None means the card (RP110 without one); "cpu" runs the
    plain versions.  ``coeffs`` default to ``program.default_coeffs(seed)``
    and the interior to :func:`canary_grid`.  ``schedule`` overrides the
    derived ring schedule (the mutation-test hook).  The supersteps run
    one by one, never through ``run_call``, so the schedule checked and
    the launches made are the same objects: a patched
    ``kernels.common.wrap_copies`` or ``ping_pong_aliases`` reaches both.
    """
    # local: looked up at call time, so a patched schedule helper reaches
    # the schedule and the plain refresh alike
    from repro_torch.kernels import common

    dev = _device(device)
    grid_shape = tuple(int(g) for g in grid_shape)
    steps = int(steps)
    if schedule is None:
        schedule = common.ring_schedule(program, plan, grid_shape, steps,
                                        variant=variant)
    v = schedule.variant
    if schedule.fallback or not schedule.supersteps:
        return SanitizeReport(diagnostics=(), supersteps=0,
                              grid_shape=grid_shape, steps=steps, variant=v,
                              fallback=schedule.fallback)

    cf = (program.default_coeffs(seed) if coeffs is None else coeffs).to(dev)
    layout = schedule.layout
    H = layout.halo
    local = layout.local_shape
    inner = tuple(slice(H, H + n) for n in local)

    # the carry in the program's dtype: the canary grid rounded to it
    dtype = torch_dtype(program.dtype)
    src = torch.full(layout.padded_shape, float("nan"), dtype=dtype,
                     device=dev)
    src[inner] = torch.from_numpy(canary_grid(local, seed)).to(dev, dtype)
    dst = torch.full_like(src, SENTINEL)

    diags: List[Diagnostic] = []
    executed = 0
    for ss in schedule.supersteps:
        if ss.write_buffer == ss.read_buffer:
            diags.append(error(
                "RP404",
                f"superstep {ss.index}: the aliases {dict(ss.aliases)} "
                f"route the interior tile writes into the window-source "
                f"buffer; later windows would read cells the superstep "
                f"already overwrote (reported from the schedule: the run "
                f"stops here)",
                hint="write the other buffer of the ping-pong pair, never "
                     "the window source"))
            break
        step_plan = plan if ss.variant == "temporal" else \
            dataclasses.replace(plan, par_time=ss.steps)
        before = src[inner].clone()
        if ss.ring:
            common.refresh_wrap_halo(src, layout)
        common.padded_superstep(src, dst, cf.center, cf.taps,
                                program=program, plan=step_plan,
                                layout=layout, variant=ss.variant)
        executed += 1

        out = dst[inner]
        nan_mask = torch.isnan(out)
        if bool(nan_mask.any()):
            at = _first(nan_mask)
            # the axis whose boundary the first leak lies nearest
            axis = int(np.argmin([min(at[d], local[d] - 1 - at[d])
                                  for d in range(program.ndim)]))
            ring_dead = any(bool(torch.isnan(src.narrow(d, 0, H)).all())
                            for d in layout.wrap_axes)
            code = "RP405" if ring_dead else "RP401"
            why = ("the periodic low ring is still all NaN after the "
                   "superstep — no wrap refresh ran" if code == "RP405"
                   else "a window read a poisoned ring or slack cell "
                        "nothing wrote")
            diags.append(error(
                code,
                f"superstep {ss.index}: NaN canary reached the advanced "
                f"interior at offset {at} ({int(nan_mask.sum())} cell(s), "
                f"nearest boundary on axis {axis}) — {why}",
                hint="run python -m repro_torch.lint dataflow for the "
                     "symbolic footprint of the superstep"))
        del nan_mask
        hole = out == SENTINEL
        if bool(hole.any()):
            diags.append(error(
                "RP402",
                f"superstep {ss.index}: {int(hole.sum())} interior "
                f"cell(s) never written (destination sentinel survives), "
                f"first at offset {_first(hole)}",
                hint="output tiles must cover the rounded interior "
                     "exactly once"))
        del hole
        if not torch.equal(src[inner], before):
            diags.append(error(
                "RP404",
                f"superstep {ss.index}: the source buffer's interior "
                f"changed during the superstep — tile writes reached the "
                f"window source",
                hint="the ring refresh touches only ring cells; tiles "
                     "belong to the destination buffer"))
        del before
        if diags:
            break
        # ping-pong and re-poison: the advanced buffer, NaN outside its
        # interior, is the next source; the old source a fresh sentinel
        # destination
        src, dst = dst, src
        _poison_outside(src, H, local)
        dst.fill_(SENTINEL)

    return SanitizeReport(diagnostics=tuple(diags), supersteps=executed,
                          grid_shape=grid_shape, steps=steps, variant=v,
                          fallback=False,
                          interior=None if diags else src[inner].clone())
