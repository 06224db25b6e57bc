"""Temporal-blocking engine — DEPRECATED shim over the front door, in
PyTorch (counterpart of ``repro/core/temporal.py``).

``StencilEngine`` predates the one front door; build executables through
``repro_torch.stencil(program, coeffs=...).compile(grid_shape, steps=...,
plan=..., backend=..., variant=...)`` instead.  The shim's ``run`` builds
the same :class:`~repro_torch.executor.CompiledStencil` the front door
would and dispatches through the same fused run executor, so its result
equals the front door's; ``superstep``/``lowered``/``estimate`` keep the
reference's behaviour.

Where this differs from the reference:

* ``chip`` (a :class:`~repro_torch.analysis.hw.GpuChip`, the H100 by
  default) takes the place of ``hw`` (a TPU chip): the H100 planner
  makes the plans and prices them, and ``compile`` checks RP105 against
  it.
* ``device`` (None: CUDA, RP110 without a GPU; ``"cpu"`` runs the plain
  versions) takes the place of ``interpret``, as in ``compile``.
* ``run`` passes the engine's variant to ``compile`` as ``variant=``, so
  the engine warns once, at construction; the reference passes its
  ``pipelined`` bool on, which adds ``compile``'s own deprecation warning
  at each memo miss.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import torch

from repro_torch.analysis.hw import GpuChip, H100_SXM
from repro_torch.core.blocking import (BlockPlan, PlanEstimate, estimate,
                                       plan_blocking)
from repro_torch.core.program import as_program, normalize_coeffs
from repro_torch.kernels import common, ops
from repro_torch.lint.diagnostics import DiagnosticError, error


@dataclasses.dataclass
class StencilEngine:
    """Planning + execution bundle (deprecated; see the module docstring).

    ``spec`` may be a legacy ``StencilSpec`` or a ``StencilProgram``;
    ``coeffs`` the matching ``StencilCoeffs``/``ProgramCoeffs``.
    ``backend`` optionally pins a registry backend name; ``pipelined=True``
    selects the pipelined kernel (resolving the ``-pipelined`` sibling
    where a backend is pinned).
    """

    spec: object
    coeffs: object
    plan: BlockPlan
    chip: GpuChip = H100_SXM
    device: object = None
    backend: Optional[str] = None
    pipelined: bool = False

    def __post_init__(self):
        warnings.warn(
            "StencilEngine is deprecated; use repro_torch.stencil(program, "
            "coeffs=...).compile(grid_shape, steps=..., plan=..., "
            "backend=..., variant=...).run(grid)",
            DeprecationWarning, stacklevel=3)
        # Single-slot (key, CompiledStencil) memo: run() resolves the
        # executable once per (shape, engine config), and a config change
        # replaces the slot, so an engine whose coefficients vary every
        # call does not grow
        self._memo = None

    @classmethod
    def create(cls, spec, grid_shape: Tuple[int, ...],
               coeffs=None, chip: GpuChip = H100_SXM,
               plan: Optional[BlockPlan] = None,
               max_par_time: int = 64,
               device=None,
               backend: Optional[str] = None,
               pipelined: bool = False) -> "StencilEngine":
        """An engine whose plan (unless given) is the H100 planner's for
        ``grid_shape``, and whose coefficients default to the spec's."""
        if coeffs is None:
            coeffs = spec.default_coeffs()
        if plan is None:
            plan = plan_blocking(spec, chip, grid_shape,
                                 max_par_time=max_par_time).plan
        return cls(spec=spec, coeffs=coeffs, plan=plan, chip=chip,
                   device=device, backend=backend,
                   pipelined=pipelined)  # legacy-ok

    @property
    def variant(self) -> str:
        return "pipelined" if self.pipelined else "plain"

    def lowered(self):
        """Lower through the backend registry (pins ``backend`` if set)."""
        # local: the registry imports the kernels, which import core
        from repro_torch.backends import lower, resolve_backend
        name = self.backend
        if self.pipelined and name is not None:
            name, _, _ = resolve_backend(name, variant="pipelined")
        return lower(as_program(self.spec), self.plan, coeffs=self.coeffs,
                     backend=name)

    def superstep(self, grid: torch.Tensor) -> torch.Tensor:
        """One superstep of ``plan.par_time`` steps on the engine's device
        (B5, or B6 with ``pipelined``, on the card)."""
        # local: the executor imports this package
        from repro_torch.executor import _resolve_device
        dev = _resolve_device(self.device)
        if grid.device != dev:
            raise DiagnosticError([error(
                "RP110",
                f"grid lies on {grid.device} but this engine runs on {dev}",
                hint=f"move the grid with .to({str(dev)!r}) or build the "
                     f"engine with device={grid.device.type!r}")])
        if self.backend is not None:
            return self.lowered().superstep(grid)
        return ops.stencil_superstep(grid, self.spec, self.coeffs, self.plan,
                                     variant=self.variant)

    def run(self, grid: torch.Tensor, steps: int) -> torch.Tensor:
        """Advance ``steps`` time steps through the front door's executor;
        ``steps == 0`` returns ``grid``."""
        if steps < 0:
            raise ValueError("steps must be >= 0")
        program = as_program(self.spec)
        nb = common.batch_dims(program, grid.ndim)
        if steps == 0:
            return grid
        # Coefficients enter the key by value (a few numbers): the fields
        # are mutable and the engine reads them on every call, so
        # rebinding or changing them in place must miss the memo.
        pc = normalize_coeffs(program, self.coeffs)
        ckey = tuple((str(t.dtype), tuple(t.detach().reshape(-1).tolist()))
                     for t in pc.as_tuple())
        key = (tuple(grid.shape[nb:]), grid.shape[0] if nb else None,
               self.plan, self.backend, self.pipelined, str(self.device),
               self.chip, program, ckey)
        if self._memo is not None and self._memo[0] == key:
            cs = self._memo[1]
        else:
            # local: the executor imports this package
            from repro_torch.executor import stencil as _stencil
            cs = _stencil(program, coeffs=pc).compile(
                tuple(grid.shape[nb:]), steps=steps,
                batch=grid.shape[0] if nb else None,
                plan=self.plan, backend=self.backend,
                variant=self.variant, device=self.device, chip=self.chip)
            self._memo = (key, cs)
        return cs.run(grid, steps)

    def estimate(self) -> PlanEstimate:
        """The H100 model of one superstep of the plan under the engine's
        variant."""
        return estimate(self.plan, self.chip, self.variant)
