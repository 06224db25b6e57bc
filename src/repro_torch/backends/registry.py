"""Versioned stencil-backend registry behind one ``lower()`` entry point —
counterpart of ``repro/backends/registry.py``.

The program says *what* to compute; a backend decides *how*.  Built-in
backends (registered by importing ``repro_torch.backends``):

* ``cuda``, ``cuda-pipelined``, ``cuda-temporal`` — the hand-written
  superstep kernels, one name per kernel variant (``cuda_backend.py``);
* ``torch-reference`` — the naive PyTorch oracle (``torch_ref.py``).

Whether a kernel or its plain PyTorch version runs is decided by the
grid's device, as in every kernel wrapper: a CUDA tensor launches the
kernel, a CPU tensor takes the plain version.

Usage::

    lowered = lower(program, plan, backend="cuda-pipelined")
    out = lowered.run(grid, steps=12)
    lowered = lower(program, grid_shape=(4096, 4096))   # the planner's plan
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from repro_torch.analysis.hw import H100_SXM
from repro_torch.core.blocking import BlockPlan, normalize_variant, plan_blocking
from repro_torch.core.program import (ProgramCoeffs, StencilProgram,
                                      as_program, normalize_coeffs)
from repro_torch.lint.diagnostics import DiagnosticError, error


@dataclasses.dataclass(frozen=True)
class BackendTraits:
    """Capability flags a backend declares at registration time.

    ``variant`` is the kernel variant its lowering runs ("plain" |
    "pipelined" | "temporal").  ``local_kernel=True`` means its superstep
    can serve as the local kernel of a mesh run (``core/distributed``):
    the oracle pads its own boundaries and cannot, and neither can the temporal
    variant, whose chunk would need ``TEMPORAL_CHUNK`` supersteps of halo
    exchanged at once.  ``fused_run=True`` declares that ``run`` is the
    fused run executor (``kernels/ops._stencil_run`` with ``variant``), so
    the front door dispatches to it directly; a backend with its own run
    leaves it False and the front door runs it through ``lower``.
    """

    local_kernel: bool = False
    fused_run: bool = False
    variant: str = "plain"


class LoweredStencil:
    """A program bound to a backend: ``superstep``/``run`` execute it on
    the grid's device.  ``backend_name``/``backend_version`` are stamped by
    :func:`lower`."""

    def __init__(self, program: StencilProgram, plan: Optional[BlockPlan],
                 coeffs: ProgramCoeffs, superstep_fn, run_fn,
                 backend_name: Optional[str] = None,
                 backend_version: Optional[int] = None):
        self.program = program
        self.plan = plan
        self.coeffs = coeffs
        self._superstep_fn = superstep_fn
        self._run_fn = run_fn
        self.backend_name = backend_name
        self.backend_version = backend_version

    def superstep(self, grid, coeffs: Optional[ProgramCoeffs] = None):
        """Advance ``plan.par_time`` steps (1 for plan-less backends)."""
        c = self.coeffs if coeffs is None else coeffs
        return self._superstep_fn(grid, c.to(grid.device))

    def run(self, grid, steps: int,
            coeffs: Optional[ProgramCoeffs] = None):
        """Advance an arbitrary number of time steps."""
        c = self.coeffs if coeffs is None else coeffs
        return self._run_fn(grid, c.to(grid.device), steps)


#: factory(program, plan, coeffs) -> LoweredStencil
BackendFactory = Callable[[StencilProgram, Optional[BlockPlan],
                           ProgramCoeffs], LoweredStencil]

_REGISTRY: Dict[str, Dict[int, BackendFactory]] = {}
_TRAITS: Dict[tuple, BackendTraits] = {}     # (name, version) -> traits


def register_backend(name: str, version: int = 1,
                     traits: Optional[BackendTraits] = None):
    """Decorator registering a backend factory under (name, version).
    Omitted traits default to the most conservative flags; a new version
    re-declares its capabilities, they are not inherited."""

    def deco(factory: BackendFactory) -> BackendFactory:
        _REGISTRY.setdefault(name, {})
        if version in _REGISTRY[name]:
            raise ValueError(f"backend {name!r} v{version} already registered")
        _REGISTRY[name][version] = factory
        if traits is not None:
            _TRAITS[(name, version)] = traits
        return factory

    return deco


def backend_traits(name: str,
                   version: Optional[int] = None) -> BackendTraits:
    """The declared traits of a registered version (highest when
    unspecified)."""
    _, v = get_backend(name, version)
    return _TRAITS.get((name, v), BackendTraits())


def available_backends() -> Dict[str, tuple]:
    """name -> sorted tuple of registered versions."""
    return {n: tuple(sorted(v)) for n, v in _REGISTRY.items()}


def get_backend(name: str,
                version: Optional[int] = None) -> "tuple[BackendFactory, int]":
    """Resolve (factory, version); highest version wins when unspecified."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown backend {name!r}; available: {sorted(_REGISTRY)}")
    versions = _REGISTRY[name]
    v = max(versions) if version is None else version
    if v not in versions:
        raise KeyError(f"backend {name!r} has no version {v}; "
                       f"available: {sorted(versions)}")
    return versions[v], v


def default_backend_name() -> str:
    """The hand-written kernels; the grid's device picks kernel or plain
    version."""
    return "cuda"


#: Known kernel-variant name suffixes.
_VARIANT_SUFFIXES = ("-pipelined", "-temporal")


def _base_name(name: str) -> str:
    for suf in _VARIANT_SUFFIXES:
        if name.endswith(suf):
            return name[:-len(suf)]
    return name


def variant_of(name: str, variant: str) -> Optional[str]:
    """The registered ``variant`` sibling of ``name``, or None:
    ``variant_of("cuda", "temporal")`` is ``"cuda-temporal"``, a variant
    name maps to its siblings, "plain" maps back to the base name, and a
    backend without the lowering (``torch-reference``) maps to None."""
    base = _base_name(name)
    cand = base if variant == "plain" else f"{base}-{variant}"
    return cand if cand in _REGISTRY else None


def pipelined_variant(name: str) -> Optional[str]:
    """The registered double-buffered sibling of ``name``, or None: the
    deprecated spelling of ``variant_of(name, "pipelined")`` (``cuda`` ->
    ``cuda-pipelined``, a pipelined name maps to itself, and
    ``torch-reference``, which has no pipelined lowering, to None)."""
    return variant_of(name, "pipelined")


def resolve_backend(name: Optional[str] = None,
                    variant: Optional[str] = None,
                    pipelined: bool = False
                    ) -> "tuple[str, int, BackendTraits]":
    """One resolution rule for every executor: ``(name, version, traits)``.

    ``name=None`` picks :func:`default_backend_name`.  ``variant`` resolves
    the named sibling ("plain" strips a variant suffix); ``None`` leaves
    ``name`` as it is and defers to the deprecated ``pipelined`` bool,
    which resolves the ``-pipelined`` sibling when True.  A missing
    lowering raises: running another kernel than the one asked for is
    never acceptable.
    """
    name = name or default_backend_name()
    if variant is None and pipelined:
        variant = "pipelined"
    if variant is not None:
        variant = normalize_variant(variant)
        sibling = variant_of(name, variant)
        if sibling is None and variant != "plain":
            raise ValueError(
                f"backend {name!r} has no {variant} lowering; "
                f"variant={variant!r} would silently run another kernel — "
                f"pick a cuda backend (its -pipelined/-temporal siblings "
                f"are registered) or drop the variant request")
        name = sibling or name
    _, version = get_backend(name)
    return name, version, backend_traits(name, version)


def lower(program: StencilProgram, plan: Optional[BlockPlan] = None, *,
          coeffs: Optional[ProgramCoeffs] = None,
          backend: Optional[str] = None,
          version: Optional[int] = None,
          grid_shape: Optional[Tuple[int, ...]] = None) -> LoweredStencil:
    """Lower a program through a registered backend (default
    :func:`default_backend_name`); ``coeffs`` default to
    ``program.default_coeffs()``.  ``plan=None`` takes the H100 planner's
    pick for the fused-run backends (``core/blocking.plan_blocking`` for
    the backend's variant on ``H100_SXM``), round-up
    waste charged for ``grid_shape`` when given; the oracle takes no plan.
    Anything but a ``BlockPlan`` or None is RP112.  Takes the legacy
    (``StencilSpec``, ``StencilCoeffs``) pair too."""
    program = as_program(program)
    c = program.default_coeffs() if coeffs is None \
        else normalize_coeffs(program, coeffs)
    name = backend or default_backend_name()
    factory, v = get_backend(name, version)
    traits = backend_traits(name, v)
    if plan is None and traits.fused_run:
        plan = plan_blocking(program, H100_SXM, grid_shape=grid_shape,
                             variant=traits.variant).plan
    elif plan is not None and not isinstance(plan, BlockPlan):
        raise DiagnosticError([error(
            "RP112", f"plan must be a BlockPlan or None (got {plan!r})",
            hint="drop plan= for the planner's pick, or pass "
                 "plan=BlockPlan(spec=program, block_shape=..., "
                 "par_time=...)")])
    lowered = factory(program, plan, c)
    lowered.backend_name = name
    lowered.backend_version = v
    return lowered
