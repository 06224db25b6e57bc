"""One front door: ``repro_torch.stencil(program).compile(...).run(grid)`` —
counterpart of ``repro/executor.py`` for the single-device run.

``compile`` validates the request with the reference's RP codes and in
its order (grid, steps, batch, placement, variant, plan), then binds it to
a device; ``run`` checks the grid and hands it to one of three executors:

    devices <= 1, cuda backend  -> the fused executor
                                   (``kernels/common.run_call`` through
                                   ``kernels/ops._stencil_run``)
    devices <= 1, the oracle    -> the backend's lowering
                                   (``torch-reference``)
    devices  > 1                -> the mesh executor
                                   (``core/distributed.DistributedStencil``:
                                   the deep-halo exchange and the sharded
                                   carry kernels)

``backend``/``variant`` resolve through the registry
(``backends.resolve_backend``): ``cuda`` (default), ``cuda-pipelined``,
``cuda-temporal``, or the ``torch-reference`` oracle.  ``plan="auto"``
(the default) asks the autotuner (``repro_torch.tuning``, model-only,
with its plan cache), ``plan="model"`` the H100 planner
(``core/blocking.plan_blocking``).  After planning, ``compile`` runs the
pre-flight checks before anything is built or launched: the RP1xx
verifier (``lint/verify.check``; RP105, a kernel the run would launch
fitting no CTA tile, on a CUDA device or when ``chip=`` is given, and
again at ``run`` for another step count) and the proof of the padded ring
schedule (``lint/dataflow.check_dataflow``), and with ``sanitize=True``
the NaN canary on the compile's device (``lint/sanitize.sanitize_run``).
Their warnings stay on ``CompiledStencil.preflight``.

With the flight recorder on (``REPRO_TORCH_OBS=1`` or
``repro_torch.obs.profile()``) ``compile`` emits a ``compile`` span and
each ``run`` a ``run`` span timed on the card (CUDA events beside the host
clock) plus one accuracy sample; off, ``run`` pays one ``obs.active()``
lookup and one flag read and stays asynchronous.  With the recorder off
and a ``torch.profiler`` recording, ``run`` is a ``run`` range in the
profiler's trace around the dispatch, which synchronises nothing.

``devices=N`` or shards per axis lays the run over a mesh of the devices
``core/distributed.visible_devices`` gives (one per card, or with
``REPRO_TORCH_FORCE_DEVICE_COUNT=N`` N of them over the visible cards or
the CPU); more than it gives is RP110, never a silent single-device run.
Entry points run on the card: ``device=None`` means CUDA and raises when
no GPU is visible; the CPU runs only when the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import math
import operator
import time
import warnings
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch import obs
from repro_torch.analysis.hw import GpuChip, H100_SXM
from repro_torch.backends import lower, resolve_backend
from repro_torch.backends.registry import LoweredStencil
from repro_torch.core.blocking import (TEMPORAL_CHUNK, BlockPlan,
                                       plan_blocking, run_seconds)
from repro_torch.core.distributed import (ENV_DEVICE_COUNT, Decomposition,
                                          DistributedStencil, make_mesh,
                                          visible_devices)
from repro_torch.core.program import (ProgramCoeffs, StencilProgram,
                                      as_program, normalize_coeffs,
                                      torch_dtype)
from repro_torch.kernels import common, cuda, ops
from repro_torch.lint.dataflow import check_dataflow
from repro_torch.lint.diagnostics import DiagnosticError, raise_on_error
from repro_torch.lint.diagnostics import error as _diag
from repro_torch.lint.sanitize import SanitizeReport, sanitize_run
from repro_torch.lint.verify import check as _preflight
from repro_torch.lint.verify import dtype_diagnostics, smem_diagnostics
from repro_torch.tuning.cache import cache_key
from repro_torch.tuning.model_rank import exchange_seconds, rank
from repro_torch.tuning.space import (Candidate, MeshDecomposition,
                                      enumerate_decompositions,
                                      enumerate_space, fits_shard)

Devices = Union[None, int, Tuple[int, ...]]


def _as_int(value) -> Optional[int]:
    """``operator.index``'d value, or None for non-integral types (bools
    excluded)."""
    if isinstance(value, bool):
        return None
    try:
        return operator.index(value)
    except TypeError:
        return None


def _normalize_variant_request(variant: Optional[str],
                               pipelined: Optional[bool]) -> Optional[str]:
    """Apply the deprecated ``pipelined=`` shim to a ``variant=`` request,
    as the reference does.

    ``pipelined`` left at ``None`` means the caller never used the legacy
    spelling, and ``variant`` passes as it is.  A bool warns and maps
    (True -> "pipelined", False -> "plain"); both spellings at once is
    RP114, never a silent precedence rule.
    """
    if pipelined is None:
        return variant
    if variant is not None:
        raise DiagnosticError([_diag(
            "RP114",
            f"conflicting kernel-variant requests: pipelined={pipelined!r} "
            f"and variant={variant!r} were both given",
            hint="pass only variant= ('plain' | 'pipelined' | 'temporal' | "
                 "'auto'); pipelined= is a deprecated alias for "
                 "variant='pipelined'")])
    warnings.warn(
        "pipelined= is deprecated; pass variant='pipelined' "
        "(or variant='plain') instead", DeprecationWarning, stacklevel=3)
    return "pipelined" if pipelined else "plain"


def _check_steps(steps, context: str = "") -> int:
    """Validate a step count: integral, >= 1 (RP102 on rejection)."""
    v = _as_int(steps)
    if v is None or v < 1:
        raise DiagnosticError([_diag(
            "RP102",
            f"steps must be an int >= 1 (got {steps!r}){context}",
            hint="run at least one time step; fractional or zero step "
                 "counts have no executable")])
    return v


def _normalize_devices(prog: StencilProgram, devices: Devices):
    """-> (shards per axis or None, total device count); RP110 for a
    malformed request."""
    if devices is None:
        return None, 1
    n = _as_int(devices)
    if n is not None:
        if n < 1:
            raise DiagnosticError([_diag(
                "RP110", f"devices must be >= 1 (got {devices})",
                hint="pass a positive device count or drop devices=")])
        return None, n
    try:
        axes = tuple(operator.index(s) for s in devices)
    except TypeError:
        raise DiagnosticError([_diag(
            "RP110",
            f"devices must be None, an int device count, or a "
            f"{prog.ndim}-tuple of shards per grid axis (got {devices!r})",
            hint="an int searches every factorization; a tuple pins "
                 "shards per axis")])
    if len(axes) != prog.ndim or any(s < 1 for s in axes):
        raise DiagnosticError([_diag(
            "RP110",
            f"devices {devices!r} must give one positive shard count per "
            f"grid axis ({prog.ndim} of them)",
            hint=f"give {prog.ndim} positive shard counts")])
    return axes, math.prod(axes)


def _mesh_devices(devices: Devices, n: int, dev: torch.device):
    """The devices a mesh of ``n`` takes beside ``dev``; RP110 naming
    ``REPRO_TORCH_FORCE_DEVICE_COUNT`` when fewer are visible."""
    try:
        avail = visible_devices(dev)
    except ValueError as e:
        raise DiagnosticError([_diag(
            "RP110", str(e),
            hint=f"set {ENV_DEVICE_COUNT} to a positive count")]) from e
    if n > len(avail):
        raise DiagnosticError([_diag(
            "RP110",
            f"compile(devices={devices!r}) needs {n} mesh devices but "
            f"{len(avail)} {'is' if len(avail) == 1 else 'are'} visible "
            f"beside {dev}; set {ENV_DEVICE_COUNT}={n} to lay {n} mesh "
            f"devices over the visible "
            f"{'CPU' if dev.type == 'cpu' else 'cards'}",
            hint=f"request at most the visible device count, or set "
                 f"{ENV_DEVICE_COUNT}={n} before compiling")])
    return avail[:n]


def _no_feasible_split(grid_shape, n_devices, plan=None):
    what = "" if plan is None else (f" for block={plan.block_shape} "
                                    f"par_time={plan.par_time}")
    return DiagnosticError([_diag(
        "RP107",
        f"no feasible decomposition of {n_devices} devices over grid "
        f"{grid_shape}{what} (every split must divide the grid, tile the "
        f"local extent by the block, and keep the halo shallower than the "
        f"shard)",
        hint="pass devices=<shards per axis> or let plan='auto' search "
             "blocking and split together")])


def _pick_decomposition(program, plan: BlockPlan, grid_shape,
                        n_devices: int, chip: GpuChip, backend: str,
                        version: int, variant: str,
                        cards: int) -> Tuple[int, ...]:
    """The best feasible split of ``n_devices`` for a fixed plan: every
    factorization that divides the grid and fits a shard
    (``tuning/space.fits_shard``), ranked by the mesh model (exchange
    charged); RP107 when none fits."""
    feasible = [dc for dc in enumerate_decompositions(program.ndim,
                                                      n_devices, grid_shape)
                if fits_shard(plan, dc, grid_shape)]
    if not feasible:
        raise _no_feasible_split(grid_shape, n_devices, plan)
    cands = [Candidate(plan=plan, backend=backend, backend_version=version,
                       variant=variant, decomp=dc) for dc in feasible]
    best = rank(program, cands, chip, grid_shape=grid_shape, cards=cards)[0]
    return best.candidate.decomp.axis_shards


def _plan_mesh(program, chip: GpuChip, grid_shape, n_devices: int,
               decomp_axes, backend: str, max_par_time: int,
               cards: int) -> Tuple[BlockPlan, Tuple[int, ...]]:
    """``plan="model"`` on a mesh: the H100 planner's candidates on each
    shard's extent (``tuning/space.enumerate_space`` over the splits,
    or the pinned one) ranked by the mesh model; RP107 when none fits."""
    decomps = None if decomp_axes is None \
        else (MeshDecomposition(tuple(decomp_axes)),)
    cands = enumerate_space(program, chip, backends=(backend,),
                            grid_shape=grid_shape,
                            max_par_time=max_par_time,
                            n_devices=None if decomps else n_devices,
                            decompositions=decomps)
    if not cands:
        raise _no_feasible_split(grid_shape, n_devices)
    best = rank(program, cands, chip, grid_shape=grid_shape,
                cards=cards)[0].candidate
    return best.plan, best.decomp.axis_shards


def _resolve_device(device) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device; raises RP110
    when no GPU is visible.  Any other device is taken as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise DiagnosticError([_diag(
            "RP110",
            "repro_torch runs on a CUDA device by default and none is "
            "visible",
            hint="run on a GPU host, or pass device='cpu' for the plain "
                 "PyTorch versions")])
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def stencil(program: StencilProgram,
            coeffs: Optional[ProgramCoeffs] = None) -> "Stencil":
    """The front door: bind a program (or a legacy ``StencilSpec``) to its
    coefficients (default: the program's ``default_coeffs()``; legacy
    ``StencilCoeffs`` are put in tap order)."""
    return Stencil(program, coeffs)


class Stencil:
    """A program + coefficients, ready to compile."""

    def __init__(self, program: StencilProgram,
                 coeffs: Optional[ProgramCoeffs] = None):
        self.program = as_program(program)
        self.coeffs = self.program.default_coeffs() if coeffs is None \
            else normalize_coeffs(self.program, coeffs)

    def compile(self, grid_shape, *, steps: int,
                batch: Optional[int] = None,
                devices: Devices = None,
                plan: Union[str, BlockPlan] = "auto",
                backend: Optional[str] = None,
                variant: Optional[str] = None,
                pipelined: Optional[bool] = None,
                device=None,
                chip: Optional[GpuChip] = None,
                max_par_time: int = 32,
                cache: bool = True,
                cache_path: Optional[str] = None,
                sanitize: bool = False) -> "CompiledStencil":
        """Validate the run, resolve its plan and bind it to ``device``.

        grid_shape    spatial extent of one grid; ``batch`` adds a leading
                      ``(B, *grid)`` axis of independent grids.
        steps         the step count ``run`` uses by default (>= 1).
        devices       None or 1: one device; an int N: a mesh of N
                      devices, the split searched (``plan="auto"``: with
                      the plan, by the model; otherwise for the plan);
                      shards per axis: that split.  The mesh takes
                      ``core/distributed.visible_devices(device)``; more
                      devices than it gives, the temporal variant and
                      the oracle are RP110, an infeasible split RP107.
        plan          "auto" — the autotuner, model-only, through its plan
                      cache (``cache``/``cache_path``); "model" — the H100
                      planner (``core/blocking.plan_blocking``); or a
                      ``BlockPlan`` pinned by the caller.
        backend       a registered name (default ``cuda``).
        variant       None/"auto" keeps the backend as named, except that
                      ``plan="auto"`` on the plain backend searches the
                      ``cuda``, ``cuda-pipelined`` and ``cuda-temporal``
                      siblings and keeps the model's pick; "plain",
                      "pipelined" or "temporal" picks that sibling, and
                      raises where the backend has none.
        pipelined     the deprecated bool spelling of ``variant``: a bool
                      warns and maps to "pipelined"/"plain"; given beside
                      ``variant`` it is RP114.
        device        None = CUDA (RP110 without a GPU); "cpu" runs the
                      plain versions of the kernels.
        chip          the card the plan is made and checked for: None is
                      the visible card on CUDA and ``H100_SXM`` on the
                      CPU.  On CUDA, or when ``chip`` is given, a plan no
                      CTA tile of the variant fits is RP105, here for
                      ``steps`` and at ``run`` for any other count.
        max_par_time  the deepest superstep the planners consider.
        sanitize      also run the NaN canary (``lint/sanitize``): the
                      run's supersteps one by one on ``device`` (the CUDA
                      kernels on the card, their plain versions on the
                      CPU) with every cell outside the true interior
                      poisoned; an error raises, the report stays on
                      ``CompiledStencil.sanitize_report``.  The proof of
                      the ring schedule (``lint/dataflow``) runs always.

        With the flight recorder on, the resolution runs inside a
        ``compile`` span: the plan source and plan-cache hit, backend@version,
        variant, block, ``par_time``, supersteps, the model's bytes per
        superstep (``BlockPlan.run_bytes_per_superstep``) and its run time
        (``predicted_s``, ``core/blocking.run_seconds``).
        """
        variant = _normalize_variant_request(variant, pipelined)
        kwargs = dict(steps=steps, batch=batch, devices=devices, plan=plan,
                      backend=backend, variant=variant, device=device,
                      chip=chip, max_par_time=max_par_time, cache=cache,
                      cache_path=cache_path, sanitize=sanitize)
        rec = obs.active()
        if rec is None or torch.compiler.is_compiling():
            return self._compile(grid_shape, **kwargs)
        plan_source = plan if isinstance(plan, str) else "pinned"
        with rec.span("compile", plan_source=plan_source) as sp:
            cs = self._compile(grid_shape, **kwargs)
            sp.set(**cs._span_attrs())
            sp.set(cache_hit=cs.from_plan_cache,
                   supersteps=-(-cs.steps // cs.plan.par_time),
                   model_bytes_per_superstep=cs.plan.run_bytes_per_superstep(
                       cs.grid_shape, cs.variant),
                   predicted_s=cs.predicted_seconds(cs.steps))
            rec.count("compile.plan_cache_hit" if cs.from_plan_cache
                      else "compile.plan_cache_miss")
        return cs

    def _compile(self, grid_shape, *, steps: int,
                 batch: Optional[int] = None,
                 devices: Devices = None,
                 plan: Union[str, BlockPlan] = "auto",
                 backend: Optional[str] = None,
                 variant: Optional[str] = None,
                 device=None,
                 chip: Optional[GpuChip] = None,
                 max_par_time: int = 32,
                 cache: bool = True,
                 cache_path: Optional[str] = None,
                 sanitize: bool = False) -> "CompiledStencil":
        """Validate, plan and bind; the contract is :meth:`compile`'s."""
        prog = self.program
        try:
            grid_shape = tuple(operator.index(s) for s in grid_shape)
        except TypeError:
            raise DiagnosticError([_diag(
                "RP101",
                f"grid_shape must be a sequence of ints (got {grid_shape!r})",
                hint="pass the spatial extents, e.g. (4096, 4096)")])
        if len(grid_shape) != prog.ndim or any(s < 1 for s in grid_shape):
            raise DiagnosticError([_diag(
                "RP101",
                f"grid_shape {grid_shape} does not describe a {prog.ndim}-D "
                f"grid for this {prog.ndim}-D program (expected "
                f"{prog.ndim} positive extents); a leading batch axis is "
                f"declared via compile(batch=B), not in grid_shape",
                hint=f"give exactly {prog.ndim} positive extents")])
        steps = _check_steps(
            steps,
            "; compile() pins the step count the executable is built for, "
            "and run(grid, steps=n) may override it per call")
        if batch is not None:
            b = _as_int(batch)
            if b is None or b < 1:
                raise DiagnosticError([_diag(
                    "RP103",
                    f"batch must be None (unbatched) or an int >= 1 — the "
                    f"extent of the leading (B, *grid) axis of independent "
                    f"grids (got {batch!r})",
                    hint="drop batch= for a single grid, or stack "
                         "independent grids along a leading axis")])
            batch = b
        # RP109 before any planning arithmetic sizes a cell by the dtype
        raise_on_error(dtype_diagnostics(prog), source="verify")
        decomp_axes, n_devices = _normalize_devices(prog, devices)
        concrete = None if variant in (None, "auto") else variant
        name, version, traits = resolve_backend(backend, variant=concrete)
        if n_devices > 1 and traits.variant == "temporal":
            raise DiagnosticError([_diag(
                "RP110",
                f"backend {name!r} (the temporally-fused variant) cannot "
                f"run sharded: its launch advances TEMPORAL_CHUNK "
                f"supersteps per kernel, but the mesh executor exchanges "
                f"halos once per superstep — the chunk would read "
                f"neighbor cells that were never exchanged; "
                f"compile(devices={devices!r}) needs a per-superstep "
                f"local kernel",
                hint="drop devices= for the temporal variant, or use "
                     "variant='plain'/'pipelined' on the mesh")])
        if n_devices > 1 and not traits.local_kernel:
            raise DiagnosticError([_diag(
                "RP110",
                f"backend {name!r} cannot run sharded (it declares no "
                f"local_kernel trait — its lowering pads its own "
                f"boundaries and cannot consume an exchanged halo); "
                f"compile(devices={devices!r}) needs a cuda backend",
                hint="drop devices= for this backend, or use a cuda "
                     "backend for mesh runs")])
        planned = isinstance(plan, str) and plan in ("auto", "model")
        if not planned and not isinstance(plan, BlockPlan):
            raise DiagnosticError([_diag(
                "RP112",
                f'plan must be "auto", "model", or a BlockPlan '
                f"(got {plan!r})",
                hint='use plan="auto" unless pinning a tuned BlockPlan')])
        dev = _resolve_device(device)
        mesh_devices = _mesh_devices(devices, n_devices, dev) \
            if n_devices > 1 else None
        # shards sharing a card run one after another (the mesh model)
        cards = len(set(mesh_devices)) if mesh_devices else 1
        check = traits.fused_run and (dev.type == "cuda" or chip is not None)
        if chip is None:
            chip = GpuChip.from_device(dev.index) if dev.type == "cuda" \
                else H100_SXM
        tuned = None
        common.note_trace("plan_resolutions")
        try:
            if plan == "auto":
                # local: the tuner lowers candidates through this package
                from repro_torch.tuning import autotune
                # search the variant axis only when nothing pinned one
                search = concrete is None and traits.variant == "plain"
                tuned = autotune(
                    prog, chip, grid_shape=grid_shape, backend=name,
                    variant="auto" if search else None, measure=False,
                    cache=cache, cache_path=cache_path,
                    max_par_time=max_par_time, device=dev,
                    n_devices=n_devices if (n_devices > 1
                                            and decomp_axes is None)
                    else None,
                    decomposition=decomp_axes if n_devices > 1 else None,
                    cards=cards)
                plan = tuned.plan
                if tuned.backend != name:
                    name, version, traits = resolve_backend(tuned.backend)
                if n_devices > 1:
                    decomp_axes = tuned.decomp or decomp_axes
            elif plan == "model" and n_devices > 1:
                plan, decomp_axes = _plan_mesh(
                    prog, chip, grid_shape, n_devices, decomp_axes, name,
                    max_par_time, cards)
            elif plan == "model":
                plan = plan_blocking(prog, chip, grid_shape=grid_shape,
                                     max_par_time=max_par_time,
                                     variant=traits.variant,
                                     steps=steps).plan
            elif n_devices > 1 and decomp_axes is None:
                decomp_axes = _pick_decomposition(
                    prog, plan, grid_shape, n_devices, chip, name, version,
                    traits.variant, cards)
        except DiagnosticError:
            raise
        except ValueError as e:   # no plan of the variant fits the card
            if n_devices > 1 and "empty design space" in str(e):
                raise _no_feasible_split(grid_shape, n_devices) from e
            raise DiagnosticError([_diag(
                "RP105", str(e),
                hint="pick variant='plain' for the smallest footprint")]) \
                from e
        if n_devices <= 1:
            decomp_axes = None
        # the pre-flight, before anything is built or launched: RP1xx
        # (RP105 only where a card's limit applies; RP107 per shard on a
        # mesh), then the proof of the ring schedule the executor runs
        preflight = _preflight(prog, plan, grid_shape,
                               chip if check else None,
                               decomp=decomp_axes, variant=traits.variant,
                               batch=batch, steps=steps)
        coeffs = self.coeffs.to(dev)
        report = None
        if traits.fused_run:
            preflight += check_dataflow(prog, plan, grid_shape, steps=steps,
                                        variant=traits.variant,
                                        decomp=decomp_axes)
            # the canary runs one device's schedule, as the reference's
            if sanitize and decomp_axes is None:
                report = sanitize_run(prog, plan, grid_shape, steps=steps,
                                      coeffs=coeffs, variant=traits.variant,
                                      device=dev)
                raise_on_error(report.diagnostics, source="sanitize")
        dist = lowered = None
        if decomp_axes is not None:
            mesh = make_mesh(decomp_axes, mesh_devices)
            decomp = Decomposition(tuple(
                (mesh.axis_names[d],) if decomp_axes[d] > 1 else ()
                for d in range(prog.ndim)))
            dist = DistributedStencil(prog, self.coeffs, plan, mesh, decomp,
                                      grid_shape, backend=name,
                                      _warn=False)
        elif not traits.fused_run:
            # a backend whose run is not the fused executor (the oracle)
            # runs through its own lowering
            lowered = lower(prog, plan, coeffs=coeffs, backend=name,
                            version=version)
        return CompiledStencil(program=prog, coeffs=coeffs,
                               grid_shape=grid_shape, steps=steps,
                               batch=batch, plan=plan, backend=name,
                               backend_version=version,
                               variant=traits.variant, device=dev,
                               lowered=lowered, dist=dist,
                               decomp=decomp_axes,
                               chip=chip if check else None,
                               model_chip=chip, tuned=tuned,
                               preflight=preflight, sanitize_report=report)


class CompiledStencil:
    """A validated run bound to one device (or a mesh) and one backend;
    ``run`` dispatches it."""

    def __init__(self, *, program: StencilProgram, coeffs: ProgramCoeffs,
                 grid_shape: Tuple[int, ...], steps: int,
                 batch: Optional[int], plan: BlockPlan, backend: str,
                 backend_version: int, variant: str, device: torch.device,
                 lowered: Optional[LoweredStencil] = None,
                 dist: Optional[DistributedStencil] = None,
                 decomp: Optional[Tuple[int, ...]] = None,
                 chip: Optional[GpuChip] = None,
                 model_chip: GpuChip,
                 tuned=None, preflight=None,
                 sanitize_report: Optional[SanitizeReport] = None):
        #: the pre-flight's warnings (RP106 row pitch, RP108 wrap-degenerate
        #: fallback, RP113 overlap tax); its errors raise at compile
        self.preflight = list(preflight or [])
        #: the NaN canary's report under ``compile(sanitize=True)``, else
        #: None; its errors raise at compile, so a stored report is clean
        self.sanitize_report = sanitize_report
        self.program = program
        self.coeffs = coeffs
        self.grid_shape = grid_shape
        self.steps = steps
        self.batch = batch
        self.plan = plan
        self.backend = backend
        self.backend_version = backend_version
        self.variant = variant
        self.device = device
        self._lowered = lowered
        #: the mesh executor and its shards per axis (None: one device)
        self._dist = dist
        self.decomp = decomp
        # the chip RP105 is checked against (None: no check), and the
        # diagnostics per (a full superstep runs, remainder): what decides
        # the kernels of a run
        self._chip = chip
        self._fits = {self._launch_key(steps): []}
        #: the card the plan was made for, which the model prices runs on
        self.chip = model_chip
        #: the autotuner's answer under plan="auto" (None otherwise), and
        #: whether it came from the plan cache
        self.tuned = tuned
        self.from_plan_cache = tuned is not None and tuned.from_cache
        self._predicted = {}
        self._history_key = None

    def describe(self) -> str:
        """Where the run goes: ``1 device`` or ``mesh 2x2``."""
        return "1 device" if self.decomp is None else \
            f"mesh {'x'.join(map(str, self.decomp))}"

    def __repr__(self) -> str:
        b = "" if self.batch is None else f" batch={self.batch}"
        v = "" if self.variant == "plain" else f" variant={self.variant}"
        return (f"CompiledStencil(grid={self.grid_shape}{b} "
                f"steps={self.steps} block={self.plan.block_shape} "
                f"par_time={self.plan.par_time} backend={self.backend}"
                f"{v} on {self.describe()})")

    def _local_shape(self) -> Tuple[int, ...]:
        """One shard's extent (the grid on one device): what the kernels
        of a run launch on."""
        if self.decomp is None:
            return self.grid_shape
        return tuple(g // s for g, s in zip(self.grid_shape, self.decomp))

    def _launch_key(self, steps: int) -> Tuple[bool, int]:
        period = self.plan.par_time * (
            TEMPORAL_CHUNK if self.variant == "temporal" else 1)
        full, rem = divmod(steps, period)
        return full > 0, rem

    def _check_fits(self, steps: int) -> None:
        """RP105 when a kernel a run of ``steps`` launches fits no CTA
        tile of the chip compile checked against (compile checked its own
        count); raised before any launch."""
        if self._chip is None:
            return
        key = self._launch_key(steps)
        if key not in self._fits:
            self._fits[key] = smem_diagnostics(
                self.plan, self.variant, self._chip,
                grid_shape=self._local_shape(), steps=steps)
        raise_on_error(self._fits[key], source="verify")

    def _check_grid(self, grid) -> None:
        """The grid's type, device, dtype and shape against the compile's.
        A batch may come as a sequence of grids, each checked as a tensor;
        its shape is then its count before the grids' one shape."""
        if isinstance(grid, (list, tuple)):
            for g in grid:
                self._check_tensor(g)
            shapes = list(dict.fromkeys(tuple(g.shape) for g in grid))
            if len(shapes) != 1:
                raise DiagnosticError([_diag(
                    "RP101",
                    f"a batch of grids needs one shape (got "
                    f"{shapes or 'no grid'}); compile() pins the grid "
                    f"shape {self.grid_shape}",
                    hint="submit grids of one shape as one batch")])
            self._check_shape((len(grid),) + shapes[0])
            return
        self._check_tensor(grid)
        self._check_shape(tuple(grid.shape))

    def _check_tensor(self, grid) -> None:
        if not isinstance(grid, torch.Tensor):
            raise TypeError(f"grid must be a torch.Tensor on {self.device} "
                            f"(got {type(grid).__name__})")
        if grid.device != self.device:
            raise DiagnosticError([_diag(
                "RP110",
                f"grid lies on {grid.device} but this executable was "
                f"compiled for {self.device}",
                hint=f"move the grid with .to({str(self.device)!r}) or "
                     f"compile for its device")])
        want = torch_dtype(self.program.dtype)
        if grid.dtype != want:
            raise DiagnosticError([_diag(
                "RP109", f"grid dtype {grid.dtype}: this executable runs "
                         f"the program's dtype {want}",
                hint=f"cast the grid with .to({want}), or compile a "
                     f"program of dtype {str(grid.dtype).split('.')[-1]!r}"
            )])

    def _check_shape(self, shape: Tuple[int, ...]) -> None:
        want = self.grid_shape if self.batch is None \
            else (self.batch,) + self.grid_shape
        if shape == want:
            return
        spatial = len(self.grid_shape)
        if self.batch is None and len(shape) == spatial + 1 \
                and shape[1:] == self.grid_shape:
            raise DiagnosticError([_diag(
                "RP103",
                f"this executable was compiled unbatched for grid "
                f"{self.grid_shape} but got a batched grid of shape "
                f"{shape}; compile(batch={shape[0]}) to "
                f"run a leading axis of independent grids",
                hint=f"recompile with batch={shape[0]}")])
        if self.batch is not None and shape == self.grid_shape:
            raise DiagnosticError([_diag(
                "RP103",
                f"this executable was compiled for batch={self.batch} "
                f"grids of shape {self.grid_shape} but got a single "
                f"unbatched grid {shape}; stack the grids "
                f"(B, *grid) or compile(batch=None)",
                hint="batch rank is pinned at compile time")])
        raise DiagnosticError([_diag(
            "RP101",
            f"grid shape {shape} does not match the compiled "
            f"{'batch=' + str(self.batch) + ' ' if self.batch else ''}"
            f"grid_shape {want}; compile() pins shapes so the executable "
            f"cache stays exact — recompile for a different shape",
            hint=f"recompile for grid {shape}")])

    def run(self, grid: Union[torch.Tensor, Sequence[torch.Tensor]],
            steps: Optional[int] = None) -> torch.Tensor:
        """Advance ``steps`` time steps (default: the compiled count) and
        return a new tensor in the grid's dtype; ``grid`` is not written
        and has the program's dtype (float32, bfloat16 or float16;
        another is RP109).  A count whose kernels fit no CTA tile is
        RP105, before any launch.  A batched executable also takes its
        batch as a list or tuple of ``batch`` grids of the compiled shape,
        which the fused executor copies into its padded carry one by one
        (the mesh and a lowered backend stack them first); the result is
        the one tensor a stacked batch gives.

        With the flight recorder on, the run is timed under a ``run`` span
        (:meth:`_run_recorded`), which synchronises the device; off, it is
        only enqueued on the current stream, inside a ``run`` range while
        a profiler records."""
        steps = self.steps if steps is None else _check_steps(steps)
        self._check_grid(grid)
        self._check_fits(steps)
        rec = obs.active()
        if rec is None:
            with obs.profiler_range("run"):
                return self._dispatch(grid, steps)
        if torch.compiler.is_compiling():
            return self._dispatch(grid, steps)
        return self._run_recorded(rec, grid, steps)

    def _dispatch(self, grid, steps: int) -> torch.Tensor:
        if not isinstance(grid, torch.Tensor) and (
                self._dist is not None or self._lowered is not None):
            grid = torch.stack(grid)     # these take one tensor
        if self._dist is not None:
            return self._dist.run(grid, steps)
        if self._lowered is not None:
            return self._lowered.run(grid, steps)
        return ops._stencil_run(grid, self.program, self.coeffs, self.plan,
                                steps, variant=self.variant)

    def _run_recorded(self, rec, grid: torch.Tensor,
                      steps: int) -> torch.Tensor:
        """One dispatch under a ``run`` span, and one accuracy sample.

        On CUDA the device is synchronised before the clock starts, so
        earlier work is not charged; CUDA events on the current stream (the
        one the kernels launch on) around the dispatch give ``device_s``,
        the host clock around the synchronised dispatch ``wall_s``, their
        difference ``host_s``, and the change in the kernels' launch counts
        ``launch_delta`` (launches from other threads meanwhile count too).
        On a mesh the events bracket every card's current stream (the
        shards' launches go there) and ``device_s`` is the longest card's.
        On the CPU those four are None.  ``model_accuracy`` is
        ``predicted_s / wall_s`` (= achieved / predicted GB/s)."""
        card = self.device.type == "cuda"
        with rec.span("run", **self._span_attrs()) as sp:
            if card:
                cards = tuple(dict.fromkeys(
                    (self.device,) + (self._dist.mesh.cards()
                                      if self._dist is not None else ())))
                for c in cards:
                    torch.cuda.synchronize(c)
                events = [(torch.cuda.current_stream(c),
                           torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
                          for c in cards]
                before = cuda.launches()
            t0 = time.perf_counter()
            if card:
                for stream, start, _ in events:
                    start.record(stream)
            out = self._dispatch(grid, steps)
            if card:
                for stream, _, end in events:
                    end.record(stream)
                for c in cards:
                    torch.cuda.synchronize(c)
            wall = time.perf_counter() - t0
            device_s = host_s = launch_delta = None
            if card:
                device_s = max(start.elapsed_time(end)
                               for _, start, end in events) / 1e3
                host_s = wall - device_s
                after = cuda.launches()
                launch_delta = {k: n - before[k] for k, n in after.items()
                                if n != before[k]}
            nb = 1 if self.batch is None else self.batch
            cells = nb * math.prod(self.grid_shape) * steps
            predicted = self.predicted_seconds(steps)
            gbps = cells * self.program.bytes_per_cell / wall / 1e9
            predicted_gbps = cells * self.program.bytes_per_cell \
                / predicted / 1e9
            accuracy = predicted / wall
            sp.set(steps=steps, wall_s=wall, device_s=device_s,
                   host_s=host_s, mcells_per_s=cells / wall / 1e6,
                   achieved_gbps=gbps,
                   achieved_gflops=cells * self.program.flops_per_cell
                   / wall / 1e9,
                   predicted_s=predicted, predicted_gbps=predicted_gbps,
                   model_accuracy=accuracy, launch_delta=launch_delta)
            rec.record_accuracy(
                key=self.history_key(), device=self.device.type,
                chip=self.chip.name, backend=self.backend,
                backend_version=self.backend_version,
                variant=self.variant, grid_shape=list(self.grid_shape),
                batch=self.batch, steps=steps,
                block_shape=list(self.plan.block_shape),
                par_time=self.plan.par_time,
                decomp=None if self.decomp is None else list(self.decomp),
                predicted_s=predicted, wall_s=wall, device_s=device_s,
                predicted_gbps=predicted_gbps, achieved_gbps=gbps,
                model_accuracy=accuracy, mcells_per_s=cells / wall / 1e6,
                source="executor.run")
        return out

    # -- telemetry -----------------------------------------------------------

    def predicted_seconds(self, steps: int) -> float:
        """The H100 model's wall time of a run of ``steps``
        (``core/blocking.run_seconds`` on :attr:`chip`), kept per count.
        On a mesh: one shard's run and its exchanges, times the shards
        that share a card (``tuning/model_rank.exchange_seconds``)."""
        t = self._predicted.get(steps)
        if t is None:
            nb = 1 if self.batch is None else self.batch
            t = run_seconds(self.plan, self._local_shape(), steps,
                            self.chip, self.variant, batch=nb)
            if self._dist is not None:
                n = self._dist.mesh.size
                cards = len(self._dist.mesh.cards())
                supersteps = -(-steps // self.plan.par_time)
                t += supersteps * nb * exchange_seconds(
                    self.program, self.plan,
                    MeshDecomposition(self.decomp), self.grid_shape,
                    self.chip, shared=cards < n)
                t *= -(-n // cards)
            self._predicted[steps] = t
        return t

    def history_key(self) -> str:
        """The plan cache key this executable's accuracy samples file
        under (``tuning/cache.cache_key``: program, grid, GPU name, device
        type, backend@version), so samples join tuned plans directly.
        Kept on the instance: fingerprinting the program per run costs too
        much for the recorded path."""
        if self._history_key is None:
            self._history_key = cache_key(
                self.program, self.grid_shape, self.chip.name, self.backend,
                self.backend_version, device=self.device.type,
                decomp=self.decomp)
        return self._history_key

    def _span_attrs(self) -> dict:
        return {
            "backend": f"{self.backend}@{self.backend_version}",
            "grid_shape": list(self.grid_shape),
            "batch": self.batch,
            "device": self.device.type,
            "devices": 1 if self.decomp is None else math.prod(self.decomp),
            "decomp": None if self.decomp is None else list(self.decomp),
            "chip": self.chip.name,
            "block_shape": list(self.plan.block_shape),
            "par_time": self.plan.par_time,
            "variant": self.variant,
        }
