"""Stencil serving front: same-shape micro-batching over the front door —
counterpart of ``repro/launch/stencil_serve.py``.

Many independent grids (parameter sweeps, ensembles, per-user runs) each
under-use the card and pay their own launches.  This front queues
requests and, on ``flush()``, groups them by (program, grid shape, dtype,
steps) and runs each group through the one front door —
``repro_torch.stencil(program).compile(shape, steps=..., batch=B)`` — as
batched runs: one leading batch axis through the same kernels, so B
compatible requests cost one run's launches instead of B.

Requests in a group share the program's default coefficients; others land
in their own group.  Plans come from ``compile(plan="model")`` (the H100
planner) by default, or ``plan="auto"`` with ``use_autotune=True`` (the
autotuner and its plan cache).  The first compile of a (program, shape)
resolves its plan and backend; every later chunk size and step count
pins them, so a shape's requests all run the same kernels.

``mesh_devices=N`` compiles every batched chunk onto an N-device mesh
(``compile(devices=N)``, the mesh tuner picking the plan and the split
per (program, shape)), each chunk one batched mesh run: the batch rides
along, the grid is decomposed, one deep-halo exchange per superstep.
Groups the mesh cannot take (a shape no split divides, an empty sharded
space) run on one device instead, the reason in ``mesh_fallbacks``.

Where this differs from the reference:

* ``device=`` (None: CUDA, RP110 without a GPU; ``"cpu"`` runs the plain
  versions) and ``chip=`` replace ``interpret=``/``hw=`` and go to
  ``compile``.
* ``flush()`` returns ``{rid: torch.Tensor}`` on the server's device: row
  ``i`` of its chunk's output, not copied to the host (at paper width a
  1 GiB device-to-host copy per request would dominate ``run_s``).
* Chunks are enqueued without waiting; a CUDA event recorded after each
  chunk's dispatch is what the resolution pass waits on
  (:func:`wait_ready`).  Every request's latency sample is stamped once,
  after the whole resolution pass, at ``flush()``'s return: what the
  client holds.
* ``mesh_devices`` above what ``core/distributed.visible_devices`` gives
  (one per card, or ``REPRO_TORCH_FORCE_DEVICE_COUNT``) is RP110 at
  construction, never a silent single-device server.
* Failure isolation holds for host-side failures (a refused plan, RP105,
  RP101, ...): the group loses its own requests to ``failed`` and the
  others are served.  A device fault (an illegal address) leaves the CUDA
  context unusable for every group, so it is raised, never recorded as
  one group's failure.

Spans (``repro_torch.obs``): ``serve.flush`` on the server's own
recorder; through the global recorder, or as profiler ranges while a
``torch.profiler`` records, ``serve.submit`` and, inside ``serve.flush``,
``serve.group`` (grouping, fingerprints), per chunk ``serve.dispatch``
(``_compiled_for``, the enqueue, the done-event) and ``serve.wait``, and
``serve.route`` (results, latency stamps).  A batched chunk hands its
grids to the run as a list, which the run driver copies into its padded
carry one by one; only an identity chunk (``steps == 0``, no run) stacks
its grids, inside ``serve.stack``.

CPU-scale usage:
    PYTHONPATH=src python -m repro_torch.launch.stencil_serve --device cpu \\
        --requests 9 --grid 48,256 --radius 2 --steps 5 --max-batch 4
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.analysis.hw import GpuChip
from repro_torch.core.program import StencilProgram, torch_dtype
from repro_torch.executor import (CompiledStencil, _mesh_devices,
                                  _normalize_variant_request,
                                  _resolve_device, stencil)
from repro_torch.lint.diagnostics import DiagnosticError
from repro_torch.lint.diagnostics import error as _diag
from repro_torch.tuning.cache import program_fingerprint


@dataclasses.dataclass
class StencilRequest:
    rid: int
    program: StencilProgram
    grid: torch.Tensor          # (*grid_shape) on the server's device
    steps: int
    t_submit: float = 0.0       # perf_counter at submit; latency anchor


class ServeStats:
    """Live read-only view over the server's flight recorder.

    ``compile_seconds`` sums the dispatch time of cold executables (the
    plan resolution and first enqueue), ``run_seconds`` the warm dispatches
    plus the resolution pass; ``latency_percentiles()`` gives per-request
    p50/p95/p99, and ``serve.queue_depth``/``serve.batch_occupancy``
    samples live under those names on ``recorder``.
    """

    def __init__(self, recorder: "obs.Recorder"):
        self.recorder = recorder

    @property
    def requests(self) -> int:
        return self.recorder.counter("serve.requests")

    @property
    def batches(self) -> int:
        return self.recorder.counter("serve.batches")

    @property
    def batched_requests(self) -> int:
        """Requests that shared their executable with a batch-mate."""
        return self.recorder.counter("serve.batched_requests")

    @property
    def sharded_batches(self) -> int:
        """Batches placed on a device mesh (none: one device)."""
        return self.recorder.counter("serve.sharded_batches")

    @property
    def cell_steps(self) -> int:
        return self.recorder.counter("serve.cell_steps")

    @property
    def compile_seconds(self) -> float:
        return self.recorder.sample_sum("serve.compile_s")

    @property
    def run_seconds(self) -> float:
        return self.recorder.sample_sum("serve.run_s")

    @property
    def seconds(self) -> float:
        return self.compile_seconds + self.run_seconds

    def latency_percentiles(self) -> Dict[str, float]:
        """{"p50": s, "p95": s, "p99": s} of submit to ``flush()``'s
        return."""
        return self.recorder.percentiles("serve.request_latency_s")


def _as_grid(grid, program: StencilProgram, device) -> torch.Tensor:
    """``grid`` as a tensor of the program's dtype on ``device``.  A numpy
    bfloat16 array (``ml_dtypes``), which torch cannot read, goes through
    float32, which holds it exactly."""
    if getattr(getattr(grid, "dtype", None), "name", None) == "bfloat16":
        grid = np.asarray(grid, dtype=np.float32)
    return torch.as_tensor(grid, dtype=torch_dtype(program.dtype),
                           device=device)


def wait_ready(out: torch.Tensor,
               done: Optional[torch.cuda.Event]) -> torch.Tensor:
    """Block until a chunk's work is done: its event, recorded after the
    dispatch, on CUDA; on the CPU the result is already computed."""
    if done is not None:
        done.synchronize()
    return out


def _device_fault(exc: BaseException) -> bool:
    """A CUDA error: the context is unusable for every group after it."""
    accel = getattr(torch, "AcceleratorError", None)
    return (accel is not None and isinstance(exc, accel)) \
        or "CUDA error" in str(exc)


class StencilServer:
    """Queue + group + batched-flush executor for stencil runs.

    ``max_batch`` caps the leading batch axis per run (about bounding one
    dispatch's latency and memory).  ``variant`` selects the kernel variant
    for every group ("plain" | "pipelined" | "temporal" | "auto"/None;
    ``pipelined=True`` is the deprecated bool spelling of
    ``variant="pipelined"``, and both at once is RP114).
    """

    def __init__(self, *, max_batch: int = 8,
                 device=None,
                 chip: Optional[GpuChip] = None,
                 pipelined: Optional[bool] = None,
                 variant: Optional[str] = None,
                 use_autotune: bool = False,
                 cache_path: Optional[str] = None,
                 max_par_time: int = 8,
                 mesh_devices: Optional[int] = None,
                 recorder: Optional["obs.Recorder"] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1 (got {max_batch})")
        if mesh_devices is not None and mesh_devices < 1:
            raise ValueError(
                f"mesh_devices must be >= 1 (got {mesh_devices})")
        self.max_batch = max_batch
        # one rule with the front door: conflicting requests are RP114, a
        # lone bool warns and maps to its variant name
        variant = _normalize_variant_request(variant, pipelined)
        self.pipelined = variant == "pipelined"
        self.device = _resolve_device(device)
        if mesh_devices is not None and mesh_devices > 1:
            # RP110 here when too few devices are visible: a mesh server
            # never serves on one device in silence
            _mesh_devices(mesh_devices, mesh_devices, self.device)
        self.chip = chip
        self.variant = variant
        self.use_autotune = use_autotune
        self.cache_path = cache_path
        self.max_par_time = max_par_time
        # a 1-device "mesh" is the single-device executor, so that
        # stats.sharded_batches counts only batches that were sharded
        self.mesh_devices = None if mesh_devices == 1 else mesh_devices
        # an explicit recorder records whatever REPRO_TORCH_OBS says, so
        # serve stats always work
        self.recorder = recorder if recorder is not None else obs.Recorder()
        self.stats = ServeStats(self.recorder)
        #: (executable identity, steps) pairs that already dispatched once
        self._warm: set = set()
        self.failed: Dict[int, str] = {}
        #: (program fp, shape) -> why the mesh declined the group
        self.mesh_fallbacks: Dict[Tuple[str, Tuple[int, ...]], str] = {}
        self._pending: List[StencilRequest] = []
        self._next_rid = 0
        self._programs: Dict[str, StencilProgram] = {}
        #: (fp, shape, batch) -> executable; steps stays out of the key, as
        #: run(grid, steps) takes its own count
        self._compiled: Dict[tuple, CompiledStencil] = {}
        #: (fp, shape) -> (plan, backend): the plan search runs once per
        #: shape, and every chunk size pins its answer
        self._resolved: Dict[tuple, tuple] = {}
        #: the same two on the mesh, the split pinned beside the plan
        self._mesh_compiled: Dict[tuple, CompiledStencil] = {}
        self._mesh_resolved: Dict[tuple, tuple] = {}

    # -- request intake ------------------------------------------------------

    def submit(self, program: StencilProgram, grid, steps: int) -> int:
        """Queue one run; returns the request id ``flush()`` resolves.  The
        grid moves to the server's device in the program's dtype, as the
        reference casts it."""
        with obs.span("serve.submit"):
            if not isinstance(program, StencilProgram):
                raise TypeError(f"program must be a StencilProgram (got "
                                f"{type(program).__name__})")
            grid = _as_grid(grid, program, self.device)
            if grid.ndim != program.ndim:
                raise ValueError(
                    f"request grid rank {grid.ndim} != program ndim "
                    f"{program.ndim}")
            if steps < 0:
                raise ValueError("steps must be >= 0")
            rid = self._next_rid
            self._next_rid += 1
            self._pending.append(
                StencilRequest(rid, program, grid, steps,
                               t_submit=time.perf_counter()))
        return rid

    def pending(self) -> int:
        return len(self._pending)

    # -- compilation ---------------------------------------------------------

    def _compiled_for(self, program: StencilProgram, shape: Tuple[int, ...],
                      steps: int, batch: Optional[int],
                      on_mesh: bool = False) -> CompiledStencil:
        """Front-door executable for one chunk shape, memoized per server.

        ``steps`` only seeds the first compile of a key; every flush
        passes its own count to ``run``.  The first compile of a shape
        plans (the autotuner's cache when the caller opted in with
        ``use_autotune`` or ``cache_path``, the model planner otherwise;
        on the mesh always the mesh tuner, model-only, touching the
        cache only under the same opt-in); later ones pin its plan,
        backend and split.
        """
        fp = program_fingerprint(program)
        compiled, found = (self._mesh_compiled, self._mesh_resolved) \
            if on_mesh else (self._compiled, self._resolved)
        cs = compiled.get((fp, shape, batch))
        if cs is None:
            resolved = found.get((fp, shape))
            if resolved is None:
                plan = "auto" if (on_mesh or self.use_autotune) else "model"
                backend, variant = None, self.variant
                devices = self.mesh_devices if on_mesh else None
            else:
                (plan, backend), variant = resolved[:2], None
                devices = resolved[2] if on_mesh else None
            cs = stencil(program).compile(
                shape, steps=steps, batch=batch, devices=devices, plan=plan,
                backend=backend, variant=variant, device=self.device,
                chip=self.chip, max_par_time=self.max_par_time,
                cache=self.use_autotune or self.cache_path is not None,
                cache_path=self.cache_path)
            found[(fp, shape)] = (cs.plan, cs.backend) + (
                (cs.decomp,) if on_mesh else ())
            compiled[(fp, shape, batch)] = cs
        return cs

    def _mesh_ok(self, program: StencilProgram,
                 shape: Tuple[int, ...]) -> bool:
        return self.mesh_devices is not None and \
            (program_fingerprint(program), shape) not in self.mesh_fallbacks

    # -- execution -----------------------------------------------------------

    def _group_key(self, req: StencilRequest):
        fp = program_fingerprint(req.program)
        self._programs.setdefault(fp, req.program)
        return (fp, tuple(req.grid.shape), str(req.grid.dtype), req.steps)

    def flush(self) -> Dict[int, torch.Tensor]:
        """Run every pending request; returns ``{rid: result}``, each a
        tensor on the server's device (row ``i`` of its chunk's output).

        Groups are formed by (program, shape, dtype, steps) and run in
        ``max_batch``-sized batched runs; a chunk of one runs unbatched
        through the same executor.  A group whose plan, compile or run
        raises on the host loses only its own requests — their rids land in
        ``self.failed`` with the error — and every other group is still
        served; a CUDA error is raised (the module docstring says why).
        A group the mesh refuses runs on one device (the reason in
        ``mesh_fallbacks``) before it counts as failed.
        """
        rec = self.recorder
        pending, self._pending = self._pending, []
        rec.observe("serve.queue_depth", float(len(pending)))
        results: Dict[int, torch.Tensor] = {}
        failed_before = len(self.failed)
        outs = []
        with rec.span("serve.flush", requests=len(pending)) as flush_span:
            groups: Dict[tuple, List[StencilRequest]] = {}
            with obs.span("serve.group"):
                for req in pending:
                    groups.setdefault(self._group_key(req), []).append(req)
            flush_span.set(groups=len(groups))
            for (fp, shape, _dtype, steps), reqs in groups.items():
                program = self._programs[fp]
                done = 0     # requests of this group whose chunk already ran
                if steps == 0:      # identity: results are the inputs, no run
                    for lo in range(0, len(reqs), self.max_batch):
                        chunk = reqs[lo:lo + self.max_batch]
                        with obs.span("serve.stack"):
                            stacked = torch.stack([r.grid for r in chunk])
                        outs.append((chunk, stacked, None))
                        self._count_chunk(chunk, shape, steps)
                    continue
                try:
                    on_mesh = self._mesh_ok(program, shape)
                    if on_mesh:
                        try:
                            # plan and split once per group; a refusal
                            # (no split divides the shape, an empty
                            # sharded space) moves the group, not the
                            # flush, to one device
                            t0 = time.perf_counter()
                            self._compiled_for(program, shape, steps,
                                               len(reqs[:self.max_batch]),
                                               on_mesh=True)
                            rec.observe("serve.compile_s",
                                        time.perf_counter() - t0)
                        except ValueError as e:  # RP107, RP110, no plan
                            self.mesh_fallbacks[(fp, shape)] = \
                                f"{type(e).__name__}: {e}"
                            on_mesh = False
                    for lo in range(0, len(reqs), self.max_batch):
                        chunk = reqs[lo:lo + self.max_batch]
                        t0 = time.perf_counter()
                        # on the mesh every chunk is one batched run
                        batch = len(chunk) if (on_mesh or len(chunk) > 1) \
                            else None
                        # a batch goes as its grids: the run driver copies
                        # each into the padded carry once, with no stack
                        grid = chunk[0].grid if batch is None \
                            else [r.grid for r in chunk]
                        with obs.span("serve.dispatch"):
                            cs = self._compiled_for(program, shape, steps,
                                                    batch, on_mesh)
                            # timed here: the enqueue; wait_ready
                            # synchronises
                            out = cs.run(grid, steps)  # lint-ok: RP302
                            if batch is None:
                                out = out[None]
                            ready = self._record_done()
                        outs.append((chunk, out, ready))
                        # the first dispatch of an (executable, steps) pair
                        # pays the plan resolution; later ones only enqueue
                        wkey = (id(cs), steps)
                        cold = wkey not in self._warm
                        self._warm.add(wkey)
                        rec.observe(
                            "serve.compile_s" if cold else "serve.run_s",
                            time.perf_counter() - t0)
                        done += len(chunk)
                        self._count_chunk(chunk, shape, steps)
                        if on_mesh:
                            rec.count("serve.sharded_batches")
                except Exception as e:  # plan/compile failure: fail the rest
                    if _device_fault(e):
                        raise
                    for req in reqs[done:]:
                        self.failed[req.rid] = f"{type(e).__name__}: {e}"
            # Resolution is a separate pass so that every chunk is enqueued
            # before the first wait; a chunk whose wait raises fails only
            # its own rids.
            t0 = time.perf_counter()
            ready_chunks = []
            for chunk, out, ready in outs:
                try:
                    with obs.span("serve.wait"):
                        out = wait_ready(out, ready)
                except Exception as e:
                    if _device_fault(e):
                        raise
                    for req in chunk:
                        self.failed[req.rid] = f"{type(e).__name__}: {e}"
                    continue
                ready_chunks.append((chunk, out))
            with obs.span("serve.route"):
                for chunk, out in ready_chunks:
                    for i, req in enumerate(chunk):
                        results[req.rid] = out[i]
                rec.observe("serve.run_s", time.perf_counter() - t0)
                rec.count("serve.requests", len(pending))
                newly_failed = len(self.failed) - failed_before
                if newly_failed:
                    rec.count("serve.failed", newly_failed)
                flush_span.set(results=len(results), failed=newly_failed)
                # one stamp for every answered request, at the return: what
                # the client holds, whichever chunk it rode
                t_done = time.perf_counter()
                for chunk, _ in ready_chunks:
                    for req in chunk:
                        rec.observe("serve.request_latency_s",
                                    t_done - req.t_submit)
        return results

    def _record_done(self) -> Optional[torch.cuda.Event]:
        """An event on the current stream after a chunk's dispatch (None on
        the CPU, where the dispatch is the work)."""
        if self.device.type != "cuda":
            return None
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return done

    def _count_chunk(self, chunk: List[StencilRequest],
                     shape: Tuple[int, ...], steps: int) -> None:
        rec = self.recorder
        rec.count("serve.batches")
        rec.observe("serve.batch_occupancy", len(chunk) / self.max_batch)
        if len(chunk) > 1:
            rec.count("serve.batched_requests", len(chunk))
        if steps:
            rec.count("serve.cell_steps",
                      len(chunk) * math.prod(shape) * steps)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.stencil_serve")
    ap.add_argument("--requests", type=int, default=9)
    ap.add_argument("--grid", default="48,256",
                    help="grid shape per request, e.g. 48,256 or 8,16,128")
    ap.add_argument("--ndim", type=int, default=None, choices=(2, 3),
                    help="defaults to len(--grid)")
    ap.add_argument("--radius", type=int, default=2)
    ap.add_argument("--shape", default="star",
                    choices=("star", "box", "diamond"))
    ap.add_argument("--boundary", default="clamp",
                    choices=("clamp", "periodic", "constant"))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--variant", default=None,
                    choices=("auto", "plain", "pipelined", "temporal"),
                    help="kernel variant for every group")
    ap.add_argument("--autotune", action="store_true",
                    help="plans from the autotuner's cache (model-guided)")
    ap.add_argument("--mesh-devices", type=int, default=None,
                    help="serve batched groups on a mesh of this many "
                         "devices (REPRO_TORCH_FORCE_DEVICE_COUNT lays "
                         "them over the visible cards or the CPU)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    shape = tuple(int(p) for p in args.grid.split(",") if p)
    ndim = args.ndim or len(shape)
    program = StencilProgram(ndim=ndim, radius=args.radius,
                             shape=args.shape, boundary=args.boundary)
    server = StencilServer(max_batch=args.max_batch, device=args.device,
                           variant=args.variant,
                           use_autotune=args.autotune,
                           mesh_devices=args.mesh_devices)
    gen = torch.Generator().manual_seed(0)
    rids = [server.submit(program,
                          torch.rand(shape, generator=gen) * 2 - 1,
                          args.steps)
            for _ in range(args.requests)]
    results = server.flush()
    s = server.stats
    lat = s.latency_percentiles()
    print(f"[stencil-serve] {s.requests} requests -> {s.batches} batches "
          f"({s.batched_requests} batched) on {server.device}, "
          f"{s.compile_seconds * 1e3:.1f} ms compile + "
          f"{s.run_seconds * 1e3:.1f} ms run")
    print(f"[stencil-serve] request latency "
          f"p50={lat['p50'] * 1e3:.1f} ms p95={lat['p95'] * 1e3:.1f} ms "
          f"p99={lat['p99'] * 1e3:.1f} ms")
    for rid, why in server.failed.items():
        print(f"[stencil-serve] rid={rid} failed: {why}")
    for rid in rids[:2]:
        g = results.get(rid)
        if g is not None:
            print(f"[stencil-serve] rid={rid} out_shape={tuple(g.shape)} "
                  f"mean={float(g.mean()):+.5f}")


if __name__ == "__main__":
    main()
