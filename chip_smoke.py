#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold every kernel to its
plain PyTorch version.

    python3 chip_smoke.py        # from the repo root, one CUDA card

Phases (any failure raises, so the exit code is non-zero):

1. device: ``nvidia-smi`` name and power limit, the card's properties,
   and the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source and grid dtype, float32, bfloat16 and
   float16, all nine at once; each library's seconds);
2. the main path, ``repro_torch.stencil(...).compile(...).run(grid)``, at
   the paper's single-device workloads under each kernel variant, and the
   pre-padded superstep through ``repro_torch.backends.lower(...)``
   (see :func:`cases`), and the register queues at ``3d_r2_paper``
   (:func:`queue_cases`, the yardstick of phase 14's rows there).  Launch
   counts are zeroed just before each run and read just after, and must
   equal the schedule's; each result is compared with the port's oracle
   (``core/reference.program_nsteps``) on the same card tensors;
3. each kernel's wrapper against its plain version on the same inputs at
   the shapes the main path gives it (bit for bit; B2 per refresh, every
   wrap axis in one launch), then its time: CUDA
   events, two warm-ups, the median of 7 runs, with the card's SM clock,
   power draw and temperature sampled before and after, beside the card's
   bound, the plain version's time and a PyTorch convolution yardstick
   (``library_ms``);
4. small exact checks: 2D/3D x clamp/periodic/constant x star/box x batch
   2 x each variant against the float64 oracle on the card, the
   wrap-degenerate layout under each variant (the pre-padded kernels), the
   superstep kernels (B1, B3, B4, B5, B6, on each body they run) at a
   segment shorter than twice the halo and a column tile that does not
   divide the grid, a plan the whole-window B1 could not run, and the
   RP105 refusal of a plan no CTA tile fits;
5. RP105 at ``run`` for a step count other than the compiled one whose
   kernels fit no CTA tile, with no launch;
6. the planner: at each configuration of :data:`PLANNED`, the front door
   with ``plan="model"`` and ``plan="auto"`` (a plan cache of this run's
   own) against the pinned plan: the chosen plan, body and model ms, the
   launch counts of a planned run (zeroed before, read after), its result
   against the pinned run's, and the median wall time and MCell/s of each
   over runs taken in turns;
7. ``autotune(measure=True)`` at 2d_r4_paper and 3d_r4_paper: each
   frontier candidate's predicted and measured ms (CUDA events), then a
   second call that must come from the plan cache with no launch;
8. the serving front at paper width (:data:`SERVED`): one
   ``StencilServer(max_batch=4)`` flushes batched 2D and 3D groups, the
   periodic box unbatched and identity requests, cold (under
   ``repro_torch.obs.profile()``, so each chunk's ``run`` span gives its
   launches) and again warm; launch counts zeroed before each flush and
   read after, every result held to the front door's unbatched run under
   the server's plan at 0, then compile and run seconds, served
   Mcell-steps/s, p50/p95/p99 latency and batch occupancy;
9. the flight recorder: at each configuration of :data:`PLANNED`,
   ``plan="model"``, runs under ``repro_torch.obs.profile()`` (each
   ``run`` span's wall, device and host seconds, model accuracy and
   launches) in turns with runs with the recorder off, and the MCell/s of
   both;
10. pre-flight on the card: the ring-schedule proof
    (``lint/dataflow.verify_dataflow``, best of 20) at the four paper
    shapes of :data:`PLANNED`, and the pinned compile's wall with and
    without it; the NaN canary (``lint/sanitize.sanitize_run``) at paper
    width on the real kernels (:data:`CANARIES`: B1, B3, B4 and B2, launch
    counts zeroed before and read after), each clean and equal to the
    front door's run at 0, with its seconds and peak memory; the box with
    ``kernels.common.wrap_copies`` patched to return nothing, which both
    halves must report as RP405; and RP106 on a pinned odd-halo plan
    beside B1's time at par_time 1 and 2, and at par_time 1 on a grid
    whose pitch is aligned;
11. the mesh on one card (``REPRO_TORCH_FORCE_DEVICE_COUNT=4``, restored
    after; :data:`MESH_RUNS`): each front-door mesh run at paper width
    (2D r4 plain and batched on 2x2, 3D r4 pipelined on 2x2x1, the box
    plain on 2x1 and pipelined on 2x2) with its decomposition, the proof's
    ms at its compile, its launches by kernel and instantiation (zeroed
    before, read after), its result against the single-device front
    door's run at 0 (the first failing cell printed), its MCell/s beside
    the single device's, one exchange per superstep (CUDA events) against
    its bound, and the scatter and gather copies; each sharded
    instantiation (B1 on the queues and on the streamed kernel, B4) on a
    shard with a non-zero origin at the global edge and on an inner
    shard against its plain version at 0, timed beside the unsharded
    instantiation on the same local shape; ``DistributedStencil.
    superstep`` (B5 with shard origins); ``compile(devices=4,
    plan="model")``; ``StencilServer(mesh_devices=4)``;
12. the ``ptxas`` report of every instantiation in every dtype: no stack
    frame, the same register queues in every dtype; where the toolkit has
    ``cuobjdump``, each 16-bit instantiation's SASS counts of conversions
    between float and 16 bits, packed 16-bit pair arithmetic and float32
    arithmetic, and no conversion per tap in the fixed-tap bodies
    (:data:`SASS_CONVERSIONS`);
13. the LM serving path (:func:`lm_phase`; it reaches none of the six
    kernels, and their launch counts, zeroed before, stay 0): (a)
    gemma3-4b at full width in its own dtypes (float32 params, bfloat16
    compute), drawn on the card from a seed, with its parameter count,
    seconds and peak memory; (b) one 2048-token prompt through
    ``decode_step`` a token at a time into a 2064-long cache (every local
    layer's 1024-entry ring wraps) against ``forward`` over the prompt at
    positions 0, 1023, 1024, 1535 and 2047: max |diff| over the spread
    (standard deviation) of the forward row, both without the input
    token's entry (a random-init model's echo), at most 0.15; a second
    batch row decodes with a planted ring fault (its write slot clamped
    to the ring's last entry, so the local rings never wrap) and must read
    above 0.15 at 1535 and 2047, which shows that the limit fails a wrong
    ring; (c) ``ServeEngine(batch=4, cache_len=64)``
    serving 8 requests of prompt 16 and gen 16: tokens, seconds,
    tokens/s, the median ms of one decode step (CUDA events) beside its
    bound (the bytes one step reads at the card's HBM rate), the kernels
    and device ms of one step (``torch.profiler``) and the device's share
    of the step and of the run; (d) the same engine at reduced width in
    float32 on the card and on the CPU, every decode call's logits equal
    at atol 1e-3, rtol 1e-4, the tokens identical (the CPU path is the
    one ``tests/test_torch_lm.py`` holds to the JAX package); (e)
    starcoder2-7b at full width (gemma3 freed first): one engine run of 4
    requests at batch 4, tokens/s and decode ms against its bound; (f)
    ``examples/serve_lm_torch.py``'s ``main`` on the card (reduced rwkv6,
    10 requests of 12 + 24 tokens at batch 4): its tokens, tokens/s and
    seconds, every request served.

14. 16-bit grids (:func:`half_phase`, run before 12 and 13): the main
    path of phase 2 again with the program in bfloat16 at the paper shapes
    (:data:`HALF_CASES`: B1 on both bodies, B2, B3, B4, B5 and B6 on both
    bodies; the radius-4 stars on the register queues, as in float32) and
    in float16 at one configuration per body (the queues at radius 4
    too), and the register queues at ``3d_r2_paper``, launch counts
    zeroed before and read after (all of the dtype's library), the run
    against the port's oracle on the card at 0 (the coefficients rounded
    to the grid's dtype, as the kernels take them), each kernel against
    its plain version at 0 and timed as in phase 3 beside its bound at 2
    bytes a cell and a convolution in the grid's dtype; each front-door
    variant on the card against the CPU at 0 on one block of the grid;
    a bfloat16 mesh run (2d_r4_paper on 2x2 shards of the card) against
    the single device at 0; ``plan="model"`` at 2d_r4_paper in bfloat16
    against the pinned plan at 0, with both walls; the NaN canary on B1,
    B3, B4 and B2 in bfloat16 at paper width, clean and equal to the front
    door at 0.  The 16-bit records carry their ``dtype``.
15. the remaining LM families (:func:`families_phase`, after 13;
    :data:`FAMILIES`; the six kernels' launch counts, zeroed before, stay
    0): minicpm3-4b (MLA), llava-next-34b (the projector),
    granite-moe-3b-a800m, rwkv6-7b and musicgen-large at full width and
    depth, grok-1-314b at full width cut to 4 layers and jamba-v0.1-52b
    to one 8-layer unit (:func:`family_config`; the MoE configs at
    ``capacity_factor = num_experts / top_k``, where the forward drops
    no token).  Each family: (a) drawn on the card from a seed, its
    parameter count and peak memory (llava: its frontend embeddings
    projected and prepended); (c) ``ServeEngine(batch=4, cache_len=64)``,
    8 requests of 16 + 16 tokens, as phase 13 (c) (musicgen: the
    engine's ``ValueError`` before any step); (b) a prompt of 256 tokens
    (jamba: 512) through ``forward`` and a token at a time through
    ``decode_step`` in two rows (:func:`decode_against_forward`; granite
    and rwkv6 rebuilt in float32 compute, whose bf16 decode drifts from
    forward on a correct model): the larger of the logits' reading (as
    phase 13's) and the first layer's mixer output's at most 0.15 of the
    forward row's spread on row 0, while row 1, whose cache and state
    writes are skipped from half the prompt on, must read above it at
    three quarters and at the end (:func:`family_positions`); (d) the
    reduced config in float32 on the card against the CPU, forward and
    16 decode steps at atol 1e-3, rtol 1e-4; then a summary line per
    family and the phase's
    seconds.  A failing check is collected and the phase raises after
    the last family.

16. LM training (:func:`train_phase`, after 15; the six kernels' launch
    counts, zeroed before, stay 0): (a) ``launch.train.build_run`` of
    gemma3-4b at full width and depth with ``accum = train_accum`` (8),
    float32 params and moments, bf16 compute: its parameter count against
    the meta model's, the state's bytes (params, grads, two moments) and
    peak memory; (c) 4 steps of ``train_loop`` over ``SyntheticLM(batch
    8, seq 2048)`` (past the 1024-token local window), each synchronised:
    ce, grad_norm and lr finite, the median step after the first and
    tokens/s beside the bound of :func:`step_bound`, then one step under
    ``torch.profiler`` (busy share, kernels, the costliest); (b) the
    gradient at full width in float32 compute (:func:`grad_check`):
    ``<g, v>`` over a local, a global and a tail layer and the tied
    embedding against the central difference, within ``GRAD_GAP``, and
    above it with the global layers' attention output detached; (d)
    reduced width: an interrupted run resumed from its checkpoint equal
    to an uninterrupted one within 1e-5, and grok-1's bf16 moments
    restored bit for bit; (e) each reduced config's ``make_train_step``
    (accum 2, AdamW state at step 3) on the card against the CPU
    (:func:`step_gaps`): the loss at atol 1e-3, rtol 1e-4, each leaf's
    gradient, parameter change and moments within ``STEP_SHARE`` of the
    CPU's max in the leaf (a bf16 moment one ulp besides; a step whose
    gradient is summed in bf16, one ulp of it), and a step that left the
    state as it was, or did not write its moments back, above it; (f)
    ``examples/train_lm_torch.py``'s ``main`` on the card (starcoder2
    family, d 512, 8 layers, vocab 32768, float32; 200 steps of 8 x 128
    tokens with a checkpoint every 50): ce below 0.7 of its first value,
    its tokens/s and the checkpoints kept.

17. the LM mesh tooling on one process (:func:`mesh_tooling_phase`, after
    16; the six kernels' launch counts, zeroed before, stay 0): (a) the
    sharding dry run (``repro_torch.launch.dryrun``) of every LM cell on
    both production meshes and every stencil cell, the LM cells in
    worker processes on the host's cores (meta tensors only: the card is
    not touched): each cell's three roofline terms, the dominant one,
    ``fits_hbm`` and its seconds, the cells passed and refused; a cell
    either passes or is refused with the uneven-sharding ``ValueError``,
    any other exception fails the phase; (b) ``reshard_tree`` of
    gemma3-4b's full-width float32 parameters from a (data=2, model=2)
    local mesh to (data=4, model=1), four mesh devices on the one card
    (``REPRO_TORCH_FORCE_DEVICE_COUNT=4``, restored after): every leaf's
    ``full()`` equal to the source at 0, the seconds and peak GiB; (c) a
    checkpoint saved from the (2, 2) mesh and restored onto (4, 1)
    through ``restore(shardings=)`` at reduced width, equal at 0 (the
    15.5 GB disk copy at full width is left out); (d) ``pipeline_apply``
    over 4 stages, each one pattern unit of gemma3-4b at full width (six
    layers, ``torch.func.functional_call`` on params stacked on a stage
    axis), 8 microbatches of (1, 512, 2560) in bf16, against the units
    applied in turn (0 expected: the same kernels on the same values),
    its ms beside the sequential run's and ``bubble_fraction(8, 4)``.  A
    failing check is collected and the phase raises after its report.

18. the legacy surface and the lint tail (:func:`legacy_phase`, after
    17; :data:`LEGACY_RUNS`): ``StencilEngine.create(StencilSpec(2, 4),
    ...).run`` (B1) and ``.superstep`` (B5) at 2d_r4_paper,
    ``ops.stencil_run(pipelined=True)`` (B4) and ``StencilEngine(
    pipelined=True).superstep`` (B6) at 3d_r4_paper,
    ``ops.stencil_run(variant="temporal")`` (B3) at 2d_r4_paper and a
    periodic ``StencilSpec(2, 4)`` engine run at 16384^2 (B2), each with
    its paper plan pinned: launches zeroed before and read after, equal to
    the schedule's; the result against the front door's run with the same
    plan at 0; exactly one DeprecationWarning of the port's; the launch
    audit (``lint/artifact``) clean over its launches.  Then B1 launched
    with dst = src and a result that is a view of the grid, which the
    audit must refuse (RP204); ``check_trace_budget`` over 5 warm engine
    and front-door runs, which must read 0; the stencil examples'
    ``main`` on the card (:data:`EXAMPLE_RUNS`:
    ``examples/quickstart_torch.py --steps 16``, which must launch B1 and
    B3, and ``examples/wave3d_torch.py``, B1), launches zeroed before each
    and read after, each result against the port's oracle on the card
    (the quickstart's run at 1e-4, its temporal run against the plain one
    at ULP, its batch at 0; the wave at ULP, its energy within 1.01 of
    the pulse's) and its seconds; and ``python -m repro_torch.lint
    src/repro_torch tests/test_torch_*.py chip_smoke.py
    examples/*_torch.py`` in a process of its own, started with the phase
    and run on the host beside it, which must exit 0.  Then the phase's
    seconds beside the card's name and power limit.

The last lines are the ``{"kernels": [...]}`` record, the ``nvidia-smi``
line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

#: front door vs the port's oracle in float32: both multiply then add in
#: the same order without FMA contraction, so 0 is expected; the tolerance
#: is the repo's ULP (tests/test_padded_carry.py).  Kernels are held to
#: their plain versions at atol = rtol = 0.
ULP = dict(atol=1e-6, rtol=1e-5)
#: float32 run vs the float64 oracle (the repo's TOL).
TOL = 5e-4
#: a convolution vs the port's oracle in the grid's dtype: cuDNN sums in
#: its own order, in float32 and for a 16-bit grid rounds once per step,
#: where the oracle rounds after every multiply and add (a bfloat16 ulp
#: near 1 is 2^-7, a float16 one 2^-10, and a step of up to 25 taps
#: rounds 49 times).
LIBRARY_TOLS = {"float32": 1e-4, "bfloat16": 0.125, "float16": 0.02}
RUNS = 7


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def max_err(a, b) -> float:
    return float((a.detach().double() - b.detach().double()).abs().max())


def check_close(what: str, got, want, atol: float, rtol: float) -> float:
    import torch
    err = max_err(got, want)
    ok = torch.allclose(got.double(), want.double(), atol=atol, rtol=rtol)
    print(f"  {what}: max_abs_err={err!r} (atol {atol}, rtol {rtol})")
    if not ok:
        raise AssertionError(f"{what} disagrees: max_abs_err {err}")
    return err


def card_state() -> str:
    """SM clock, power draw and temperature, as ``nvidia-smi`` reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def median_ms(fn, runs: int = RUNS, label: str = "") -> float:
    """Median over ``runs`` of one call's device time (CUDA events), after
    two warm-up calls; the card's clock, power and temperature are printed
    before and after the window."""
    import torch
    before = card_state()
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    print(f"  card (clocks.sm, power.draw, temperature.gpu) around "
          f"{label or 'the timing'}: before {before}; after {card_state()}")
    return statistics.median(times)


def bound(bytes_moved: float, flops: float, chip):
    t_bytes = bytes_moved / chip.hbm_bytes_per_s * 1e3
    t_ops = flops / chip.peak_fp32_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def example(name: str):
    """``examples/<name>.py`` as a module, its ``main`` not run (the
    examples are scripts, not a package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(HERE, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def random_grid(shape, seed: int, dtype: str = "float32"):
    """Uniform in [-1, 1) on the card, drawn in float32 from ``seed`` and
    rounded to ``dtype``."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    grid = torch.rand(shape, generator=gen, device="cuda") * 2 - 1
    return grid.to(getattr(torch, dtype))


def cast_coeffs(prog, coeffs):
    """``coeffs`` rounded to the program's dtype, as the kernels and their
    plain versions take them (``kernels/common.grid_coeffs``): what the
    port's oracle must be given to compute the same function."""
    import torch
    import repro_torch
    dt = getattr(torch, prog.dtype)
    return repro_torch.ProgramCoeffs(coeffs.center.to(dt),
                                     coeffs.taps.to(dt))


def library_step(program, coeffs, grid, steps: int):
    """``steps`` calls of ``F.pad`` + ``F.conv2d``/``conv3d`` with the taps
    in a dense (2r+1)^d weight: the PyTorch yardstick, used nowhere in the
    port."""
    import torch
    import torch.nn.functional as F
    r = program.halo_radius
    nd = program.ndim
    k = 2 * r + 1
    weight = torch.zeros((k,) * nd, device=grid.device, dtype=grid.dtype)
    weight[(r,) * nd] = coeffs.center
    for c, off in zip(coeffs.taps, program.neighbor_taps):
        weight[tuple(o + r for o in off)] = c
    weight = weight.reshape((1, 1) + (k,) * nd)
    mode = {"clamp": "replicate", "periodic": "circular",
            "constant": "constant"}[program.boundary]
    conv = F.conv2d if nd == 2 else F.conv3d
    x = grid.reshape((1, 1) + tuple(grid.shape))
    for _ in range(steps):
        pad = F.pad(x, [r] * (2 * nd), mode=mode,
                    value=program.boundary_value if mode == "constant"
                    else None)
        x = conv(pad, weight)
    return x.reshape(grid.shape)


#: The design each kernel record names, by ``BlockPlan.body``: B1, B5 and
#: B6 on the register queues of ``csrc/queued_superstep.cu`` for stars,
#: on the streamed kernel for every other tap set; B3/B4 on the streamed
#: kernel; B2's single-launch wrap map.
DESIGNS = {"queue": "register-queued", "streamed": "streamed",
           "copy": "one-launch wrap map"}
#: The source each body is in.
BODY_SOURCES = {"queue": "queued_superstep.cu",
                "streamed": "streamed_superstep.cu"}
#: Times of the kernels the redesigned ones replaced at that shape, quoted
#: from PERF.md's kernel table (measured on NVIDIA H100 80GB HBM3,
#: 700.00 W by earlier versions of this script); printed on lines of their
#: own, never in the ``{"kernels": ...}`` record.  B2's is per refresh:
#: two launches (one per wrap axis) of 0.01969599910080433 ms.
EARLIER_MS = {
    ("temporal_superstep", "2d_r4_paper"): 77.01376342773438,
    ("temporal_superstep", "3d_r2_paper_par_time_1"): 195.2475128173828,
    ("padded_pipelined", "3d_r4_paper"): 28.526304244995117,
    ("padded_pipelined", "2d_box_periodic_pod"): 9.370240211486816,
    ("padded_superstep", "2d_r4_paper"): 6.28166389465332,
    ("padded_superstep", "3d_r4_paper"): 14.99120044708252,
    ("padded_superstep", "2d_box_periodic_pod"): 7.736576080322266,
    ("pipelined_superstep", "3d_r4_paper"): 17.478944778442383,
    ("superstep", "2d_r4_paper"): 7.307007789611816,
    ("wrap_halo", "2d_box_periodic_pod"): 2 * 0.01969599910080433,
}
#: FP32 without FMA contraction: a multiply and an add are two
#: instructions, so counted flops run at half the data sheet's FMA rate.
NO_FMA = 0.5


def cases():
    """The main-path runs, in order: the plain runs, then each new
    variant and the pre-padded superstep surface.  ``expect`` is the launch
    count of each kernel the run must make (all others 0)."""
    import dataclasses
    from repro_torch.configs import stencil2d, stencil3d
    w2 = stencil2d.workloads()
    w3 = stencil3d.workloads()
    box_cut = ("grid 16384^2 instead of 65536^2: four float32 buffers of "
               "17 GB would not fit 80 GB")
    r2 = w3["3d_r2_paper"]
    return [
        dict(name="2d_r4_paper", work=w2["2d_r4_paper"], steps=9,
             expect={"padded_superstep": 5}, check="carry"),
        dict(name="3d_r4_paper", work=w3["3d_r4_paper"], steps=3,
             expect={"padded_superstep": 3}, check="carry"),
        dict(name="2d_box_periodic_pod", work=w2["2d_box_periodic_pod"],
             grid=(16384, 16384), steps=10,
             expect={"padded_superstep": 3, "wrap_halo": 3},
             check="carry", reduced=box_cut),
        dict(name="2d_r4_paper", work=w2["2d_r4_paper"], steps=19,
             variant="temporal",
             expect={"temporal_superstep": 2, "padded_superstep": 1},
             check="temporal"),
        dict(name="3d_r2_paper", work=r2, steps=9, variant="temporal",
             expect={"temporal_superstep": 1, "padded_superstep": 1},
             check="temporal"),
        # the shape the whole-window B3 ran at, whose paper plan fitted no
        # tile (its time is in EARLIER_MS)
        dict(name="3d_r2_paper_par_time_1", work=r2, steps=9,
             variant="temporal",
             plan=dataclasses.replace(r2.plan(), par_time=1),
             expect={"temporal_superstep": 2, "padded_superstep": 1},
             check="temporal"),
        dict(name="3d_r4_paper", work=w3["3d_r4_paper"], steps=3,
             variant="pipelined", expect={"padded_pipelined": 3},
             check="pipelined"),
        dict(name="2d_box_periodic_pod", work=w2["2d_box_periodic_pod"],
             grid=(16384, 16384), steps=10, variant="pipelined",
             expect={"padded_pipelined": 3, "wrap_halo": 3},
             check="pipelined", reduced=box_cut),
        dict(name="2d_r4_paper", work=w2["2d_r4_paper"], backend="cuda",
             expect={"superstep": 1}, check="prepadded"),
        dict(name="3d_r4_paper", work=w3["3d_r4_paper"], backend="cuda",
             expect={"superstep": 1}, check="prepadded"),
        dict(name="2d_box_periodic_pod", work=w2["2d_box_periodic_pod"],
             grid=(16384, 16384), backend="cuda", expect={"superstep": 1},
             check="prepadded", reduced=box_cut),
        dict(name="3d_r4_paper", work=w3["3d_r4_paper"],
             backend="cuda-pipelined", expect={"pipelined_superstep": 1},
             check="prepadded"),
        dict(name="2d_box_periodic_pod", work=w2["2d_box_periodic_pod"],
             grid=(16384, 16384), backend="cuda-pipelined",
             expect={"pipelined_superstep": 1}, check="prepadded",
             reduced=box_cut),
    ]


def drive_main_path(case, chip):
    """One run through the user's entry point with zeroed launch counts,
    checked against the oracle; returns the counts and the state the
    kernel checks reuse."""
    import torch
    import repro_torch
    from repro_torch.backends import lower
    from repro_torch.core.reference import program_nsteps
    from repro_torch.kernels import cuda

    work = case["work"]
    prog = work.spec
    plan = case.get("plan") or work.plan()
    shape = case.get("grid", work.grid_shape)
    grid = random_grid(shape, seed=0, dtype=prog.dtype)
    if "backend" in case:
        low = lower(prog, plan, backend=case["backend"])
        steps = plan.par_time
        coeffs = low.coeffs.to(grid.device)
        run = lambda: low.superstep(grid)  # noqa: E731
        how = f"lower(backend={case['backend']!r}).superstep"
    else:
        steps = case["steps"]
        cs = repro_torch.stencil(prog).compile(
            shape, steps=steps, plan=plan, variant=case.get("variant"))
        coeffs = cs.coeffs
        run = lambda: cs.run(grid)  # noqa: E731
        how = f"compile(variant={cs.variant!r}).run"
    print(f"\n== main path: {case['name']} {how} grid={shape} steps={steps} "
          f"block={plan.block_shape} par_time={plan.par_time} "
          f"{prog.shape} r={prog.radius} {prog.boundary} {prog.dtype}")
    if "reduced" in case:
        print(f"  reduced: {case['reduced']}")
    cuda.reset_launches()
    out = run()
    torch.cuda.synchronize()
    counts = cuda.launches()
    want = {k: case["expect"].get(k, 0) for k in counts}
    print(f"  launches {counts} (expected {want}), of the {prog.dtype} "
          f"library {cuda.launches(prog.dtype)}")
    if counts != want or cuda.launches(prog.dtype) != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    if tuple(out.shape) != tuple(shape) or not bool(out.isfinite().all()) \
            or out.dtype != grid.dtype:
        raise AssertionError("output has the wrong shape, dtype or "
                             "non-finite values")
    # the oracle with the coefficients the kernels take: float32 at the
    # repo's ULP, 16 bits exact (the same roundings in the same order)
    ref = program_nsteps(prog, cast_coeffs(prog, coeffs), grid, steps)
    check_close(f"main path vs program_nsteps ({prog.dtype}, same card)",
                out, ref, **(ULP if prog.dtype == "float32"
                             else dict(atol=0.0, rtol=0.0)))
    del ref, out
    # wall time of one more run (host clock around a synchronised run)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()  # lint-ok: RP302
    wall = time.perf_counter() - t0
    cells = math.prod(shape) * steps
    print(f"  run: {wall * 1e3!r} ms, {cells / wall / 1e6!r} MCell/s, "
          f"{cells * prog.flops_per_cell / wall / 1e9!r} GFLOP/s")
    return dict(counts=counts, grid=grid, coeffs=coeffs, prog=prog,
                plan=plan, steps=steps, wall_ms=wall * 1e3)


#: library yardstick times already taken in this run, by (case, steps)
_LIBRARY_MS = {}


def library_ms(name, prog, coeffs, grid, steps):
    """The time of ``library_step`` for ``steps`` steps, checked against
    the oracle first; taken once per case name and step count."""
    import torch
    from repro_torch.core.reference import program_nsteps
    key = (name, tuple(grid.shape), steps, prog.dtype)
    if key not in _LIBRARY_MS:
        torch.backends.cudnn.allow_tf32 = False
        coeffs = cast_coeffs(prog, coeffs)
        lib = library_step(prog, coeffs, grid, steps)
        ref = program_nsteps(prog, coeffs, grid, steps)
        check_close(f"library yardstick ({steps} steps, {prog.dtype}) vs "
                    f"program_nsteps", lib, ref,
                    atol=LIBRARY_TOLS[prog.dtype], rtol=0.0)
        del lib, ref
        _LIBRARY_MS[key] = median_ms(lambda: library_step(prog, coeffs, grid,
                                                          steps))
        print(f"  library yardstick: {_LIBRARY_MS[key]!r} ms "
              f"(cudnn.allow_tf32={torch.backends.cudnn.allow_tf32})")
    return _LIBRARY_MS[key]


def record(name, kernel, source, replaces, design, state, err, ms,
           plain_ms, moved, flops, lib_ms, chip):
    b_ms, b_by = bound(moved, flops, chip)
    unit = "ms/refresh" if kernel == "wrap_halo" else "ms/launch"
    print(f"  {kernel}: {ms!r} {unit}, plain {plain_ms!r} ms, library "
          f"{lib_ms!r} ms, bound {b_ms!r} ms ({b_by}: {moved} bytes, "
          f"{flops} flop)")
    if b_by == "operations":
        print(f"  {kernel}: without FMA the same flops take at least "
              f"{flops / (chip.peak_fp32_flops * NO_FMA) * 1e3!r} ms")
    rec = dict(name=f"{kernel}@{name}", route="cuda",
               source=f"src/repro_torch/kernels/csrc/{source}",
               replaces=f"src/repro/kernels/common.py:{replaces}",
               launches=state["counts"][kernel], max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=lib_ms, design=DESIGNS[design],
               dtype=state["prog"].dtype)
    return rec


def carried(state, variant):
    """The padded carry of the case's grid in the variant's layout (ring
    refreshed for periodic) and its interior index."""
    from repro_torch.kernels import common
    prog, plan, grid = state["prog"], state["plan"], state["grid"]
    layout = common.ring_schedule(prog, plan, tuple(grid.shape),
                                  plan.par_time, variant=variant).layout
    H, n = layout.halo, tuple(grid.shape)
    interior = (Ellipsis,) + tuple(slice(H, H + s) for s in n)
    src = grid.new_zeros(layout.padded_shape)
    src[interior] = grid
    return layout, src, interior


def check_carry(case, state, chip):
    """B2 (per refresh: every wrap axis in one launch) and B1 at a plain
    run's shape."""
    import torch
    from repro_torch.kernels import common, cuda

    prog, plan, coeffs = state["prog"], state["plan"], state["coeffs"]
    layout, src, interior = carried(state, "plain")
    records = []
    name = case["name"]
    print(f"  kernels at {name}: padded {layout.padded_shape}, "
          f"ring H={layout.halo}")
    if layout.wrap_axes:
        # random values in the ring and slack, so that every copy shows
        src = random_grid(layout.padded_shape, seed=1, dtype=prog.dtype)
        src[interior] = state["grid"]
        got = src.clone()
        cuda.refresh_wrap_halo(got, layout)
        want = common.refresh_wrap_halo_plain(src.clone(), layout)
        torch.cuda.synchronize()
        err = check_close("wrap_halo vs refresh_wrap_halo_plain", got, want,
                          atol=0.0, rtol=0.0)
        del got, want
        buf = src.clone()
        ms = median_ms(lambda: cuda.refresh_wrap_halo(buf, layout),
                       label="wrap_halo")
        plain_ms = median_ms(lambda: common.refresh_wrap_halo_plain(
            buf, layout))
        del buf
        # every shell cell written once and its interior source read once
        shell = math.prod(layout.padded_shape) - math.prod(
            layout.local_shape)
        moved = 2 * plan.itemsize * shell
        print(f"  wrap_halo: one launch per refresh, "
              f"{len(cuda.wrap_boxes(layout))} boxes, {shell} shell cells")
        records.append(record(name, "wrap_halo", "wrap_halo.cu", 678,
                              "copy", state, err, ms, plain_ms, moved, 0.0,
                              None, chip))
        common.refresh_wrap_halo_plain(src, layout)
    records.append(check_padded(case, state, chip, "plain", layout, src,
                                interior))
    return records


def check_padded(case, state, chip, variant, layout=None, src=None,
                 interior=None):
    """B1, B3 or B4 against ``padded_superstep_plain`` on the case's padded
    carry (bit for bit), then timed."""
    import torch
    from repro_torch.kernels import common, cuda

    prog, plan, grid, coeffs = (state["prog"], state["plan"], state["grid"],
                                state["coeffs"])
    if layout is None:
        layout, src, interior = carried(state, variant)
        if layout.wrap_axes:
            common.refresh_wrap_halo_plain(src, layout)
        print(f"  kernels at {case['name']}: padded {layout.padded_shape}, "
              f"ring H={layout.halo}")
    kernel, launch, replaces = {
        "plain": ("padded_superstep", cuda.padded_superstep, 707),
        "temporal": ("temporal_superstep", cuda.temporal_superstep, 899),
        "pipelined": ("padded_pipelined", cuda.padded_pipelined, 785)}[variant]
    design = plan.body(kernel)
    source = BODY_SOURCES[design]
    eff = common.deep_plan(plan) if variant == "temporal" else plan
    center, taps = coeffs.center, coeffs.taps
    got = torch.zeros_like(src)
    want = torch.zeros_like(src)
    launch(src, got, center, taps, program=prog, plan=plan, layout=layout)
    common.padded_superstep_plain(src, want, center, taps, program=prog,
                                  plan=eff, layout=layout)
    torch.cuda.synchronize()
    err = check_close(f"{kernel} vs padded_superstep_plain",
                      got[interior], want[interior], atol=0.0, rtol=0.0)
    del want
    ms = median_ms(lambda: launch(src, got, center, taps, program=prog,
                                  plan=plan, layout=layout), label=kernel)
    plain_ms = median_ms(lambda: common.padded_superstep_plain(
        src, got, center, taps, program=prog, plan=eff, layout=layout))
    lib = library_ms(case["name"], prog, coeffs, grid, eff.par_time)
    cells = math.prod(grid.shape)
    moved = plan.itemsize * (math.prod(layout.padded_shape) + cells)
    flops = cells * eff.par_time * prog.flops_per_cell
    tile = cuda.pick_tile(plan, kernel, cuda.smem_optin(grid.device.index))
    print(f"  {kernel}: CTA tile {tile}, "
          f"{plan.smem_bytes_for(tile, kernel)} bytes of shared memory, "
          f"{eff.par_time} steps per launch, {DESIGNS[design]}")
    return record(case["name"], kernel, source, replaces, design, state,
                  err, ms, plain_ms, moved, flops, lib, chip)


def check_prepadded(case, state, chip):
    """B5 or B6 against ``superstep_plain`` on the case's grid padded by
    ``boundary_pad``, then timed."""
    import torch
    from repro_torch.core.blocking import round_up
    from repro_torch.core.codegen import boundary_pad
    from repro_torch.kernels import common, cuda

    prog, plan, grid, coeffs = (state["prog"], state["plan"], state["grid"],
                                state["coeffs"])
    kernel, launch, replaces = (
        ("pipelined_superstep", cuda.pipelined_superstep, 223)
        if case["backend"].endswith("-pipelined")
        else ("superstep", cuda.superstep, 181))
    design = plan.body(kernel)
    source = BODY_SOURCES[design]
    n = tuple(grid.shape)
    h = plan.halo
    rounded = tuple(round_up(s, b) for s, b in zip(n, plan.block_shape))
    padded = boundary_pad(prog, grid, [(h, r - s + h)
                                       for s, r in zip(n, rounded)])
    print(f"  kernels at {case['name']}: pre-padded {tuple(padded.shape)}")
    center, taps = coeffs.center, coeffs.taps

    def kernel_call():
        return launch(padded, center, taps, program=prog, plan=plan,
                      true_shape=n)

    def plain_call():
        return common.superstep_plain(padded, center, taps, program=prog,
                                      plan=plan, true_shape=n)

    got = kernel_call()
    want = plain_call()
    torch.cuda.synchronize()
    true = (Ellipsis,) + tuple(slice(0, s) for s in n)
    err = check_close(f"{kernel} vs superstep_plain", got[true], want[true],
                      atol=0.0, rtol=0.0)
    del got, want
    ms = median_ms(kernel_call, label=kernel)
    plain_ms = median_ms(plain_call)
    lib = library_ms(case["name"], prog, coeffs, grid, plan.par_time)
    moved = plan.itemsize * (math.prod(padded.shape) + math.prod(rounded))
    flops = math.prod(n) * plan.par_time * prog.flops_per_cell
    tile = cuda.pick_tile(plan, kernel, cuda.smem_optin(grid.device.index))
    print(f"  {kernel}: CTA tile {tile}, "
          f"{plan.smem_bytes_for(tile, kernel)} bytes of shared memory, "
          f"{DESIGNS[design]}")
    return record(case["name"], kernel, source, replaces, design, state,
                  err, ms, plain_ms, moved, flops, lib, chip)


def check_kernels(case, state, chip):
    how = case["check"]
    if how == "carry":
        return check_carry(case, state, chip)
    if how == "prepadded":
        return [check_prepadded(case, state, chip)]
    return [check_padded(case, state, chip, how)]


def refuse_rp105(prog, plan, shape, variant, steps=None):
    """The front door must refuse ``plan`` under ``variant`` at compile
    (by default for enough steps to launch one full superstep or chunk)."""
    import repro_torch
    from repro_torch.core.blocking import TEMPORAL_CHUNK
    from repro_torch.lint.diagnostics import DiagnosticError
    from repro_torch.kernels import cuda
    before = cuda.launches()
    if steps is None:
        steps = plan.par_time * TEMPORAL_CHUNK + 1
    try:
        repro_torch.stencil(prog).compile(shape, steps=steps, plan=plan,
                                          variant=variant)
    except DiagnosticError as e:
        if [d.code for d in e.diagnostics] != ["RP105"]:
            raise
        print(f"  refused as expected: {e}")
    else:
        raise AssertionError(f"{variant} plan {plan.block_shape} "
                             f"par_time={plan.par_time} r={prog.radius} "
                             f"{prog.ndim}D was not refused with RP105")
    if cuda.launches() != before:
        raise AssertionError("a refused compile launched a kernel")


def expected_launches(prog, plan, steps, variant):
    """The schedule's launch counts of a run that is not wrap-degenerate."""
    from repro_torch.core.blocking import TEMPORAL_CHUNK
    period = plan.par_time * (TEMPORAL_CHUNK if variant == "temporal"
                              else 1)
    full, rem = divmod(steps, period)
    main = {"plain": "padded_superstep", "temporal": "temporal_superstep",
            "pipelined": "padded_pipelined"}[variant]
    want = {main: full}
    if rem:
        tail = "padded_superstep" if variant == "temporal" else main
        want[tail] = want.get(tail, 0) + 1
    if prog.boundary == "periodic":
        want["wrap_halo"] = full + (1 if rem else 0)
    return want


def exact_checks():
    """Small configurations through the front door against the float64
    oracle on the card, under each variant; the wrap-degenerate layout
    under each variant; the RP105 refusals."""
    import dataclasses
    import repro_torch
    from repro_torch.configs import stencil3d
    from repro_torch.core.blocking import TEMPORAL_CHUNK
    from repro_torch.core.reference import program_nsteps
    from repro_torch.kernels import common, cuda

    print("\n== small exact checks vs the float64 oracle")
    shapes = {2: ((37, 150), (16, 128)), 3: ((20, 32, 140), (8, 16, 128))}
    configs = [(ndim, kind, 2, boundary) for ndim in (2, 3)
               for boundary in ("clamp", "periodic", "constant")
               for kind in ("star", "box")] + [(3, "box", 4, "clamp")]
    worst = 0.0
    for variant in ("plain", "pipelined", "temporal"):
        for ndim, kind, radius, boundary in configs:
            shape, block = shapes[ndim]
            prog = repro_torch.StencilProgram(
                ndim=ndim, radius=radius, shape=kind, boundary=boundary,
                boundary_value=0.25)
            # temporal in 3D: the box's rings and offset tables fit 4 fused
            # steps of radius 2 (par_time 1), not 8 nor radius 4
            par_time = 2
            if variant == "temporal" and ndim == 3 and kind == "box":
                refuse_rp105(prog, repro_torch.BlockPlan(
                    spec=prog, block_shape=block, par_time=2), shape,
                    variant)
                par_time = 1
            plan = repro_torch.BlockPlan(spec=prog, block_shape=block,
                                         par_time=par_time)
            if variant == "temporal" and ndim == 3 and radius == 4:
                refuse_rp105(prog, plan, shape, variant)
                continue
            steps = TEMPORAL_CHUNK * par_time + par_time + 1
            grid = random_grid((2,) + shape, seed=ndim)
            cs = repro_torch.stencil(prog).compile(
                shape, steps=steps, batch=2, plan=plan, variant=variant)
            cuda.reset_launches()
            out = cs.run(grid)
            counts = {k: v for k, v in cuda.launches().items() if v}
            want_counts = expected_launches(prog, plan, steps, variant)
            if counts != want_counts:
                raise AssertionError(f"launches {counts} != {want_counts}")
            c64 = repro_torch.ProgramCoeffs(cs.coeffs.center.double(),
                                            cs.coeffs.taps.double())
            want = program_nsteps(prog, c64, grid.double(), steps)
            worst = max(worst, check_close(
                f"{variant} {ndim}D {kind} r={radius} {boundary} batch 2 "
                f"steps {steps} {counts}", out, want, atol=TOL, rtol=0.0))
    print(f"  worst error vs the float64 oracle: {worst!r}")

    print("\n== wrap-degenerate periodic layout under each variant")
    prog = repro_torch.StencilProgram(ndim=3, radius=2, boundary="periodic")
    shape = (9, 18, 140)
    for variant, kernel in (("plain", "superstep"),
                            ("pipelined", "pipelined_superstep"),
                            ("temporal", "superstep")):
        par_time = 1 if variant == "temporal" else 2
        plan = repro_torch.BlockPlan(spec=prog, block_shape=(8, 16, 128),
                                     par_time=par_time)
        steps = TEMPORAL_CHUNK * par_time + par_time + 1
        if not common.ring_schedule(prog, plan, shape, steps,
                                    variant=variant).fallback:
            raise AssertionError("layout is not wrap-degenerate")
        grid = random_grid(shape, seed=0)
        cs = repro_torch.stencil(prog).compile(shape, steps=steps,
                                               plan=plan, variant=variant)
        # one pre-padded superstep per period of steps, the remainder's
        # included (temporal: per chunk, with the chunk-deep plan)
        period = par_time * (TEMPORAL_CHUNK if variant == "temporal" else 1)
        want_counts = {kernel: -(-steps // period)}
        cuda.reset_launches()
        out = cs.run(grid)
        counts = {k: v for k, v in cuda.launches().items() if v}
        if counts != want_counts:
            raise AssertionError(f"wrap-degenerate {variant} launched "
                                 f"{counts}, expected {want_counts}")
        c64 = repro_torch.ProgramCoeffs(cs.coeffs.center.double(),
                                        cs.coeffs.taps.double())
        check_close(f"wrap-degenerate {variant} steps {steps} {counts}",
                    out, program_nsteps(prog, c64, grid.double(), steps),
                    atol=TOL, rtol=0.0)

    print("\n== a plan the whole-window B1 could not run")
    work = stencil3d.workloads()["3d_r4_paper"]
    print("  3d_r4_paper under temporal, 3 steps: a B1 remainder of 3 "
          "steps, whose window fitted no tile; B1 streams it now")
    grid = random_grid(work.grid_shape, seed=0)
    cs = repro_torch.stencil(work.spec).compile(
        work.grid_shape, steps=3, plan=work.plan(), variant="temporal")
    cuda.reset_launches()
    out = cs.run(grid)
    counts = {k: v for k, v in cuda.launches().items() if v}
    if counts != {"padded_superstep": 1}:
        raise AssertionError(f"launches {counts}")
    check_close("3d_r4_paper temporal 3 steps vs program_nsteps (float32, "
                "same card)", out, program_nsteps(work.spec, cs.coeffs, grid,
                                                  3), **ULP)
    del grid, out

    print("\n== plans no CTA tile fits")
    r2 = stencil3d.workloads()["3d_r2_paper"]
    box = dataclasses.replace(r2.spec, shape="box")
    print("  3d_r2_paper's plan with box taps under temporal: 8 fused "
          "steps of radius 2, whose plane rings and offset tables fit no "
          "column tile")
    refuse_rp105(box, dataclasses.replace(r2.plan(), spec=box),
                 r2.grid_shape, "temporal", steps=9)


def plane_corners():
    """The superstep kernels at a segment shorter than twice the halo and
    a column tile that divides neither blocked axis, batch 2, against their
    plain versions (exact): B3 and B4; B1 on its register queues and on
    the streamed kernel; B5 and B6 on the queues and on the streamed
    kernel's pre-padded mode, as a shard at non-zero offsets."""
    import torch
    import repro_torch
    from repro_torch.core.codegen import boundary_pad
    from repro_torch.kernels import common, cuda

    print("\n== kernels that stream planes, at short segments and ragged "
          "column tiles")
    cases = [
        # B3: 2D star r4, par_time 2 (8 fused steps, h = 32)
        ("temporal", 2, "star", 4, "clamp", (150, 200), 2, (64,), 20, {}),
        ("temporal", 2, "box", 1, "periodic", (150, 200), 2, (96,), 5, {}),
        # B4: 3D star r4, par_time 2 (h = 8)
        ("pipelined", 3, "star", 4, "clamp", (40, 50, 150), 2, (8, 64), 5,
         {}),
        ("pipelined", 3, "diamond", 2, "constant", (21, 30, 70), 1, (4, 32),
         3, {}),
        # B1 queues: 2D star r4 at par_time 2 (h = 8), 3D star r4 and r2
        ("plain", 2, "star", 4, "clamp", (150, 200), 2, (48,), 7, {}),
        ("plain", 2, "star", 4, "constant", (150, 200), 2, (88,), 5, {}),
        ("plain", 3, "star", 4, "clamp", (40, 50, 150), 1, (12, 40), 5, {}),
        ("plain", 3, "star", 2, "periodic", (40, 50, 150), 2, (6, 56), 7,
         {}),
        # B1 on the streamed kernel: the box, a star deeper than its queues
        # (a temporal remainder of 3d_r4_paper), a diamond
        ("plain", 2, "box", 1, "periodic", (150, 200), 4, (96,), 5, {}),
        ("plain", 3, "star", 4, "clamp", (40, 50, 150), 2, (6, 24), 11, {}),
        ("plain", 3, "diamond", 2, "constant", (21, 30, 70), 2, (4, 32), 5,
         {}),
        # B5 and B6: 3D star r4 (queues); the streamed kernel's
        # pre-padded mode: a 2D box r1 at 4 steps, a 3D diamond, a 2D star
        # deeper than its queues
        ("superstep", 3, "star", 4, "clamp", (40, 50, 150), 1, (12, 40), 5,
         {}),
        ("superstep", 2, "box", 1, "constant", (150, 200), 4, (96,), 5, {}),
        ("superstep", 3, "diamond", 2, "clamp", (21, 30, 70), 2, (4, 32),
         3, {}),
        ("superstep", 2, "star", 1, "periodic", (150, 200), 5, (96,), 7,
         {}),
        ("pipelined_superstep", 3, "star", 4, "clamp", (40, 50, 150), 1,
         (12, 40), 5, {}),
        ("pipelined_superstep", 2, "box", 1, "constant", (150, 200), 4,
         (96,), 5, {}),
        ("pipelined_superstep", 3, "diamond", 2, "clamp", (21, 30, 70), 2,
         (4, 32), 3, {}),
    ]
    for variant, ndim, kind, radius, boundary, shape, par_time, tile, seg, \
            extra in cases:
        prog = repro_torch.StencilProgram(
            ndim=ndim, radius=radius, shape=kind, boundary=boundary,
            boundary_value=0.25)
        block = (16, 128) if ndim == 2 else (8, 16, 128)
        plan = repro_torch.BlockPlan(spec=prog, block_shape=block,
                                     par_time=par_time)
        coeffs = prog.default_coeffs(seed=3).to("cuda")
        h = par_time * radius * (4 if variant == "temporal" else 1)
        assert seg < 2 * h and any(n % t for n, t in zip(shape[1:], tile))
        what = (f"{variant} {ndim}D {kind} r={radius} {boundary} grid "
                f"{shape} tile {tile} segment {seg} (h {h}) {extra}")
        if variant in ("superstep", "pipelined_superstep"):
            launch = {"superstep": cuda.superstep,
                      "pipelined_superstep": cuda.pipelined_superstep}[variant]
            rounded = tuple(common.round_up(n, b) for n, b in zip(shape,
                                                                   block))
            grid = random_grid((2,) + shape, seed=5)
            padded = boundary_pad(prog, grid, [(0, 0)] + [
                (h, r - n + h) for n, r in zip(shape, rounded)]).contiguous()
            offsets, global_shape = (3,) * ndim, tuple(n + 7 for n in shape)
            got = launch(padded, coeffs.center, coeffs.taps, program=prog,
                         plan=plan, true_shape=global_shape, offsets=offsets,
                         tile=tile, segment=seg)
            want = common.superstep_plain(
                padded, coeffs.center, coeffs.taps, program=prog, plan=plan,
                true_shape=global_shape, offsets=offsets)
            torch.cuda.synchronize()
            ix = (Ellipsis,) + tuple(slice(0, n) for n in shape)
            check_close(f"{variant} ({plan.body(variant)}) {what}", got[ix],
                        want[ix], atol=0.0, rtol=0.0)
            continue
        layout = common.ring_schedule(prog, plan, shape, par_time,
                                      variant=variant).layout
        src = random_grid((2,) + layout.padded_shape, seed=5)
        if layout.wrap_axes:
            common.refresh_wrap_halo_plain(src, layout)
        kernel, launch = {
            "plain": ("padded_superstep", cuda.padded_superstep),
            "temporal": ("temporal_superstep", cuda.temporal_superstep),
            "pipelined": ("padded_pipelined", cuda.padded_pipelined)}[variant]
        got, want = torch.zeros_like(src), torch.zeros_like(src)
        launch(src, got, coeffs.center, coeffs.taps, program=prog,
               plan=plan, layout=layout, tile=tile, segment=seg, **extra)
        eff = common.deep_plan(plan) if variant == "temporal" else plan
        common.padded_superstep_plain(src, want, coeffs.center, coeffs.taps,
                                      program=prog, plan=eff, layout=layout)
        torch.cuda.synchronize()
        ix = (Ellipsis,) + tuple(slice(layout.halo, layout.halo + n)
                                 for n in shape)
        check_close(f"{kernel} {what}", got[ix], want[ix], atol=0.0,
                    rtol=0.0)


#: The planner phase's configurations: (case name, steps, the pinned
#: variant), the pinned plan being the configuration's own.  3d_r2_paper's
#: pinned run is the paper plan under temporal, as in the main path.
PLANNED = (("2d_r4_paper", 9, "plain"), ("3d_r4_paper", 3, "plain"),
           ("3d_r2_paper", 9, "temporal"),
           ("2d_box_periodic_pod", 10, "plain"))
#: Front-door runs per plan in the planner phase, taken in turns.
PLANNED_RUNS = 5


def planner_phase(cache_path):
    """``plan="model"`` and ``plan="auto"`` against the pinned plan at each
    configuration of :data:`PLANNED`: the chosen plan, its body and the
    model's ms, launch counts zeroed before and read after a planned run,
    the result against the pinned run's, and the median wall time and
    MCell/s of :data:`PLANNED_RUNS` runs of each, in turns."""
    import dataclasses
    import torch
    import repro_torch
    from repro_torch.analysis.hw import GpuChip
    from repro_torch.configs import stencil2d, stencil3d
    from repro_torch.core.blocking import CARRY_KERNELS, run_seconds
    from repro_torch.kernels import cuda
    from repro_torch.lint.verify import smem_diagnostics

    chip = GpuChip.from_device(0)
    works = {**stencil2d.workloads(), **stencil3d.workloads()}
    print("\n== the planner: plan='model' and plan='auto' against the "
          "pinned plan")
    for name, steps, variant in PLANNED:
        work = works[name]
        prog = work.spec
        shape = (16384, 16384) if name == "2d_box_periodic_pod" \
            else work.grid_shape
        grid = random_grid(shape, seed=0)
        runs = {"pinned": repro_torch.stencil(prog).compile(
            shape, steps=steps, plan=work.plan(), variant=variant)}
        if name == "3d_r2_paper":
            runs["pinned par_time 1"] = repro_torch.stencil(prog).compile(
                shape, steps=steps, variant=variant,
                plan=dataclasses.replace(work.plan(), par_time=1))
        for how in ("model", "auto"):
            runs[how] = repro_torch.stencil(prog).compile(
                shape, steps=steps, plan=how, cache_path=cache_path)
        want = runs["pinned"].run(grid)
        for how, cs in runs.items():
            plan = cs.plan
            kernel = CARRY_KERNELS[cs.variant]
            if how in ("model", "auto") and smem_diagnostics(
                    plan, cs.variant, chip):
                raise AssertionError(f"{how} plan {plan} does not fit for "
                                     f"every step count")
            cuda.reset_launches()
            out = cs.run(grid)
            torch.cuda.synchronize()
            counts = {k: v for k, v in cuda.launches().items() if v}
            expect = expected_launches(prog, plan, steps, cs.variant)
            if counts != expect:
                raise AssertionError(f"{name} {how}: launches {counts} != "
                                     f"{expect}")
            model_ms = run_seconds(plan, shape, steps, chip,
                                   cs.variant) * 1e3
            print(f"  {name} {how}: block={plan.block_shape} par_time="
                  f"{plan.par_time} variant={cs.variant} body="
                  f"{plan.body(kernel)} (CTA tile "
                  f"{cuda.pick_tile(plan, kernel, chip.smem_optin)}), "
                  f"model {model_ms!r} ms, launches {counts}")
            check_close(f"{name} {how} vs the pinned run", out, want, **ULP)
            del out
        del want
        walls = {how: [] for how in runs}
        for _ in range(PLANNED_RUNS):
            for how, cs in runs.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cs.run(grid)
                torch.cuda.synchronize()  # lint-ok: RP302
                walls[how].append(time.perf_counter() - t0)
        cells = math.prod(shape) * steps
        rates = {}
        for how, ws in walls.items():
            wall = statistics.median(ws)
            rates[how] = cells / wall / 1e6
            print(f"  {name} {how}: median wall {wall * 1e3!r} ms of "
                  f"{PLANNED_RUNS}, {rates[how]!r} MCell/s")
        for how in ("model", "auto"):
            ratio = rates[how] / rates["pinned"]
            print(f"  {name} {how} over pinned MCell/s: {ratio!r} "
                  f"({'at or above' if ratio >= 0.97 else 'below'} 0.97)")
        del grid, runs
        torch.cuda.empty_cache()


def autotune_phase(cache_path):
    """``autotune(measure=True)`` at 2d_r4_paper and 3d_r4_paper: each
    frontier candidate's predicted and measured ms, then the same call
    again, which must come from the cache and launch nothing."""
    import torch
    from repro_torch.configs import stencil2d, stencil3d
    from repro_torch.kernels import cuda
    from repro_torch.tuning import autotune

    works = {**stencil2d.workloads(), **stencil3d.workloads()}
    print("\n== autotune(measure=True): predicted against measured ms")
    for name in ("2d_r4_paper", "3d_r4_paper"):
        work = works[name]
        kw = dict(grid_shape=work.grid_shape, variant="auto", measure=True,
                  cache_path=cache_path, top_k=4, reps=3)
        tuned = autotune(work.spec, **kw)
        if tuned.from_cache or not tuned.measurements:
            raise AssertionError(f"{name}: the first autotune measured "
                                 f"nothing")
        for m in tuned.measurements:
            print(f"  {name}: {m.describe()}")
            if m.ok and m.device != torch.cuda.get_device_name(0):
                raise AssertionError(f"measured on {m.device}")
        print(f"  {name}: winner block={tuned.plan.block_shape} "
              f"par_time={tuned.plan.par_time} variant={tuned.variant}")
        cuda.reset_launches()
        again = autotune(work.spec, **kw)
        launched = sum(cuda.launches().values())
        if not again.from_cache or launched or again.plan != tuned.plan:
            raise AssertionError(f"{name}: the second autotune was not a "
                                 f"cache hit with no launch ({launched} "
                                 f"launches)")
        print(f"  {name}: second call from the cache, {launched} launches")


#: The serving phase's groups: (configuration, steps, requests); the box
#: at PERF.md's 16384^2 cut.  IDENTITY requests of 2d_r4_paper's program at
#: steps 0 ride along.
SERVED = (("2d_r4_paper", 9, 6), ("3d_r4_paper", 3, 3),
          ("2d_box_periodic_pod", 10, 1))
IDENTITY = 2
SERVE_BATCH = 4


def serve_mix():
    """The served requests as (configuration, program, grid shape, steps,
    count), the 3D chunk cut to 2 when the card's free memory cannot hold
    the flush (inputs, held results and the largest chunk's stack, padded
    pair and output, float32)."""
    import torch
    from repro_torch.configs import stencil2d, stencil3d
    works = {**stencil2d.workloads(), **stencil3d.workloads()}
    box = (16384, 16384)

    def shape_of(name):
        return box if name == "2d_box_periodic_pod" \
            else works[name].grid_shape

    mix = [(name, works[name].spec, shape_of(name), steps, n)
           for name, steps, n in SERVED]
    mix.append(("identity", works["2d_r4_paper"].spec,
                shape_of("2d_r4_paper"), 0, IDENTITY))

    def need(mix):
        held = sum(n * math.prod(shape) for _, _, shape, _, n in mix)
        chunk = max(min(n, SERVE_BATCH) * math.prod(shape)
                    for _, _, shape, steps, n in mix if steps)
        return 4 * (2 * held + 4 * chunk)

    free, total = torch.cuda.mem_get_info()
    print(f"  memory: the flush needs about {need(mix) / 1e9!r} GB, "
          f"{free / 1e9!r} GB free of {total / 1e9!r}")
    if need(mix) > free:
        mix = [m[:4] + (2,) if m[0] == "3d_r4_paper" else m for m in mix]
        print(f"  reduced: 3d_r4_paper served as a chunk of 2 instead of 3 "
              f"(the flush would need {need(mix) / 1e9!r} GB)")
    return mix


def serving_phase(smi):
    """The serving front at paper width, cold then warm (module docstring,
    phase 8)."""
    import torch
    import repro_torch
    from repro_torch import obs
    from repro_torch.kernels import cuda
    from repro_torch.launch.stencil_serve import StencilServer
    from repro_torch.tuning.cache import program_fingerprint

    print(f"\n== the serving front: StencilServer(max_batch={SERVE_BATCH}), "
          f"plan='model', at paper width")
    torch.cuda.empty_cache()
    mix = serve_mix()
    server = StencilServer(max_batch=SERVE_BATCH)
    rec = server.recorder
    for flush in ("cold", "warm"):
        subs = []
        seed = 0
        for name, prog, shape, steps, n in mix:
            for _ in range(n):
                seed += 1
                subs.append([name, prog, shape, steps,
                             random_grid(shape, seed=seed), None])
        # grids are made before the clock of any request starts
        torch.cuda.synchronize()
        for sub in subs:
            sub[5] = server.submit(sub[1], sub[4], sub[3])
        mark = {k: len(rec.samples(k)) for k in (
            "serve.compile_s", "serve.run_s", "serve.request_latency_s",
            "serve.batch_occupancy")}
        cells0 = server.stats.cell_steps
        cuda.reset_launches()
        if flush == "cold":
            with obs.profile() as prof:
                results = server.flush()
            spans = prof.spans("run")
        else:
            results = server.flush()
        torch.cuda.synchronize()
        counts = {k: v for k, v in cuda.launches().items() if v}
        if server.failed:
            raise AssertionError(f"served requests failed: {server.failed}")
        # the launches each chunk must make, in dispatch order
        chunks = []
        for name, prog, shape, steps, n in mix:
            if not steps:
                continue
            plan, backend = server._resolved[(program_fingerprint(prog),
                                              shape)]
            variant = "plain" if backend == "cuda" \
                else backend.split("-")[1]
            want = expected_launches(prog, plan, steps, variant)
            for lo in range(0, n, SERVE_BATCH):
                chunks.append((name, shape, min(n - lo, SERVE_BATCH), plan,
                               variant, want))
        total = {}
        for i, (name, shape, b, plan, variant, want) in enumerate(chunks):
            for k, v in want.items():
                total[k] = total.get(k, 0) + v
            line = (f"  {flush} chunk {name} x{b}: block={plan.block_shape} "
                    f"par_time={plan.par_time} variant={variant}, expected "
                    f"launches {want}")
            if flush == "cold":
                sp = spans[i]
                got = (tuple(sp["grid_shape"]), sp["batch"] or 1)
                if got != (shape, b) or sp["launch_delta"] != want:
                    raise AssertionError(f"chunk {i} ({name} x{b}): run span "
                                         f"{got} launched "
                                         f"{sp['launch_delta']}")
                line += (f", run span: launched {sp['launch_delta']}, wall "
                         f"{sp['wall_s']!r} s, device {sp['device_s']!r} s")
            print(line)
        print(f"  {flush} flush: launches {counts} (expected {total})")
        if counts != total:
            raise AssertionError(f"flush launches {counts} != {total}")
        # every result against the front door's unbatched run, at 0
        for name, prog, shape, steps, n in mix:
            group = [sub for sub in subs if sub[0] == name]
            if steps:
                plan, backend = server._resolved[(
                    program_fingerprint(prog), shape)]
                cs = repro_torch.stencil(prog).compile(
                    shape, steps=steps, plan=plan, backend=backend)
            for sub in group:
                got = results.pop(sub[5])
                if got.device != sub[4].device:
                    raise AssertionError("a served result left the card")
                want = cs.run(sub[4]) if steps else sub[4]
                check_close(f"{flush} served {name} rid {sub[5]} vs the "
                            f"unbatched front door", got, want, atol=0.0,
                            rtol=0.0)
                del got, want
                sub[4] = None
            torch.cuda.empty_cache()
        comp = sum(rec.samples("serve.compile_s")[mark["serve.compile_s"]:])
        run = sum(rec.samples("serve.run_s")[mark["serve.run_s"]:])
        lat = rec.samples("serve.request_latency_s")[
            mark["serve.request_latency_s"]:]
        occ = rec.samples("serve.batch_occupancy")[
            mark["serve.batch_occupancy"]:]
        cells = server.stats.cell_steps - cells0
        pct = {q: obs.percentile(lat, q) for q in (50, 95, 99)}
        print(f"  {flush} flush ({smi}): {len(subs)} requests, compile "
              f"{comp!r} s, run {run!r} s, {cells} cell-steps, served "
              f"{cells / (comp + run) / 1e6!r} Mcell-steps/s, latency p50 "
              f"{pct[50]!r} s p95 {pct[95]!r} s p99 {pct[99]!r} s, batch "
              f"occupancy {occ}")
        del results, subs
    torch.cuda.empty_cache()


def recorder_phase(smi):
    """The flight recorder at each configuration of :data:`PLANNED`
    (module docstring, phase 9)."""
    import torch
    import repro_torch
    from repro_torch import obs
    from repro_torch.configs import stencil2d, stencil3d

    works = {**stencil2d.workloads(), **stencil3d.workloads()}
    print("\n== the flight recorder: run spans timed on the card, recorder "
          "on against off")
    for name, steps, _ in PLANNED:
        work = works[name]
        prog = work.spec
        shape = (16384, 16384) if name == "2d_box_periodic_pod" \
            else work.grid_shape
        grid = random_grid(shape, seed=0)
        with obs.profile() as rec:
            cs = repro_torch.stencil(prog).compile(shape, steps=steps,
                                                   plan="model")
        (sp,) = rec.spans("compile")
        print(f"  {name} compile span: plan_source {sp['plan_source']}, "
              f"cache_hit {sp['cache_hit']}, {sp['backend']} block "
              f"{sp['block_shape']} par_time {sp['par_time']}, supersteps "
              f"{sp['supersteps']}, model {sp['model_bytes_per_superstep']} "
              f"bytes per superstep, predicted {sp['predicted_s']!r} s, "
              f"{sp['dur_s']!r} s")
        want = expected_launches(prog, cs.plan, steps, cs.variant)
        cs.run(grid)
        walls = {"on": [], "off": []}
        for _ in range(PLANNED_RUNS):
            torch.cuda.synchronize()
            with obs.profile() as rec:
                t0 = time.perf_counter()
                cs.run(grid)
                torch.cuda.synchronize()  # lint-ok: RP302
                walls["on"].append(time.perf_counter() - t0)
            (sp,) = rec.spans("run")
            print(f"  {name} run span: wall_s {sp['wall_s']!r} device_s "
                  f"{sp['device_s']!r} host_s {sp['host_s']!r} "
                  f"model_accuracy {sp['model_accuracy']!r} launch_delta "
                  f"{sp['launch_delta']}")
            if sp["launch_delta"] != want or not \
                    0 < sp["device_s"] <= sp["wall_s"]:
                raise AssertionError(f"{name}: run span {sp} (expected "
                                     f"launches {want})")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cs.run(grid)
            torch.cuda.synchronize()  # lint-ok: RP302
            walls["off"].append(time.perf_counter() - t0)
        cells = math.prod(shape) * steps
        rate = {k: cells / statistics.median(v) / 1e6
                for k, v in walls.items()}
        print(f"  {name} ({smi}): median of {PLANNED_RUNS} in turns, "
              f"recorder on {rate['on']!r} MCell/s, off {rate['off']!r} "
              f"MCell/s, on/off {rate['on'] / rate['off']!r}")
        del grid, cs
        torch.cuda.empty_cache()


#: The canary runs of the pre-flight phase: (configuration, variant,
#: steps, the launches the run must make).  Each schedule has at most four
#: full supersteps, so the canary executes the whole run.
CANARIES = (
    ("2d_r4_paper", "plain", 9, {"padded_superstep": 5}),
    ("2d_r4_paper", "temporal", 19,
     {"temporal_superstep": 2, "padded_superstep": 1}),
    ("3d_r4_paper", "pipelined", 3, {"padded_pipelined": 3}),
    ("2d_box_periodic_pod", "plain", 10,
     {"padded_superstep": 3, "wrap_halo": 3}),
    ("2d_box_periodic_pod", "pipelined", 10,
     {"padded_pipelined": 3, "wrap_halo": 3}),
)
#: The proof's budget at each shape (the reference's pre-flight budget).
PROOF_BUDGET_S = 2e-3


def preflight_phase(smi):
    """The pre-flight checks at paper width (module docstring, phase 10).
    Every check raises on failure."""
    import dataclasses
    import torch
    import repro_torch
    from repro_torch import executor
    from repro_torch.configs import stencil2d, stencil3d
    from repro_torch.kernels import common, cuda
    from repro_torch.lint import sanitize_run, verify_dataflow
    from repro_torch.lint.sanitize import canary_grid

    print(f"\n== pre-flight on the card ({smi})")
    works = {**stencil2d.workloads(), **stencil3d.workloads()}
    box = (16384, 16384)

    def shape_of(name):
        return box if name == "2d_box_periodic_pod" \
            else works[name].grid_shape

    for name, steps, variant in PLANNED:
        work = works[name]
        prog, plan, shape = work.spec, work.plan(), shape_of(name)
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            found = verify_dataflow(prog, plan, shape, steps=steps,
                                    variant=variant)
            times.append(time.perf_counter() - t0)
        if found:
            raise AssertionError(f"{name}: the proof found "
                                 f"{[d.describe() for d in found]}")
        walls = {"with": [], "without": []}
        proof = executor.check_dataflow
        for _ in range(5):
            for key in walls:
                if key == "without":
                    executor.check_dataflow = lambda *a, **k: []
                try:
                    t0 = time.perf_counter()
                    repro_torch.stencil(prog).compile(
                        shape, steps=steps, plan=plan, variant=variant)
                    walls[key].append(time.perf_counter() - t0)
                finally:
                    executor.check_dataflow = proof
        print(f"  proof at {name} ({variant}, {steps} steps, grid {shape}, "
              f"block {plan.block_shape} par_time {plan.par_time}): best of "
              f"20 {min(times) * 1e3!r} ms, median "
              f"{statistics.median(times) * 1e3!r} ms; pinned compile "
              f"median of 5 {statistics.median(walls['with']) * 1e3!r} ms "
              f"with the proof, "
              f"{statistics.median(walls['without']) * 1e3!r} ms without")
        if min(times) >= PROOF_BUDGET_S:
            raise AssertionError(f"{name}: the proof took "
                                 f"{min(times) * 1e3} ms")

    for name, variant, steps, want in CANARIES:
        work = works[name]
        prog, plan, shape = work.spec, work.plan(), shape_of(name)
        coeffs = prog.default_coeffs(0)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        cuda.reset_launches()
        t0 = time.perf_counter()
        report = sanitize_run(prog, plan, shape, steps=steps,
                              variant=variant, coeffs=coeffs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {k: v for k, v in cuda.launches().items() if v}
        peak = torch.cuda.max_memory_allocated() - base
        print(f"  canary {name} {variant} {steps} steps: "
              f"{report.describe()}; {secs!r} s, peak {peak / 2**30!r} GiB "
              f"above the {base / 2**30!r} GiB held before; launches "
              f"{counts} (expected {want})")
        full = steps // (plan.par_time * (4 if variant == "temporal" else 1))
        if not report.ok or report.fallback or counts != want or \
                report.supersteps != sum(
                    v for k, v in want.items() if k != "wrap_halo") or \
                full > 4:
            raise AssertionError(f"canary {name} {variant}: {report}")
        cs = repro_torch.stencil(prog, coeffs).compile(
            shape, steps=steps, plan=plan, variant=variant)
        grid = torch.from_numpy(canary_grid(shape)).cuda()
        check_close(f"canary {name} {variant} interior vs the front door's "
                    f"run", report.interior, cs.run(grid), atol=0.0,
                    rtol=0.0)
        del report, grid, cs
    torch.cuda.empty_cache()

    name, variant, steps = "2d_box_periodic_pod", "plain", 10
    work = works[name]
    prog, plan, shape = work.spec, work.plan(), shape_of(name)
    print(f"  seeded fault: {name} {variant} {steps} steps with "
          f"kernels.common.wrap_copies returning ()")
    wrap_copies = common.wrap_copies
    common.wrap_copies = lambda layout: ()
    try:
        cuda.reset_launches()
        report = sanitize_run(prog, plan, shape, steps=steps,
                              variant=variant)
        torch.cuda.synchronize()
        counts = {k: v for k, v in cuda.launches().items() if v}
        proof = verify_dataflow(prog, plan, shape, steps=steps,
                                variant=variant)
    finally:
        common.wrap_copies = wrap_copies
    for d in report.diagnostics:
        print(f"  canary: {d.describe()}")
    print(f"  canary launches {counts}; the proof: "
          f"{[d.code for d in proof]}")
    if [d.code for d in report.diagnostics] != ["RP405"] or \
            counts != {"padded_superstep": 1} or \
            "RP405" not in [d.code for d in proof]:
        raise AssertionError("the skipped wrap was not reported as RP405 "
                             "by both halves")
    del report

    prog = repro_torch.StencilProgram(ndim=2, radius=1, boundary="clamp")
    shape = (16384, 16384)
    odd = repro_torch.BlockPlan(spec=prog, block_shape=(1024, 1024),
                                par_time=1)
    cs = repro_torch.stencil(prog).compile(shape, steps=1, plan=odd)
    codes = [d.code for d in cs.preflight]
    print(f"  odd halo: 2D star r1 clamp {shape} par_time 1, preflight "
          f"{[d.describe() for d in cs.preflight]}")
    if "RP106" not in codes:
        raise AssertionError(f"no RP106 at an odd halo: {codes}")
    coeffs = prog.default_coeffs(0).to("cuda")
    # par_time 1 and 2 on the grid, and par_time 1 on a grid two columns
    # narrower, whose carry pitch 16384 is a multiple of 4 floats: the
    # same one step, the alignment alone changed
    aligned = (16384, 16382)
    ms = {}
    for pt, grid, block in ((1, shape, odd.block_shape),
                            (2, shape, odd.block_shape),
                            (1, aligned, aligned)):
        plan = dataclasses.replace(odd, par_time=pt, block_shape=block)
        warned = [d.code for d in repro_torch.stencil(prog).compile(
            grid, steps=pt, plan=plan).preflight]
        layout = common.ring_schedule(prog, plan, grid, pt).layout
        src = random_grid(layout.padded_shape, seed=pt)
        dst = torch.zeros_like(src)
        t = ms[(pt, grid)] = median_ms(lambda: cuda.padded_superstep(
            src, dst, coeffs.center, coeffs.taps, program=prog, plan=plan,
            layout=layout), label=f"B1 at par_time {pt}, grid {grid}")
        print(f"  B1 ({plan.body('padded_superstep')}) at par_time {pt}, "
              f"grid {grid}: pitch {layout.padded_shape[-1]} floats, "
              f"preflight {warned}, {t!r} ms per launch, "
              f"{t / pt / math.prod(grid) * 1e9!r} ns per cell-step "
              f"({smi})")
        if ("RP106" in warned) != bool(layout.padded_shape[-1] % 4):
            raise AssertionError(f"RP106 {warned} at pitch "
                                 f"{layout.padded_shape[-1]}")
        del src, dst
    per = {k: t / k[0] / math.prod(k[1]) for k, t in ms.items()}
    print(f"  RP106: per cell-step, par_time 1 over par_time 2 "
          f"{per[(1, shape)] / per[(2, shape)]!r}x; pitch 16386 over pitch "
          f"16384 at par_time 1 {per[(1, shape)] / per[(1, aligned)]!r}x")
    torch.cuda.empty_cache()


def refuse_other_step_count():
    """ROADMAP C1: a plan compiled for a step count whose kernels fit is
    refused with RP105 at ``run`` for a count whose kernels do not, with
    no launch."""
    import repro_torch
    from repro_torch.kernels import cuda
    from repro_torch.lint.diagnostics import DiagnosticError

    print("\n== RP105 for a step count other than the compiled one")
    prog = repro_torch.StencilProgram(ndim=3, radius=4, shape="diamond")
    plan = repro_torch.BlockPlan(spec=prog, block_shape=(32, 64, 704),
                                 par_time=8)
    shape = (512, 1024, 704)
    cs = repro_torch.stencil(prog).compile(shape, steps=4, plan=plan)
    grid = random_grid(shape, seed=0)
    for steps in (5, 9):
        cuda.reset_launches()
        try:
            cs.run(grid, steps=steps)
        except DiagnosticError as e:
            if [d.code for d in e.diagnostics] != ["RP105"]:
                raise
            print(f"  run(steps={steps}) refused as expected: {e}")
        else:
            raise AssertionError(f"run(steps={steps}) was not refused")
        if any(cuda.launches().values()):
            raise AssertionError("a refused run launched a kernel")
    del grid


#: The mesh runs (module docstring, phase 12): (label, configuration,
#: shards per axis, variant, steps, batch).  The box at the 16384^2 cut.
MESH_RUNS = (
    ("2d_r4_paper plain", "2d_r4_paper", (2, 2), "plain", 9, None),
    ("2d_r4_paper batched", "2d_r4_paper", (2, 2), "plain", 9, 2),
    ("3d_r4_paper pipelined", "3d_r4_paper", (2, 2, 1), "pipelined", 3,
     None),
    ("box plain", "2d_box_periodic_pod", (2, 1), "plain", 10, None),
    ("box pipelined", "2d_box_periodic_pod", (2, 2), "pipelined", 10, None),
)
MESH_DEVICES = 4
#: (record name, mesh run, instantiation counter) of the sharded
#: instantiations held to their plain versions and timed
SHARDED = (("sharded_queued", "2d_r4_paper plain",
            "padded_superstep_sharded"),
           ("sharded_streamed", "box plain", "padded_superstep_sharded"),
           ("sharded_streamed", "3d_r4_paper pipelined",
            "padded_pipelined_sharded"))


def _mesh_work(name):
    from repro_torch.configs import stencil2d, stencil3d
    work = {**stencil2d.workloads(), **stencil3d.workloads()}[name]
    shape = (16384, 16384) if name == "2d_box_periodic_pod" \
        else work.grid_shape
    return work.spec, work.plan(), shape


def mesh_launches(prog, plan, steps, variant, shards, batch):
    """The launch counts of a mesh run: every shard one sharded carry
    kernel per superstep, and a wrap refresh where a periodic axis is held
    by one shard."""
    n = math.prod(shards)
    supersteps = -(-steps // plan.par_time)
    kernel = {"plain": "padded_superstep_sharded",
              "pipelined": "padded_pipelined_sharded"}[variant]
    want = {kernel: n * supersteps}
    if prog.boundary == "periodic" and 1 in shards:
        want["wrap_halo"] = n * supersteps
    return want


def exchange_bytes(dist, exe, h, batch):
    """Bytes one exchange of ``h``-deep strips reads and writes: every
    strip a shard receives, spanning the padded extent of the other
    axes."""
    P = exe.layout.padded_shape
    total = 0
    for d in exe.sched.sharded_axes:
        others = math.prod(P) // P[d]
        for left, right in dist.neighbours[d]:
            received = (left is not None) + (right is not None)
            total += received * h * others
    return 2 * 4 * total * (batch or 1)


def timed_wall(fn):
    """Host wall seconds of one synchronised call (after one warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()  # lint-ok: RP302
    return time.perf_counter() - t0, out


def check_sharded(label, kernel, dist, state, chip):
    """The sharded instantiation of ``kernel`` on shard (1, 1[, 0]) of the
    mesh (a non-zero origin, its high sides on the global edge) and on an
    inner shard of a 3-wide mesh (no global edge), each against
    ``padded_superstep_plain`` at atol = rtol = 0; then its time beside the
    unsharded instantiation's on the same local shape."""
    import dataclasses
    import torch
    from repro_torch.kernels import common, cuda
    prog, plan, coeffs = dist.program, dist.plan, dist.coeffs_on(
        state["grid"].device)
    exe = dist.run_fn(0, 0)
    layout, local = exe.layout, exe.local
    launch, replaces = (cuda.padded_superstep, 707) if kernel.startswith(
        "padded_superstep") else (cuda.padded_pipelined, 785)
    base = kernel.replace("_sharded", "")
    body = plan.body(base)
    src = random_grid(layout.padded_shape, seed=7)
    last = max(range(dist.mesh.size), key=lambda j: sum(dist.offsets[j]))
    errs = []
    for where, offs, gshape in (
            ("edge", dist.offsets[last], dist.global_shape),
            ("inner", tuple(n for n in local), tuple(3 * n for n in local))):
        got = torch.zeros_like(src)
        want = torch.zeros_like(src)
        before = cuda.launches()[kernel]
        launch(src, got, coeffs.center, coeffs.taps, program=prog,
               plan=plan, layout=layout, offsets=offs, global_shape=gshape)
        if cuda.launches()[kernel] != before + 1:
            raise AssertionError(f"{kernel} did not count its launch")
        common.padded_superstep_plain(src, want, coeffs.center, coeffs.taps,
                                      program=prog, plan=plan, layout=layout,
                                      offsets=offs, global_shape=gshape)
        torch.cuda.synchronize()
        errs.append(check_close(
            f"{kernel} ({body}) on a shard at origin {offs} of "
            f"{gshape} ({where}) vs padded_superstep_plain",
            got[exe.interior], want[exe.interior], atol=0.0, rtol=0.0))
        del want
    offs, gshape = dist.offsets[last], dist.global_shape
    ms = median_ms(lambda: launch(src, got, coeffs.center, coeffs.taps,
                                  program=prog, plan=plan, layout=layout,
                                  offsets=offs, global_shape=gshape),
                   label=f"{kernel} sharded")
    # the unsharded instantiation on the same local shape: one device's
    # carry of that extent (origin 0, the local extent as the global one)
    one = dataclasses.replace(layout, wrap_axes=())
    unsharded_ms = median_ms(lambda: launch(src, got, coeffs.center,
                                            coeffs.taps, program=prog,
                                            plan=plan, layout=one),
                             label=f"{base} unsharded")
    plain_ms = median_ms(lambda: common.padded_superstep_plain(
        src, got, coeffs.center, coeffs.taps, program=prog, plan=plan,
        layout=layout, offsets=offs, global_shape=gshape))
    interior = src[exe.interior].contiguous()
    lib = library_ms(f"{label} shard", prog, coeffs, interior, plan.par_time)
    del interior, got
    cells = math.prod(local)
    moved = plan.itemsize * (math.prod(layout.padded_shape) + cells)
    flops = cells * plan.par_time * prog.flops_per_cell
    print(f"  {kernel}: {ms!r} ms against the unsharded instantiation's "
          f"{unsharded_ms!r} ms on the same local shape {local} "
          f"({ms / unsharded_ms!r}x)")
    rec = record(label, base, BODY_SOURCES[body], replaces, body,
                 {"counts": {base: state["counts"].get(kernel, 0)},
                  "prog": prog},
                 max(errs), ms, plain_ms, moved, flops, lib, chip)
    rec["name"] = f"{base}@{label}"
    rec["unsharded_ms"] = unsharded_ms
    rec["shard"] = list(local)
    return rec


def mesh_phase(smi, chip):
    """The mesh on one card (module docstring, phase 12)."""
    import torch
    import repro_torch
    from repro_torch.core import distributed
    from repro_torch.kernels import cuda
    from repro_torch.launch.stencil_serve import StencilServer
    from repro_torch.lint.dataflow import verify_dataflow

    env = distributed.ENV_DEVICE_COUNT
    saved = os.environ.get(env)
    os.environ[env] = str(MESH_DEVICES)
    try:
        devices = distributed.visible_devices()
        print(f"\n== the mesh: {env}={MESH_DEVICES} lays "
              f"{len(devices)} mesh devices over "
              f"{len(set(devices))} card(s) ({smi}); serialised shards on "
              f"one card, not a multi-card mesh")
        records = []
        states = {}
        torch.cuda.empty_cache()
        for label, name, shards, variant, steps, batch in MESH_RUNS:
            prog, plan, shape = _mesh_work(name)
            print(f"\n-- mesh run {label}: grid {shape}"
                  f"{'' if batch is None else f' x{batch}'}, block "
                  f"{plan.block_shape}, par_time {plan.par_time}, "
                  f"{variant}, {steps} steps, shards {shards}")
            t0 = time.perf_counter()
            cs = repro_torch.stencil(prog).compile(
                shape, steps=steps, batch=batch, devices=shards, plan=plan,
                variant=variant)
            compile_s = time.perf_counter() - t0
            proof = min(_timed(lambda: verify_dataflow(
                prog, plan, shape, steps=steps, variant=variant,
                decomp=shards)) for _ in range(20))
            print(f"  {cs!r}: {cs.describe()}, compile {compile_s * 1e3!r} "
                  f"ms, the proof (verify_dataflow(decomp=), best of 20) "
                  f"{proof * 1e3!r} ms")
            full = shape if batch is None else (batch,) + shape
            grid = random_grid(full, seed=len(states) + 1)
            want = mesh_launches(prog, plan, steps, variant, shards, batch)
            torch.cuda.synchronize()
            cuda.reset_launches()
            out = cs.run(grid)  # lint-ok: RP302
            torch.cuda.synchronize()
            counts = {k: v for k, v in cuda.launches().items() if v}
            print(f"  launches by kernel and instantiation {counts} "
                  f"(expected {want})")
            if counts != want:
                raise AssertionError(f"mesh launches {counts} != {want}")
            if tuple(out.shape) != full or not bool(out.isfinite().all()):
                raise AssertionError("mesh output has the wrong shape or "
                                     "non-finite values")
            one = repro_torch.stencil(prog).compile(
                shape, steps=steps, batch=batch, plan=plan, variant=variant)
            single = one.run(grid)
            diff = (out != single)
            if bool(diff.any()):
                first = tuple(int(i) for i in diff.nonzero()[0])
                print(f"  first failing cell {first}: mesh "
                      f"{float(out[first])!r}, single device "
                      f"{float(single[first])!r}")
            check_close("mesh run vs the single-device front door", out,
                        single, atol=0.0, rtol=0.0)
            del out, single, diff
            cells = (batch or 1) * math.prod(shape) * steps
            wall, _ = timed_wall(lambda: cs.run(grid))
            wall1, _ = timed_wall(lambda: one.run(grid))
            print(f"  mesh {cs.describe()}: {wall * 1e3!r} ms, "
                  f"{cells / wall / 1e6!r} MCell/s; single device "
                  f"{wall1 * 1e3!r} ms, {cells / wall1 / 1e6!r} MCell/s "
                  f"({smi})")
            dist = cs._dist
            exe = dist.run_fn(0, 0 if batch is None else 1)
            pairs = exe.scatter(grid)
            ex_ms = median_ms(lambda: exe.exchange(pairs, plan.halo),
                              label="exchange")
            moved = exchange_bytes(dist, exe, plan.halo, batch)
            print(f"  exchange per superstep ({plan.halo}-deep strips): "
                  f"{ex_ms!r} ms against its bound "
                  f"{moved / chip.hbm_bytes_per_s * 1e3!r} ms ({moved} "
                  f"bytes read and written over "
                  f"{chip.hbm_bytes_per_s!r} B/s on one card)")
            sc_ms = median_ms(lambda: exe.scatter(grid), label="scatter")
            ga_ms = median_ms(lambda: exe.gather(pairs, grid),
                              label="gather")
            print(f"  scatter {sc_ms!r} ms (zero fills of the padded "
                  f"pairs and the copy in), gather {ga_ms!r} ms")
            del pairs
            states[label] = dict(counts=counts, grid=grid, dist=dist)
            torch.cuda.empty_cache()
        for rec_name, label, kernel in SHARDED:
            print(f"\n-- {kernel} ({rec_name}) at the shape of the mesh run "
                  f"{label}")
            st = states[label]
            records.append(check_sharded(rec_name, kernel, st["dist"], st,
                                         chip))
            torch.cuda.empty_cache()
        superstep_record = mesh_superstep(chip)
        del states
        torch.cuda.empty_cache()
        mesh_planned()
        mesh_served(smi)
        return records + [superstep_record]
    finally:
        if saved is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = saved


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def mesh_superstep(chip):
    """``DistributedStencil.superstep`` at 2d_r4_paper on (2, 2): B5 on
    every shard with its origin (the concat form of the exchange), equal
    to the single-device pre-padded superstep at 0."""
    import torch
    import repro_torch
    from repro_torch.core import distributed
    from repro_torch.kernels import common, cuda
    prog, plan, shape = _mesh_work("2d_r4_paper")
    print(f"\n-- DistributedStencil.superstep at 2d_r4_paper, shards (2, 2)")
    mesh = distributed.make_mesh((2, 2), distributed.visible_devices())
    dist = distributed.DistributedStencil(
        prog, None, plan, mesh, distributed.Decomposition((("d0",),
                                                           ("d1",))),
        shape, _warn=False)
    grid = random_grid(shape, seed=9)
    torch.cuda.synchronize()
    cuda.reset_launches()
    out = dist.superstep(grid)
    torch.cuda.synchronize()
    counts = {k: v for k, v in cuda.launches().items() if v}
    print(f"  launches {counts} (expected {{'superstep': 4}})")
    if counts != {"superstep": 4}:
        raise AssertionError(f"superstep launches {counts}")
    c = dist.coeffs_on(grid.device)
    want = common.pad_superstep(grid, c.center, c.taps, program=prog,
                                plan=plan)
    err = check_close("mesh superstep (B5 with shard origins) vs the "
                      "single-device pre-padded superstep", out, want,
                      atol=0.0, rtol=0.0)
    del out, want
    # B5 on shard (1, 1): its block with the halo the exchange gives it
    # (the neighbours' cells inside the grid, the boundary outside)
    from repro_torch.core.codegen import boundary_pad
    j = 3
    h = plan.halo
    local = [sl.stop - sl.start for sl in dist.slices[j]]
    block = boundary_pad(prog, grid, [(h, h), (h, h)])[
        tuple(slice(o, o + n + 2 * h) for o, n in zip(
            dist.offsets[j], local))].contiguous()
    got = cuda.superstep(block, c.center, c.taps, program=prog, plan=plan,
                         true_shape=shape, offsets=dist.offsets[j])
    want = common.superstep_plain(block, c.center, c.taps, program=prog,
                                  plan=plan, true_shape=shape,
                                  offsets=dist.offsets[j])
    torch.cuda.synchronize()
    err = max(err, check_close(f"superstep on shard {j} (origin "
                               f"{dist.offsets[j]}) vs superstep_plain",
                               got, want, atol=0.0, rtol=0.0))
    ms = median_ms(lambda: cuda.superstep(
        block, c.center, c.taps, program=prog, plan=plan, true_shape=shape,
        offsets=dist.offsets[j]), label="superstep (shard)")
    plain_ms = median_ms(lambda: common.superstep_plain(
        block, c.center, c.taps, program=prog, plan=plan, true_shape=shape,
        offsets=dist.offsets[j]))
    interior = grid[dist.slices[j]].contiguous()
    lib = library_ms("2d_r4_paper shard", prog, c, interior, plan.par_time)
    cells = math.prod(interior.shape)
    moved = plan.itemsize * (block.numel() + cells)
    flops = cells * plan.par_time * prog.flops_per_cell
    body = plan.body("superstep")
    rec = record("mesh_2d_r4_paper", "superstep", BODY_SOURCES[body], 181,
                 body, {"counts": counts, "prog": prog}, err, ms, plain_ms,
                 moved, flops,
                 lib, chip)
    del got, want, block, interior, grid
    return rec


def mesh_planned():
    """``compile(devices=4, plan="model")`` at 2d_r4_paper: the planner
    picks the plan and the split; its run equals the single-device run of
    the same plan at 0."""
    import torch
    import repro_torch
    from repro_torch.kernels import cuda
    prog, _, shape = _mesh_work("2d_r4_paper")
    print(f"\n-- compile(devices={MESH_DEVICES}, plan='model') at "
          f"2d_r4_paper")
    t0 = time.perf_counter()
    cs = repro_torch.stencil(prog).compile(shape, steps=9,
                                           devices=MESH_DEVICES,
                                           plan="model")
    print(f"  chose {cs!r}: {cs.describe()}, plan block "
          f"{cs.plan.block_shape} par_time {cs.plan.par_time}, in "
          f"{(time.perf_counter() - t0) * 1e3!r} ms")
    grid = random_grid(shape, seed=12)
    cuda.reset_launches()
    out = cs.run(grid)  # lint-ok: RP302
    torch.cuda.synchronize()
    counts = {k: v for k, v in cuda.launches().items() if v}
    want = mesh_launches(prog, cs.plan, 9, cs.variant, cs.decomp, None)
    print(f"  launches {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"planned mesh launches {counts}")
    single = repro_torch.stencil(prog).compile(
        shape, steps=9, plan=cs.plan, variant=cs.variant).run(grid)
    check_close("planned mesh run vs the single-device run", out, single,
                atol=0.0, rtol=0.0)
    del out, single
    wall, _ = timed_wall(lambda: cs.run(grid))
    print(f"  planned mesh: {wall * 1e3!r} ms, "
          f"{math.prod(shape) * 9 / wall / 1e6!r} MCell/s")
    del grid
    torch.cuda.empty_cache()


def mesh_served(smi):
    """``StencilServer(mesh_devices=4)`` with two 2D requests at
    2d_r4_paper, 9 steps: one batched mesh chunk, each result equal to
    the unbatched single-device run under the server's plan at 0."""
    import torch
    import repro_torch
    from repro_torch.kernels import cuda
    from repro_torch.launch.stencil_serve import StencilServer
    prog, _, shape = _mesh_work("2d_r4_paper")
    print(f"\n-- StencilServer(mesh_devices={MESH_DEVICES}), two "
          f"2d_r4_paper requests at 9 steps")
    server = StencilServer(mesh_devices=MESH_DEVICES, max_batch=2)
    grids = [random_grid(shape, seed=20 + i) for i in range(2)]
    torch.cuda.synchronize()
    rids = [server.submit(prog, g, 9) for g in grids]
    cuda.reset_launches()
    t0 = time.perf_counter()
    out = server.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in cuda.launches().items() if v}
    if server.failed or server.mesh_fallbacks or \
            server.stats.sharded_batches != 1:
        raise AssertionError(f"mesh serving: failed {server.failed}, "
                             f"fallbacks {server.mesh_fallbacks}, "
                             f"{server.stats.sharded_batches} sharded")
    (cs,) = server._mesh_compiled.values()
    print(f"  served on {cs!r}: launches {counts}, flush "
          f"{wall * 1e3!r} ms (compile included), "
          f"{2 * math.prod(shape) * 9 / wall / 1e6!r} Mcell-steps/s "
          f"({smi})")
    one = repro_torch.stencil(prog).compile(shape, steps=9, plan=cs.plan,
                                            variant=cs.variant)
    for rid, g in zip(rids, grids):
        want = one.run(g)  # lint-ok: RP302 (not timed: the wall above is)
        check_close(f"served mesh rid {rid} vs the unbatched single-device "
                    f"run", out[rid], want, atol=0.0, rtol=0.0)
    del out, grids
    torch.cuda.empty_cache()


#: The kernels ``ptxas_report`` reads, by source: each instantiation's
#: name in the log, and how many instantiations the source has, the same
#: in every dtype (the 16-bit libraries have float32's register queues:
#: ``core/blocking.QUEUE_STEPS``).
PTXAS = {"streamed_superstep.cu": (("streamed_kernel",), 36),
         "queued_superstep.cu": (("queue_kernel",), 42),
         "wrap_halo.cu": (("wrap_halo_kernel",), 1)}
#: What a 16-bit fixed-tap instantiation (``build.sass_counts``) may have
#: besides its packed pair arithmetic: conversions between float and 16
#: bits (``cvt`` and ``widen``) outside the tap loop (the boundary value,
#: the carry's loads and ghost planes), the same at every radius (2-38),
#: and float32 arithmetic for the index division (0 or 13).  When each
#: multiply and add went through float, the same instantiations had 30-2041
#: conversions and 36-888 float32 operations.
SASS_CONVERSIONS = 40
SASS_FP32 = 16


def ptxas_report():
    """The ``-Xptxas=-v`` lines of every kernel instantiation, from the
    build's log of the library this run loaded; raises when one has a
    stack frame or an instantiation has no report.  Then, where the
    toolkit has ``cuobjdump``, each 16-bit superstep instantiation's SASS
    counts (``build.sass_counts``); raises when a fixed-tap one (every
    queue instantiation, the streamed body's stars and boxes) has no
    packed arithmetic, more than :data:`SASS_CONVERSIONS` conversions or
    more than :data:`SASS_FP32` float32 operations."""
    from repro_torch.kernels import build
    for (source, (names, count)), dtype in itertools.product(
            PTXAS.items(), build.DTYPES):
        entry = None
        found = 0
        for line in build.build_log(source, dtype).splitlines():
            if "Compiling entry function" in line:
                entry = line if any(n in line for n in names) else None
                if entry:
                    print(f"ptxas {source} ({dtype}): {entry.strip()}")
                continue
            if entry and ("stack frame" in line or "Used " in line):
                print(f"ptxas {source} ({dtype}):   {line.strip()}")
                if "stack frame" in line:
                    found += 1
                    if not line.strip().startswith("0 bytes stack frame"):
                        raise AssertionError(f"{source}: a kernel has a "
                                             f"stack frame: {line.strip()}")
        if found != count:
            raise AssertionError(f"{source} ({dtype}): ptxas reported "
                                 f"{found} instantiations, expected {count}")
    if not build.cuobjdump():
        print("sass: no cuobjdump beside nvcc, SASS counts not taken")
        return
    for source, dtype in itertools.product(
            ("queued_superstep.cu", "streamed_superstep.cu"),
            ("bfloat16", "float16")):
        funcs = build.sass_functions(build.sass(build.library_path(source,
                                                                   dtype)))
        totals = dict.fromkeys(build.SASS_CLASSES, 0)
        for name in sorted(funcs, key=build.kernel_label):
            label = build.kernel_label(name)
            counts = build.sass_counts(funcs[name])
            print(f"sass {source} ({dtype}) {label}: " + ", ".join(
                f"{k} {v}" for k, v in counts.items()))
            for k, v in counts.items():
                totals[k] += v
            fixed = label.startswith("queue_kernel<") or (
                label.startswith("streamed_kernel<")
                and not label.startswith("streamed_kernel<0,"))
            conversions = counts["cvt"] + counts["widen"]
            if fixed and (conversions > SASS_CONVERSIONS
                          or counts["fp32"] > SASS_FP32
                          or counts["packed"] == 0):
                raise AssertionError(
                    f"{source} ({dtype}) {label}: {conversions} "
                    f"conversions, {counts['fp32']} float32 and "
                    f"{counts['packed']} packed operations")
        print(f"sass {source} ({dtype}) all {len(funcs)} kernels: "
              + ", ".join(f"{k} {v}" for k, v in totals.items()))


#: Phase 13 (module docstring): the full-width models, the decode-vs-
#: prefill prompt, cache and positions; the bf16 limit on max |diff| over
#: the forward row's spread, the input token's entry left out of both (its
#: logit, ~d_model, is the random-init echo and would swamp any fault);
#: the positions where the planted ring fault must exceed it.
LM_ARCH, LM_SECOND = "gemma3-4b", "starcoder2-7b"
LM_PROMPT, LM_CACHE = 2048, 2064
LM_POSITIONS = (0, 1023, 1024, 1535, 2047)
LM_SPREAD = 0.15
LM_FAULT_POSITIONS = (1535, 2047)
#: card against CPU at reduced width, float32 (tests/test_torch_lm.py's)
LM_TOL = dict(atol=1e-3, rtol=1e-4)


def lm_step_bytes(model, caches) -> int:
    """Bytes one decode step must read: every layer weight, the head
    (the tied table) and the whole KV cache (keys, values, positions)."""
    n = sum(p.numel() * p.element_size() for p in model.layers.parameters())
    head = model.embed if model.lm_head is None else model.lm_head
    n += head.numel() * head.element_size()
    n += sum(t.numel() * t.element_size() for c in caches for t in c)
    return n


def device_busy(fn, steps: int = 3):
    """(device ms, kernels, the five costliest kernels as (name, launches,
    ms)) per call of ``fn`` from ``torch.profiler``'s kernel events; fails
    when the profiler fails or records no kernel."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise AssertionError("torch.profiler recorded no kernel: the "
                             "device's busy share is not measured")
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    busy_us = sum(us for _, us in by_name.values())
    return (busy_us / 1e3 / steps, len(kernels) / steps,
            [(name[:70], n / steps, us / 1e3 / steps)
             for name, (n, us) in top])


def lm_requests(cfg, n, prompt, gen, seed=0):
    import numpy as np
    from repro_torch.launch import serve
    rng = np.random.RandomState(seed)
    return [serve.Request(rid=i, prompt=rng.randint(0, cfg.vocab,
                                                    size=(prompt,)),
                          max_new=gen) for i in range(n)]


def lm_serve(label, model, smi, chip, requests, prompt=16, gen=16,
             batch=4, cache_len=64):
    """One engine run at full width (phase 13 (c) and (e))."""
    import torch
    from repro_torch.launch import serve

    warm = serve.ServeEngine(model, batch, cache_len)
    warm.run(lm_requests(model.cfg, 2, 4, 2, seed=1))
    engine = serve.ServeEngine(model, batch, cache_len)
    decode = engine.decode
    calls = [0]

    def counted(*args):
        calls[0] += 1
        return decode(*args)

    engine.decode = counted
    reqs = lm_requests(model.cfg, requests, prompt, gen)
    torch.cuda.synchronize()
    stats = engine.run(reqs)
    torch.cuda.synchronize()
    if stats["tokens"] != requests * gen:
        raise AssertionError(f"served {stats['tokens']} tokens, expected "
                             f"{requests * gen}")
    for r in reqs:
        if len(r.generated) != gen or not all(0 <= t < model.cfg.vocab
                                              for t in r.generated):
            raise AssertionError(f"request {r.rid} generated {r.generated}")
    print(f"  {label} {model.cfg.name} ServeEngine(batch={batch}, cache_len="
          f"{cache_len}), {requests} requests, prompt {prompt}, gen {gen}: "
          f"{stats['tokens']} tokens in {stats['seconds']!r} s, "
          f"{stats['tokens_per_s']!r} tokens/s, {calls[0]} decode calls "
          f"(prefill token by token, as the reference)")

    toks = torch.zeros((batch, 1), dtype=torch.int32, device=model.device)
    pos = torch.full((batch, 1), prompt, dtype=torch.int32,
                     device=model.device)

    def step():
        decode(engine.caches, toks, pos)

    ms = median_ms(step, label=f"{model.cfg.name} decode step")
    moved = lm_step_bytes(model, engine.caches)
    bound_ms = moved / chip.hbm_bytes_per_s * 1e3
    busy_ms, kernels, top = device_busy(step)
    print(f"  decode step (batch {batch}): {ms!r} ms (median of {RUNS} CUDA-"
          f"event windows), bound {bound_ms!r} ms ({moved / 1e9!r} GB read "
          f"at {chip.hbm_bytes_per_s / 1e12!r} TB/s), {ms / bound_ms!r}x "
          f"bound ({smi})")
    print(f"  device busy per step {busy_ms!r} ms over {kernels!r} "
          f"kernels (torch.profiler): {busy_ms / ms!r} of the step, "
          f"{busy_ms * calls[0] / (stats['seconds'] * 1e3)!r} of the "
          f"run's wall; the costliest kernels per step:")
    for name, n, k_ms in top:
        print(f"    {k_ms!r} ms over {n!r} launches: {name}")
    return {"tokens_per_s": stats["tokens_per_s"], "step_ms": ms,
            "bound_ms": bound_ms, "busy_share": busy_ms / ms,
            "kernels": kernels}


def lm_recorded_run(model, device, reqs, batch, cache_len):
    """Every decode call's logits (float64 on the host) and the tokens."""
    from repro_torch.launch import serve
    engine = serve.ServeEngine(model, batch, cache_len, device=device)
    decode, calls = engine.decode, []

    def record(*args):
        logits, caches = decode(*args)
        calls.append(logits.double().cpu())
        return logits, caches

    engine.decode = record
    engine.run(reqs)
    return calls, [r.generated for r in reqs]


def lm_phase(smi, chip):
    """The LM serving path (module docstring, phase 13)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import cuda
    from repro_torch.launch import serve
    from repro_torch.models import attention, common, transformer
    from repro_torch.runtime.trainer import make_decode_step

    print(f"\n== the LM serving path ({smi})")
    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("TF32 is on: the float32 head would not be "
                             "the reference's float32 product")
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cuda.reset_launches()

    # (a) gemma3-4b at full width, in its own dtypes
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = transformer.build(get_arch(LM_ARCH), seed=0)
    torch.cuda.synchronize()
    print(f"  (a) {LM_ARCH}: {common.param_count(model)} parameters "
          f"(param_dtype {model.cfg.param_dtype}, compute "
          f"{model.cfg.compute_dtype}: layers held as their "
          f"{model.cfg.compute_dtype} cast, embedding and final norm "
          f"{model.cfg.param_dtype}), drawn on the card in "
          f"{time.perf_counter() - t0!r} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30!r} GiB")

    # (b) decode against prefill at 2048 tokens: the rings wrap.  Row 1
    # decodes with a planted fault: its write slot clamped to the ring's
    # last entry, so its local rings never wrap (the global caches, longer
    # than the prompt, are untouched)
    cfg = model.cfg
    gen = torch.Generator(device=model.device).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (1, LM_PROMPT), generator=gen,
                           dtype=torch.int32, device=model.device)
    t0 = time.perf_counter()
    with torch.no_grad():
        want = model(prompt).logits[0, list(LM_POSITIONS), :cfg.vocab]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    caches = model.init_caches(2, LM_CACHE)
    rings = sorted({c.k.shape[1] for c in caches})
    decode = make_decode_step(model)
    tokens = prompt.expand(2, -1)
    positions = torch.arange(LM_PROMPT, dtype=torch.int32,
                             device=model.device).expand(2, -1)
    ring_slot = attention._ring_slot

    def faulty_ring_slot(step, length):
        slot = ring_slot(step, length)
        slot[1] = torch.clamp(step[1], max=length - 1)
        return slot

    got = []
    attention._ring_slot = faulty_ring_slot
    try:
        t0 = time.perf_counter()
        for t in range(LM_PROMPT):
            logits, caches = decode(caches, tokens[:, t:t + 1],
                                    positions[:, t:t + 1])
            if t in LM_POSITIONS:
                got.append(logits[:, 0, :cfg.vocab])
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    finally:
        attention._ring_slot = ring_slot
    got = torch.stack(got, dim=1)                     # (2, positions, V)
    echo = torch.zeros_like(want, dtype=torch.bool)
    echo[torch.arange(len(LM_POSITIONS)),
         prompt[0, list(LM_POSITIONS)].long()] = True
    rest = want.masked_fill(echo, float("nan"))
    spread = torch.sqrt(torch.nanmean((rest - torch.nanmean(
        rest, -1, keepdim=True)) ** 2, -1))
    diff = (got - want).abs().masked_fill(echo, 0.0).amax(-1)
    readings = (diff / spread).tolist()
    share = ((got[0] - want).abs().amax(-1) / want.abs().amax(-1)).tolist()
    print(f"  (b) {LM_PROMPT}-token prompt: forward {prefill_s!r} s; "
          f"{LM_PROMPT} decode steps into caches of {rings} (local rings "
          f"wrap) in {decode_s!r} s ({decode_s / LM_PROMPT * 1e3!r} ms a "
          f"step, batch 2: row 0 as built, row 1 with the planted ring "
          f"fault)")
    for i, p in enumerate(LM_POSITIONS):
        print(f"    position {p}: max |decode - forward| / spread of the "
              f"forward row (input token left out) = {readings[0][i]!r}, "
              f"with the ring fault {readings[1][i]!r} (spread "
              f"{spread[i].item()!r}; over max |logit| "
              f"{want[i].abs().max().item()!r}: {share[i]!r})")
    if not all(math.isfinite(v) and v <= LM_SPREAD for v in readings[0]):
        raise AssertionError(f"decode disagrees with forward: {readings[0]} "
                             f"(limit {LM_SPREAD})")
    missed = [p for i, p in enumerate(LM_POSITIONS)
              if p in LM_FAULT_POSITIONS and not readings[1][i] > LM_SPREAD]
    if missed:
        raise AssertionError(f"the limit {LM_SPREAD} passes a ring that "
                             f"never wraps at positions {missed}: "
                             f"{readings[1]}")
    del want, got, rest, caches, logits, prompt, tokens

    # (c) the serving engine at full width
    lm_serve("(c)", model, smi, chip, requests=8)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the same engine at reduced width, card against CPU, float32
    small = get_arch(LM_ARCH).reduced()
    cpu = transformer.build(small, device="cpu", seed=2)
    card = transformer.build(small, seed=2)
    card.load_state_dict(cpu.state_dict())
    runs = []
    for m, dev in ((card, None), (cpu, "cpu")):
        rng = np.random.RandomState(3)
        reqs = [serve.Request(rid=i, prompt=rng.randint(0, small.vocab,
                                                         size=(n,)),
                              max_new=g)
                for i, (n, g) in enumerate(((7, 4), (3, 6), (12, 3), (5, 5),
                                            (9, 2)))]
        runs.append(lm_recorded_run(m, dev, reqs, batch=2, cache_len=32))
    (card_calls, card_gen), (cpu_calls, cpu_gen) = runs
    if len(card_calls) != len(cpu_calls) or card_gen != cpu_gen:
        raise AssertionError(f"card and CPU engines differ: {card_gen} "
                             f"against {cpu_gen}")
    worst = max(max_err(a, b) for a, b in zip(card_calls, cpu_calls))
    for a, b in zip(card_calls, cpu_calls):
        if not torch.allclose(a, b, **LM_TOL):
            raise AssertionError(f"card logits disagree with the CPU's: "
                                 f"max_abs_err {max_err(a, b)}")
    print(f"  (d) reduced {LM_ARCH}, float32, batch 2, 5 requests: "
          f"{len(card_calls)} decode calls, card against CPU max_abs_err "
          f"{worst!r} (atol {LM_TOL['atol']}, rtol {LM_TOL['rtol']}), "
          f"tokens identical ({sum(map(len, card_gen))} generated)")
    del card, cpu

    # (e) starcoder2-7b at full width
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = transformer.build(get_arch(LM_SECOND), seed=0)
    torch.cuda.synchronize()
    print(f"  (e) {LM_SECOND}: {common.param_count(model)} parameters, "
          f"drawn in {time.perf_counter() - t0!r} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30!r} GiB")
    lm_serve("(e)", model, smi, chip, requests=4)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # (f) the user path: examples/serve_lm_torch.py (reduced rwkv6)
    t0 = time.perf_counter()
    got = example("serve_lm_torch").main([])
    torch.cuda.synchronize()
    stats, reqs = got["stats"], got["requests"]
    print(f"  (f) examples/serve_lm_torch.py: {len(reqs)} requests, "
          f"{stats['tokens']} tokens in {stats['seconds']!r} s "
          f"({stats['tokens_per_s']!r} tokens/s); the example "
          f"{time.perf_counter() - t0!r} s in all; stencil kernel launches "
          f"so far in the phase: {sum(cuda.launches().values())}")
    if stats["tokens"] != 240 or not all(r.done for r in reqs):
        raise AssertionError(f"the serving example served {stats}")
    del got, reqs

    counts = cuda.launches()
    if any(counts.values()):
        raise AssertionError(f"the LM path launched stencil kernels: "
                             f"{counts}")
    print(f"  stencil kernel launches during the LM path: {counts} (none: "
          f"the LM path reaches no pallas_call in the reference)")
    print(f"  phase 13: {time.perf_counter() - t_phase!r} s")


#: Phase 15 (module docstring): each family at full width, (name, layers
#: kept or None for all, the compute dtype of check (b) or None for the
#: config's own, the prompt that decode is held to forward over).  256
#: tokens cross RWKV's chunks of 64, 512 Mamba's chunk of 256.  In bf16
#: a correct granite and rwkv6 decode drifts from their forward by more
#: than ``LM_SPREAD`` on the card (granite's top-8 of 40 experts flips on
#: one bf16 rounding, RWKV carries the roundings through its state; see
#: PERF.md), so their check (b) runs in float32; their engine runs in
#: bf16.
FAMILIES = (("minicpm3-4b", None, None, 256),
            ("llava-next-34b", None, None, 256),
            ("granite-moe-3b-a800m", None, "float32", 256),
            ("grok-1-314b", 4, None, 256),
            ("rwkv6-7b", None, "float32", 256),
            ("jamba-v0.1-52b", 8, None, 512),
            ("musicgen-large", None, None, 256))


def family_positions(prompt: int):
    """The positions read of a prompt, the position from which row 1's
    cache and state writes are skipped (the planted fault), and the
    positions where that fault must read above ``LM_SPREAD``."""
    half, late = prompt // 2, 3 * prompt // 4
    return ((0, 63, 64, half - 1, half, late - 1, prompt - 1), half,
            (late - 1, prompt - 1))


def family_config(name, layers, compute=None):
    """The family's published config, cut to ``layers`` layers, in
    ``compute`` (None: its own compute dtype); an MoE config with
    ``capacity_factor = num_experts / top_k``, at which the forward over
    the prompt drops no token (decode never does: one token's k experts
    fit any capacity >= top_k)."""
    import dataclasses
    from repro_torch.configs import get_arch
    cfg = get_arch(name)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if compute is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    return cfg


def _written(cache, t):
    """The entries of row 1 that decode step ``t`` writes: the slot of
    position ``t`` of an attention cache (``pos`` left as written), the
    whole row of a recurrent state."""
    if hasattr(cache, "pos"):
        slot = t % cache.pos.shape[1]
        return [f[1, slot] for n, f in zip(cache._fields, cache)
                if n != "pos"]
    return [f[1] for f in cache]


def _spread_readings(got, want, echo=None):
    """max |got - want| over the spread (standard deviation) of each row
    of ``want`` (V entries), the ``echo`` entries left out of both; got
    (2, rows, V), want (rows, V).  A constant row reads 0 where ``got``
    equals it, else infinity."""
    import torch
    if echo is None:
        echo = torch.zeros_like(want, dtype=torch.bool)
    rest = want.masked_fill(echo, float("nan"))
    spread = torch.sqrt(torch.nanmean((rest - torch.nanmean(
        rest, -1, keepdim=True)) ** 2, -1))
    diff = (got - want).abs().masked_fill(echo, 0.0).amax(-1)
    # a constant row (RWKV's first output, u = 0 at init): 0 if equal
    return torch.where(spread > 0, diff / spread,
                       torch.where(diff > 0, float("inf"), 0.0))


def decode_against_forward(model, decode, prompt_len):
    """Phase 15 (b): a prompt of ``prompt_len`` tokens through ``forward``
    and, a token at a time, through ``decode`` in two batch rows, row 1
    with its cache and state writes skipped from the fault position of
    :func:`family_positions` on.  Returns each row's
    readings per position: max |decode - forward| over the forward row's
    spread, the larger of the logits' (the input token's entry left out
    of both; the largest over musicgen's codebooks) and the first layer's
    mixer output's (its attention, Mamba or RWKV output, which reads the
    cache or state before the residual stream can round it away: grok's
    embedding is scaled by sqrt(d_model))."""
    import torch
    from repro_torch.models import attention, mamba, rwkv
    cfg = model.cfg
    K = cfg.num_codebooks
    read_at, fault_from, _ = family_positions(prompt_len)
    gen = torch.Generator(device=model.device).manual_seed(1)
    shape = (1, prompt_len, K) if K > 1 else (1, prompt_len)
    prompt = torch.randint(0, cfg.vocab, shape, generator=gen,
                           dtype=torch.int32, device=model.device)
    pos_list = list(read_at)
    first = []                      # the first mixer output of each call
    mixers = ((attention, "apply_attention"), (mamba, "apply_mamba"),
              (rwkv, "apply_time_mix"))
    saved_fns = [getattr(mod, fn) for mod, fn in mixers]

    def recording(fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            if not first:
                first.append(out[0])
            return out
        return call

    for (mod, fn), orig in zip(mixers, saved_fns):
        setattr(mod, fn, recording(orig))
    try:
        with torch.no_grad():
            want = model(prompt).logits[0, pos_list, ..., :cfg.vocab]
        want_mix = first.pop()[0, pos_list]                  # (n, d)
        caches = model.init_caches(2, prompt_len + 16)
        tokens = prompt.expand(2, *prompt.shape[1:])
        positions = torch.arange(prompt_len, dtype=torch.int32,
                                 device=model.device).expand(2, -1)
        got, got_mix = [], []
        for t in range(prompt_len):
            saved = None
            if t >= fault_from:
                saved = [[f.clone() for f in _written(c, t)]
                         for c in caches]
            logits, caches = decode(caches, tokens[:, t:t + 1],
                                    positions[:, t:t + 1])
            mix = first.pop()
            if saved is not None:
                for c, fields in zip(caches, saved):
                    for f, old in zip(_written(c, t), fields):
                        f.copy_(old)
            if t in read_at:
                got.append(logits[:, 0, ..., :cfg.vocab])
                got_mix.append(mix[:, 0])
    finally:
        for (mod, fn), orig in zip(mixers, saved_fns):
            setattr(mod, fn, orig)
    got = torch.stack(got, dim=1)             # (2, positions[, K], V)
    V = want.shape[-1]
    want, got = want.reshape(-1, V), got.reshape(2, -1, V)
    echo = torch.zeros_like(want, dtype=torch.bool)
    echo[torch.arange(want.shape[0]),
         prompt[0, pos_list].reshape(-1).long()] = True
    logit_readings = _spread_readings(got, want, echo).reshape(
        2, len(pos_list), -1).amax(-1)
    mix_readings = _spread_readings(torch.stack(got_mix, dim=1).float(),
                                    want_mix.float())
    return (torch.maximum(logit_readings, mix_readings).tolist(),
            logit_readings.tolist(), mix_readings.tolist())


def families_phase(smi, chip):
    """The remaining LM families at full width (module docstring, phase
    15)."""
    import gc
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import cuda
    from repro_torch.launch import serve
    from repro_torch.models import common, transformer
    from repro_torch.runtime.trainer import make_decode_step

    print(f"\n== the remaining LM families at full width ({smi})")
    t_phase = time.perf_counter()
    cuda.reset_launches()
    failures, rows = [], []
    for name, layers, check_dtype, prompt_len in FAMILIES:
        t_family = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = family_config(name, layers)
        published = get_arch(name)

        # (a) build on the card from a seed
        t0 = time.perf_counter()
        model = transformer.build(cfg, seed=0)
        torch.cuda.synchronize()
        built = torch.cuda.max_memory_allocated() / 2**30
        print(f"  {name} (a): {cfg.n_layers} of {published.n_layers} "
              f"layers, {common.param_count(model)} parameters (param "
              f"{cfg.param_dtype}, compute {cfg.compute_dtype}), drawn on "
              f"the card in {time.perf_counter() - t0!r} s, peak memory "
              f"{built!r} GiB")
        if cfg.frontend_dim:
            fe = torch.randn((1, cfg.img_tokens, cfg.frontend_dim),
                             generator=torch.Generator(
                                 device=model.device).manual_seed(3),
                             device=model.device)
            toks = torch.zeros((1, 16), dtype=torch.int32,
                               device=model.device)
            with torch.no_grad():
                lg = model(toks, frontend_embeds=fe).logits
            ok = lg.shape == (1, cfg.img_tokens + 16, cfg.padded_vocab) \
                and bool(torch.isfinite(lg[..., :cfg.vocab]).all())
            print(f"    frontend: {cfg.img_tokens} embeddings of "
                  f"{cfg.frontend_dim} projected and prepended to 16 "
                  f"tokens: logits {tuple(lg.shape)}, finite {ok}")
            if not ok:
                failures.append(f"{name}: the frontend forward")
            del lg, fe

        # (c) the serving engine, batch 4, cache 64, 8 requests of 16 + 16
        served = None
        if cfg.num_codebooks > 1:
            try:
                serve.ServeEngine(model, 4, 64)
                failures.append(f"{name}: the engine served codebooks")
            except ValueError as e:
                print(f"  {name} (c): the engine refuses it before any step "
                      f"(ValueError: {str(e)[:90]}...)")
        else:
            served = lm_serve(f"{name} (c)", model, smi, chip, requests=8)
        peak = torch.cuda.max_memory_allocated() / 2**30

        # (b) decode against forward, with the planted fault in row 1
        if check_dtype is not None:
            del model
            gc.collect()
            torch.cuda.empty_cache()
            model = transformer.build(family_config(name, layers,
                                                    check_dtype), seed=0)
        read_at, fault_from, fault_at = family_positions(prompt_len)
        t0 = time.perf_counter()
        readings, logit_r, mix_r = decode_against_forward(
            model, make_decode_step(model), prompt_len)
        torch.cuda.synchronize()
        print(f"  {name} (b): compute {model.cfg.compute_dtype}, a "
              f"{prompt_len}-token prompt, forward and {prompt_len} decode "
              f"steps in {time.perf_counter() - t0!r} s; max |decode - "
              f"forward| / spread of the forward row, the larger of the "
              f"logits' (input token left out) and the first mixer "
              f"output's; row 0 as built, row 1 with its writes skipped "
              f"from position {fault_from}:")
        for i, p in enumerate(read_at):
            print(f"    position {p}: {readings[0][i]!r} (logits "
                  f"{logit_r[0][i]!r}, mixer {mix_r[0][i]!r}); with the "
                  f"fault {readings[1][i]!r} (logits {logit_r[1][i]!r}, "
                  f"mixer {mix_r[1][i]!r})")
        if not all(math.isfinite(v) and v <= LM_SPREAD
                   for v in readings[0]):
            failures.append(f"{name}: decode disagrees with forward: "
                            f"{readings[0]} (limit {LM_SPREAD})")
        missed = [p for i, p in enumerate(read_at)
                  if p in fault_at and not readings[1][i] > LM_SPREAD]
        if missed:
            failures.append(f"{name}: the limit {LM_SPREAD} passes skipped "
                            f"writes at positions {missed}: {readings[1]}")
        rows.append((name, cfg.n_layers, common.param_count(model), built,
                     peak, model.cfg.compute_dtype, max(readings[0]),
                     min(readings[1][i] for i, p in enumerate(read_at)
                         if p in fault_at), served))
        del model
        gc.collect()
        torch.cuda.empty_cache()

        # (d) reduced width, float32: the card against the CPU
        small = get_arch(name).reduced()
        cpu = transformer.build(small, device="cpu", seed=2)
        card = transformer.build(small, seed=2)
        card.load_state_dict(cpu.state_dict())
        g = torch.Generator().manual_seed(4)
        K = small.num_codebooks
        toks = torch.randint(0, small.vocab, (2, 32, K) if K > 1 else
                             (2, 32), generator=g, dtype=torch.int32)
        fe = torch.randn((2, small.img_tokens, small.frontend_dim),
                         generator=g) if small.frontend_dim else None
        pairs = [[m(toks.to(m.device), None if fe is None else
                    fe.to(m.device)).logits.double().cpu()
                  for m in (cpu, card)]]
        caches = [m.init_caches(2, 16) for m in (cpu, card)]
        for t in range(16):
            pos = torch.full((2, 1), t, dtype=torch.int32)
            outs = []
            for i, m in enumerate((cpu, card)):
                lg, caches[i] = m.decode_step(
                    caches[i], toks[:, t:t + 1].to(m.device),
                    pos.to(m.device))
                outs.append(lg.double().cpu())
            pairs.append(outs)
        worst = max(max_err(b, a) for a, b in pairs)
        if not all(torch.allclose(b, a, **LM_TOL) for a, b in pairs):
            failures.append(f"{name}: reduced card against CPU, "
                            f"max_abs_err {worst}")
        print(f"  {name} (d): reduced, float32, forward over 32 tokens "
              f"(llava's with its frontend) and 16 decode steps, card against CPU max_abs_err {worst!r} "
              f"(atol {LM_TOL['atol']}, rtol {LM_TOL['rtol']})")
        del cpu, card
        print(f"  {name}: {time.perf_counter() - t_family!r} s")

    print(f"  summary ({smi}): name, layers, parameters, GiB after build, "
          f"peak GiB (build and engine), compute of (b), worst decode "
          f"reading, least fault reading, tokens/s, step ms, bound ms, busy "
          f"share, kernels per step")
    for name, n, params, built, peak, dt, ok, fault, served in rows:
        tail = "no engine (codebooks)" if served is None else (
            f"{served['tokens_per_s']!r} {served['step_ms']!r} "
            f"{served['bound_ms']!r} {served['busy_share']!r} "
            f"{served['kernels']!r}")
        print(f"    {name} {n} {params} {built!r} {peak!r} {dt} {ok!r} "
              f"{fault!r} {tail}")
    counts = cuda.launches()
    if any(counts.values()):
        failures.append(f"the LM families launched stencil kernels: "
                        f"{counts}")
    print(f"  stencil kernel launches during phase 15: {counts}")
    print(f"  phase 15: {time.perf_counter() - t_phase!r} s")
    if failures:
        raise AssertionError("phase 15: " + "; ".join(failures))


#: Phase 16 (module docstring): gemma3-4b training at full width and
#: depth, 4 steps of 8 microbatches of one 2048-token sequence (past the
#: 1024-token local window).
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "gemma3-4b", 8, 2048, 4
#: bf16 dense tensor-core peak by data sheet (the bound's layer term)
BF16_PEAK = {"NVIDIA H100 SXM": 989e12, "NVIDIA H100 PCIe": 756e12}
#: (b): the step sizes of the central difference, the gap's limit (the
#: least float64-mean gap over the steps; on an H100 the planted fault
#: reads about 0.28, the float32 loss's own difference of a correct
#: gradient under 5e-3 where its rounding does not swamp the step) and
#: the layers ``v`` spans: local layer 0, the first global layer 5, tail
#: layer 30 and the tied embedding
GRAD_EPS = (3e-2, 1e-2, 3e-3, 1e-3)
GRAD_GAP = 1e-2
GRAD_LAYERS = (0, 5, 30)
#: (e): the share of a leaf's max |value| on the CPU (gradient,
#: parameter change, moment) within which the card's step must agree
#: (about twice the largest reading on an H100, jamba's parameter change
#: at 9.0e-5), and one bfloat16 ulp (relative): the slack of each
#: element of a bfloat16 moment, and the share for a step whose gradient
#: is summed in bfloat16 (grok-1's ``accum_dtype``), where a float32
#: value near a tie rounds either way
STEP_SHARE = 2e-4
BF16_SLACK = 2.0 ** -7
#: (f): examples/train_lm_torch.py's sizes (its defaults)
EXAMPLE_STEPS, EXAMPLE_SEQ, EXAMPLE_BATCH = 200, 128, 8


def train_state(model, seed, device):
    """An AdamW state at step 3 for ``model`` on ``device`` (moments in
    ``moment_dtype``, ``mu`` about 1e-3, ``nu`` positive about 1e-5),
    drawn on the CPU: from zero moments the first update turns a
    gradient's last bit near zero into a whole ±lr."""
    import torch
    from repro_torch.optim import AdamWState
    g = torch.Generator().manual_seed(seed)
    dt = getattr(torch, model.cfg.moment_dtype)
    names = [(n, p.shape) for n, p in model.named_parameters()]
    mu = {n: (torch.randn(s, generator=g) * 1e-3).to(dt).to(device)
          for n, s in names}
    nu = {n: (torch.randn(s, generator=g).abs() * 1e-5).to(dt).to(device)
          for n, s in names}
    return AdamWState(torch.tensor(3, dtype=torch.int32), mu, nu)


def step_bound(cfg, chip, tokens, seq):
    """(bound ms, its parts): the layers' bf16 matmul FLOPs (6 N tokens,
    N the layer parameters) and the attention the causal and window
    masks need (4 H D a query-key pair, forward and backward, 3x) at the
    bf16 peak, plus the tied head's float32 product (2 tokens d V, 3x)
    at the FP32 peak; the AdamW state's bytes (read params, grads and
    moments, write params and moments) at the HBM rate, for comparison."""
    import dataclasses
    from repro_torch.models import common, transformer
    model = transformer.LMModel(cfg, device="meta")
    n_layers = common.param_count(model.layers)
    n_all = common.param_count(model)
    attn = cfg.attn
    pairs = 0
    for l in cfg.pattern * cfg.units + cfg.tail:
        w = seq if l.window is None else l.window
        pairs += sum(min(i + 1, w) for i in range(seq))
    seqs = tokens // seq
    attn_flops = 3 * 4 * attn.n_heads * attn.head_dim * pairs * seqs
    layer_flops = 6 * n_layers * tokens
    head_flops = 3 * 2 * tokens * cfg.d_model * cfg.padded_vocab
    bf16 = BF16_PEAK[chip.name]
    compute_ms = ((layer_flops + attn_flops) / bf16
                  + head_flops / chip.peak_fp32_flops) * 1e3
    state_bytes = n_all * 4 * (3 + 2 * 2)   # f32 params, grads, 2 moments
    bytes_ms = state_bytes / chip.hbm_bytes_per_s * 1e3
    return max(compute_ms, bytes_ms), dict(
        layer_flops=layer_flops, attn_flops=attn_flops,
        head_flops=head_flops, compute_ms=compute_ms, bytes_ms=bytes_ms)


def step_gaps(got, want, slack):
    """Phase 16 (e): per kind (``grad``, ``delta``, ``mu``, ``nu``), the
    largest share by which a leaf of ``got`` differs from its leaf in
    ``want`` (both float64 on the CPU, by kind and parameter name), of
    that leaf's max |value| in ``want``, past each element's ``slack``
    (by kind and name; none where absent)."""
    out = {}
    for kind, leaves in want.items():
        worst = 0.0
        for n, w in leaves.items():
            err = (got[kind][n] - w).abs() - slack[kind].get(n, 0.0)
            worst = max(worst, max(err.max().item(), 0.0)
                        / max(w.abs().max().item(), 1e-30))
        out[kind] = worst
    return out


def grad_check(cfg, batch):
    """Phase 16 (b): the directional derivative ``<g, v>`` of
    ``LMModel.loss`` at float32 compute against its central difference
    at each step of ``GRAD_EPS``; ``v`` drawn from a seed over the layers
    of ``GRAD_LAYERS`` and the tied embedding, each leaf scaled by its
    rms (at least 1e-2).  The difference is taken twice: of
    ``LMModel.loss`` itself, whose float32 value (about 2500 for the
    random-init gemma3, so an ulp of 2.4e-4) swamps a small step, and of
    the same per-token float32 cross entropies (a dense model: no MoE
    term; no label ignored) averaged in float64.  The planted fault
    detaches the global layers' attention output, which changes the
    gradient and not the forward: one difference serves both.  Returns
    ({"clean": <g, v>, "fault": <g, v> with the fault}, {eps: (float32
    difference, float64-mean difference)}, loss)."""
    import dataclasses
    import torch
    from repro_torch.models import attention, transformer
    model = transformer.build(dataclasses.replace(cfg,
                                                  compute_dtype="float32"),
                              seed=0, train=True)
    batch = {k: torch.as_tensor(v).to(model.device) for k, v in batch.items()}
    names = [n for n, _ in model.named_parameters()
             if n == "embed" or any(n.startswith(f"layers.{i}.")
                                    for i in GRAD_LAYERS)]
    params = dict(model.named_parameters())
    gen = torch.Generator(device=model.device).manual_seed(7)
    v = {}
    for n in names:
        p = params[n].detach()
        scale = max(p.float().pow(2).mean().sqrt().item(), 1e-2)
        v[n] = torch.randn(p.shape, generator=gen, device=p.device) * scale
    apply = attention.apply_attention

    def detached(*args, **kwargs):
        out, cache = apply(*args, **kwargs)
        return (out.detach() if kwargs.get("window") is None else out), \
            cache

    def losses():
        """(LMModel.loss, the float64 mean of its per-token terms)."""
        total = model.loss(batch)[0].double().item()
        logp = torch.log_softmax(model(batch["tokens"]).logits, dim=-1)
        nll = -torch.gather(logp, -1, batch["labels"].long()[..., None])
        return total, nll.double().mean().item()

    gv = {}
    for case, fn in (("clean", apply), ("fault", detached)):
        for p in params.values():
            p.grad = None
        attention.apply_attention = fn
        try:
            total, _ = model.loss(batch)
            total.backward()
        finally:
            attention.apply_attention = apply
        # a leaf the fault cuts off has no gradient: 0
        gv[case] = sum((params[n].grad.double() * v[n].double()).sum().item()
                       for n in names if params[n].grad is not None)
    base = {n: params[n].detach().clone() for n in names}
    readings = {}
    with torch.no_grad():
        for eps in GRAD_EPS:
            sides = []
            for sign in (1.0, -1.0):
                for n in names:
                    params[n].copy_(base[n] + sign * eps * v[n])
                sides.append(losses())
            readings[eps] = tuple((sides[0][i] - sides[1][i]) / (2 * eps)
                                  for i in (0, 1))
        for n in names:
            params[n].copy_(base[n])
    loss = total.item()
    del model, params, base, v
    return gv, readings, loss


def card_against_cpu_steps():
    """Phase 16 (e): one ``make_train_step`` (accum 2, AdamW state at step
    3) of each reduced config on the card against the CPU from the same
    params and batch, read by :func:`step_gaps`, and the same readings of
    two planted faults: a step that left the state as it was, and one
    that did not write its moments back."""
    import torch
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import transformer
    from repro_torch.optim import AdamW, WarmupCosine
    from repro_torch.runtime.trainer import make_train_step
    worst, loss_err, planted, limits = {}, {}, {}, {}
    for name in sorted(ARCHS):
        small = get_arch(name).reduced()
        cpu = transformer.build(small, device="cpu", seed=2, train=True)
        card = transformer.build(small, seed=2, train=True)
        card.load_state_dict(cpu.state_dict())
        batch = SyntheticLM(vocab=small.vocab, seq_len=32, global_batch=4,
                            seed=5, num_codebooks=small.num_codebooks,
                            frontend=(small.img_tokens, small.frontend_dim)
                            if small.frontend_dim else None).batch(0)
        outs = []
        for m in (cpu, card):
            b = {k: torch.as_tensor(v).to(m.device) for k, v in batch.items()}
            total, _ = m.loss(b)
            total.backward()
            grads = {k: p.grad.double().cpu()
                     for k, p in m.named_parameters()}
            before = {k: p.detach().double().cpu()
                      for k, p in m.named_parameters()}
            state = train_state(m, 6, m.device)
            moments = {k: {n: t.double().cpu() for n, t in
                           getattr(state, k).items()} for k in ("mu", "nu")}
            opt = AdamW(schedule=WarmupCosine(peak_lr=1e-3, warmup_steps=2,
                                              total_steps=10),
                        moment_dtype=small.moment_dtype)
            state = make_train_step(m, opt, accum=2)(state, None, b)[0]
            leaves = {"grad": grads,
                      "delta": {k: p.detach().double().cpu() - before[k]
                                for k, p in m.named_parameters()},
                      "mu": {n: t.double().cpu()
                             for n, t in state.mu.items()},
                      "nu": {n: t.double().cpu()
                             for n, t in state.nu.items()}}
            outs.append((total.detach().double().cpu(), leaves, moments))
        (loss_cpu, want, moments), (loss, got, _) = outs
        slack = {"grad": {}, "delta": {}, **{
            k: {n: BF16_SLACK * want[k][n].abs()
                for n, t in getattr(state, k).items()
                if t.dtype == torch.bfloat16} for k in ("mu", "nu")}}
        stepped = BF16_SLACK if small.accum_dtype == "bfloat16" \
            else STEP_SHARE
        limits[name] = {"grad": STEP_SHARE, "delta": stepped, "mu": stepped,
                        "nu": stepped}

        def over(gaps):
            """The largest reading as a multiple of its limit."""
            return max(gaps[k] / limits[name][k] for k in gaps)

        loss_err[name] = max_err(loss, loss_cpu)
        worst[name] = step_gaps(got, want, slack)
        zero = {n: 0.0 * t for n, t in want["delta"].items()}
        planted[name] = min(
            over(step_gaps(dict(got, **fault), want, slack))
            for fault in ({"delta": zero, **moments}, moments))
        if not torch.allclose(loss, loss_cpu, **LM_TOL):
            raise AssertionError(f"{name}: the card's loss differs from "
                                 f"the CPU's by {loss_err[name]}")
        if not over(worst[name]) <= 1.0:
            raise AssertionError(f"{name}: the card's train step differs "
                                 f"from the CPU's by {worst[name]} of the "
                                 f"leaves' max (limits {limits[name]})")
        if not planted[name] > 1.0:
            raise AssertionError(f"{name}: the limits {limits[name]} pass a "
                                 f"step that wrote no state back: "
                                 f"{planted[name]} of them")
    print(f"  (e) reduced, float32, one make_train_step(accum=2) from the "
          f"same params, AdamW state (step 3) and batch, card against CPU: "
          f"loss max_abs_err {loss_err} (atol {LM_TOL['atol']}, rtol "
          f"{LM_TOL['rtol']}); the largest share of a leaf's max by kind "
          f"against its limit (bf16 moments {BF16_SLACK} of each element "
          f"besides):")
    for name, gaps in worst.items():
        print(f"    {name}: {gaps} (limits {limits[name]}); the state left "
              f"as it was or the moments not written back: at least "
              f"{planted[name]!r} times the limit")


def train_phase(smi, chip):
    """LM training on the card (module docstring, phase 16)."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import cuda
    from repro_torch.launch import train
    from repro_torch.models import common, transformer

    print(f"\n== LM training ({smi})")
    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("TF32 is on: the float32 head would not be "
                             "the reference's float32 product")
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cuda.reset_launches()

    # (a) build_run at full width and depth, accum = train_accum
    cfg = get_arch(TRAIN_ARCH)
    counted = common.param_count(transformer.LMModel(cfg, device="meta"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train.build_run(cfg, steps=TRAIN_STEPS, accum=cfg.train_accum,
                          seed=0)
    torch.cuda.synchronize()
    n = common.param_count(run.model)
    if n != counted:
        raise AssertionError(f"{n} parameters, the meta model has {counted}")
    state_bytes = sum(2 * p.numel() * p.element_size()
                      for p in run.params.values())
    state_bytes += sum(t.numel() * t.element_size()
                       for m in (run.opt_state.mu, run.opt_state.nu)
                       for t in m.values())
    print(f"  (a) {cfg.name}: build_run(accum={cfg.train_accum}) in "
          f"{time.perf_counter() - t0!r} s: {n} parameters "
          f"({cfg.n_layers} layers, d {cfg.d_model}, {cfg.padded_vocab}-"
          f"entry tied head; param {cfg.param_dtype}, moments "
          f"{cfg.moment_dtype}, compute {cfg.compute_dtype}, remat "
          f"{cfg.remat}); params, grads and two moments "
          f"{state_bytes / 1e9!r} GB; peak memory after build "
          f"{torch.cuda.max_memory_allocated() / 2**30!r} GiB")

    # (c) 4 steps of train_loop, each synchronised and timed
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                       global_batch=TRAIN_BATCH, seed=0)
    step_fn, times, seen = run.train_step, [], []

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        seen.append({k: float(v) for k, v in out[2].items()})
        return out

    run.train_step = timed
    train.train_loop(run, data, TRAIN_STEPS, log_every=1, quiet=True)
    run.train_step = step_fn
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, (sec, m) in enumerate(zip(times, seen)):
        print(f"    step {i}: {sec!r} s, ce {m['ce']!r}, grad_norm "
              f"{m['grad_norm']!r}, lr {m['lr']!r}, tokens {m['tokens']!r}")
        if not all(math.isfinite(m[k]) for k in ("ce", "grad_norm", "lr")):
            raise AssertionError(f"step {i}: metrics not finite: {m}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = statistics.median(times[1:])
    bound_ms, parts = step_bound(cfg, chip, tokens, TRAIN_SEQ)
    print(f"  (c) {TRAIN_STEPS} steps of train_loop over SyntheticLM(batch "
          f"{TRAIN_BATCH}, seq {TRAIN_SEQ}), {cfg.train_accum} microbatches "
          f"a step: step {step_s * 1e3!r} ms (median of steps 1-"
          f"{TRAIN_STEPS - 1}, synchronised), {tokens / step_s!r} tokens/s; "
          f"bound {bound_ms!r} ms (layers {parts['layer_flops']!r} + "
          f"attention {parts['attn_flops']!r} FLOP at "
          f"{BF16_PEAK[chip.name] / 1e12!r} TFLOP/s bf16, head "
          f"{parts['head_flops']!r} FLOP at "
          f"{chip.peak_fp32_flops / 1e12!r} TFLOP/s fp32; the AdamW "
          f"state's bytes {parts['bytes_ms']!r} ms), "
          f"{step_s * 1e3 / bound_ms!r}x bound; peak memory {peak!r} GiB "
          f"({smi})")
    batch = {k: torch.as_tensor(v).to(run.device)
             for k, v in data.batch(TRAIN_STEPS).items()}

    def one_step():
        run.opt_state, run.comp_error, _ = run.train_step(
            run.opt_state, run.comp_error, batch)

    busy_ms, kernels, top = device_busy(one_step, steps=1)
    print(f"  device busy over one step {busy_ms!r} ms over {kernels!r} "
          f"kernels (torch.profiler): {busy_ms / (step_s * 1e3)!r} of the "
          f"step; the costliest kernels:")
    for name, k, k_ms in top:
        print(f"    {k_ms!r} ms over {k!r} launches: {name}")
    del run, batch, step_fn, timed
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the gradient at full width in float32 compute, and a planted
    # fault (the global layers' attention output detached)
    one = {k: v[:1] for k, v in data.batch(0).items()}
    t0 = time.perf_counter()
    gv, readings, loss = grad_check(cfg, one)
    gc.collect()
    torch.cuda.empty_cache()

    def gaps(case, i):
        return [abs(r[i] - gv[case]) / abs(gv[case])
                for r in readings.values()]

    gap, fault_gap = min(gaps("clean", 1)), min(gaps("fault", 1))
    print(f"  (b) one microbatch (1 x {TRAIN_SEQ}) at compute float32, loss "
          f"{loss!r}: <g, v> over layers {GRAD_LAYERS} and the embedding "
          f"{gv['clean']!r}; with the global layers' attention output "
          f"detached {gv['fault']!r}; in {time.perf_counter() - t0!r} s; "
          f"the central difference of LMModel.loss (float32) and of its "
          f"per-token terms' float64 mean, gap |difference - <g, v>| / "
          f"|<g, v>|:")
    for (eps, (fd32, fd64)), r32, r64, f32, f64 in zip(
            readings.items(), gaps("clean", 0), gaps("clean", 1),
            gaps("fault", 0), gaps("fault", 1)):
        print(f"    eps {eps}: float32 {fd32!r} (gap {r32!r}), float64 mean "
              f"{fd64!r} (gap {r64!r}); with the fault: gaps {f32!r}, "
              f"{f64!r}")
    print(f"    least float64-mean gap {gap!r} (limit {GRAD_GAP}), with "
          f"the fault {fault_gap!r}")
    if not gap <= GRAD_GAP:
        raise AssertionError(f"the gradient disagrees with the loss: gap "
                             f"{gap} > {GRAD_GAP}")
    if not fault_gap > GRAD_GAP:
        raise AssertionError(f"the limit {GRAD_GAP} passes a detached "
                             f"attention output: gap {fault_gap}")

    # (d) checkpoint and resume on the card, reduced width
    small = dataclasses.replace(get_arch("starcoder2-7b").reduced(
        d_model=64, vocab=128), n_layers=2)
    stream = SyntheticLM(vocab=small.vocab, seq_len=16, global_batch=4,
                         seed=2)
    kw = dict(steps=30, lr=1e-3, seed=3)
    with tempfile.TemporaryDirectory() as tmp:
        run_a = train.build_run(small, **kw)
        train.train_loop(run_a, stream, 30, quiet=True)
        run_b = train.build_run(small, ckpt_dir=tmp, **kw)
        train.train_loop(run_b, stream, 15, checkpoint_every=5, quiet=True)
        run_c = train.build_run(small, ckpt_dir=tmp, **kw)
        train.train_loop(run_c, stream, 30, checkpoint_every=50, quiet=True)
        resumed = max(max_err(run_c.params[k], p)
                      for k, p in run_a.params.items())
    if not resumed <= 1e-5:
        raise AssertionError(f"resumed run differs by {resumed}")
    grok = get_arch("grok-1-314b").reduced()
    with tempfile.TemporaryDirectory() as tmp:
        run_g = train.build_run(grok, steps=2, ckpt_dir=tmp)
        train.train_loop(run_g, SyntheticLM(vocab=grok.vocab, seq_len=16,
                                            global_batch=2, seed=1), 1,
                         quiet=True)
        fresh = train.build_run(grok, steps=2, seed=9)
        fresh.load_state_tree(run_g.ckpt.restore(1, fresh.state_tree()))
    unequal = [n for a, b in ((run_g.params, fresh.params),
                              (run_g.opt_state.mu, fresh.opt_state.mu),
                              (run_g.opt_state.nu, fresh.opt_state.nu))
               for n, t in a.items()
               if b[n].dtype != t.dtype or not torch.equal(
                   b[n].view(torch.int16) if t.dtype == torch.bfloat16
                   else b[n], t.view(torch.int16)
                   if t.dtype == torch.bfloat16 else t)]
    if unequal:
        raise AssertionError(f"restored leaves differ: {unequal[:5]}")
    print(f"  (d) reduced starcoder2 (2 layers, d 64): 30 steps against 15 "
          f"+ resume from the step-15 checkpoint to 30, params max |diff| "
          f"{resumed!r} (limit 1e-5); reduced grok-1 (moments "
          f"{grok.moment_dtype}) saved and restored into a fresh run, every "
          f"leaf equal bit for bit")
    del run_a, run_b, run_c, run_g, fresh

    # (e) card against CPU: one make_train_step per reduced config
    card_against_cpu_steps()

    # (f) the user path: examples/train_lm_torch.py at its own sizes
    t0 = time.perf_counter()
    got = example("train_lm_torch").main(
        ["--steps", str(EXAMPLE_STEPS), "--seq", str(EXAMPLE_SEQ),
         "--batch", str(EXAMPLE_BATCH)])
    ex, first_ce, loop_s = got["config"], got["first_ce"], got["seconds"]
    print(f"  (f) examples/train_lm_torch.py: {ex.name} reduced to d "
          f"{ex.d_model}, {ex.n_layers} layers, vocab {ex.vocab}, "
          f"{got['params']} parameters, float32: ce "
          f"{first_ce!r} -> {got['ce']!r} over {EXAMPLE_STEPS} steps in "
          f"{loop_s!r} s ({EXAMPLE_STEPS * EXAMPLE_BATCH * EXAMPLE_SEQ / loop_s!r} "
          f"tokens/s, checkpoints every 50, kept {got['checkpoints']}); "
          f"the example {time.perf_counter() - t0!r} s in all")
    if not got["ce"] < 0.7 * first_ce:
        raise AssertionError(f"ce {got['ce']} is not below 0.7 of the "
                             f"first step's {first_ce}")
    del got
    gc.collect()
    torch.cuda.empty_cache()

    counts = cuda.launches()
    if any(counts.values()):
        raise AssertionError(f"training launched stencil kernels: {counts}")
    print(f"  stencil kernel launches during phase 16: {counts} (none: the "
          f"training path reaches no pallas_call in the reference)")
    print(f"  phase 16: {time.perf_counter() - t_phase!r} s")


#: Phase 17 (module docstring): the refusal a dry-run cell may end in
#: (``checkpoint.reshard.NamedSharding.shard_shape``'s uneven dim)
UNEVEN = "does not divide over mesh axes"
#: (d): stages, microbatches and the microbatch's shape
PIPE_STAGES, PIPE_MICRO, PIPE_SHAPE = 4, 8, (1, 512, 2560)


def _dryrun_cell(cell):
    """One dry-run cell in a worker process: (cell, "ok" and its record,
    "refused" and the message, or "error" and the traceback)."""
    import traceback
    from repro_torch.launch import dryrun
    arch, shape, multi = cell
    try:
        return cell, "ok", dryrun.run_lm_cell(arch, shape, multi, None,
                                              verbose=False)
    except ValueError as e:
        if UNEVEN in str(e):
            return cell, "refused", str(e)
        return cell, "error", traceback.format_exc()
    except Exception:                      # noqa: BLE001  reported
        return cell, "error", traceback.format_exc()


def dryrun_cells(smi, failures):
    """Phase 17 (a): every LM cell on both meshes in worker processes,
    then every stencil cell."""
    import multiprocessing
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.configs import stencil2d, stencil3d
    from repro_torch.launch import dryrun

    # the cells that count longest first (jamba's token-by-token scan)
    cells = sorted(((a, s, m) for m in (False, True) for a in ARCHS
                    for s in SHAPES),
                   key=lambda c: (not c[0].startswith("jamba"),
                                  c[1] != "train_4k"))
    workers = max(1, (os.cpu_count() or 2) - 1)
    print(f"\n-- (a) the dry run: {len(cells)} LM cells on both "
          f"production meshes in {workers} worker processes (meta tensors, "
          f"the host's cores), then the stencil cells")
    t0 = time.perf_counter()
    done = {"ok": 0, "refused": 0, "skipped": 0, "error": 0}
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers) as pool:
        for (arch, shape, multi), status, rec in pool.imap_unordered(
                _dryrun_cell, cells):
            mesh = "2x16x16" if multi else "16x16"
            if status == "ok" and rec.get("skipped"):
                done["skipped"] += 1
                print(f"  {arch} x {shape} x {mesh}: skipped "
                      f"({rec['reason']})")
                continue
            done[status] += 1
            if status == "ok":
                print(f"  {arch} x {shape} x {mesh}: compute "
                      f"{rec['t_compute']!r} s, memory {rec['t_memory']!r} "
                      f"s, collective {rec['t_collective']!r} s, dominant "
                      f"{rec['dominant']}, fits_hbm {rec['fits_hbm']} "
                      f"(peak {rec['peak_bytes'] / 2**30!r} GiB), counted "
                      f"in {rec['count_s']!r} s")
            elif status == "refused":
                print(f"  {arch} x {shape} x {mesh}: refused: {rec}")
            else:
                print(f"  {arch} x {shape} x {mesh}: ERROR\n{rec}")
                failures.append(f"dry run {arch}:{shape}:{mesh}")
        pool.close()
        pool.join()
    lm_s = time.perf_counter() - t0
    wls = {**stencil2d.workloads(4), **stencil3d.workloads(4)}
    n_stencil = 0
    for multi in (False, True):
        for wl in wls.values():
            if wl.name.endswith("_paper") and multi:
                continue
            rec = dryrun.run_stencil_cell(wl, multi, None, verbose=False)
            n_stencil += 1
            print(f"  stencil {wl.name} x {rec['mesh']}: compute "
                  f"{rec['t_compute']!r} s, memory {rec['t_memory']!r} s, "
                  f"collective {rec['t_collective']!r} s, dominant "
                  f"{rec['dominant']}, fits_hbm {rec['fits_hbm']}")
    print(f"  dry run: {done['ok']} LM cells passed, {done['refused']} "
          f"refused (uneven dims), {done['skipped']} skipped (long_500k "
          f"on full attention), {done['error']} failed; {n_stencil} stencil "
          f"cells passed; {lm_s!r} s for the LM cells, "
          f"{time.perf_counter() - t0!r} s in all ({smi})")


def mesh_tooling_phase(smi):
    """The LM mesh tooling on one process (module docstring, phase 17)."""
    import gc
    import torch
    from repro_torch.checkpoint import (CheckpointManager, reshard_tree,
                                        shardings_from_specs)
    from repro_torch.configs import get_arch
    from repro_torch.core import distributed
    from repro_torch.kernels import cuda
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer
    from repro_torch.models.common import LogicalAxes
    from repro_torch.runtime import mesh_rules
    from repro_torch.runtime.pipeline_parallel import (bubble_fraction,
                                                       pipeline_apply)

    print(f"\n== the LM mesh tooling on one process ({smi})")
    t_phase = time.perf_counter()
    failures = []
    gc.collect()
    torch.cuda.empty_cache()
    cuda.reset_launches()
    dryrun_cells(smi, failures)

    env = distributed.ENV_DEVICE_COUNT
    saved = os.environ.get(env)
    os.environ[env] = "4"
    try:
        # (b) a live reshard of gemma3-4b's parameters, (2, 2) -> (4, 1)
        cfg = get_arch(TRAIN_ARCH)
        rules = mesh_rules.default_rules(False)
        mesh_a = make_local_mesh((2, 2), ("data", "model"))
        mesh_b = make_local_mesh((4, 1), ("data", "model"))
        print(f"\n-- (b) reshard_tree of {cfg.name}'s float32 parameters: "
              f"{mesh_a.shape} -> {mesh_b.shape}, {mesh_a.size} mesh "
              f"devices on {len(mesh_a.cards())} card(s)")
        model = transformer.build(cfg, seed=0, train=True)
        params = {n: p.detach() for n, p in model.named_parameters()}
        specs = {n: LogicalAxes(a) for n, a in model.logical_axes().items()}
        sh_a = shardings_from_specs(mesh_a, rules, specs)
        sh_b = shardings_from_specs(mesh_b, rules, specs)
        total = sum(p.numel() * p.element_size() for p in params.values())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tree_a = reshard_tree(params, sh_a)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tree_b = reshard_tree(tree_a, sh_b)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated() / 2**30
        worst = 0.0
        for n, p in params.items():
            for tree in (tree_a, tree_b):
                got = tree[n].full()
                if not torch.equal(got, p):
                    worst = max(worst, float((got - p).abs().max()))
                del got
        print(f"  {len(params)} leaves, {total!r} bytes: placed on (2, 2) "
              f"in {t1 - t0!r} s, resharded to (4, 1) piece by piece in "
              f"{t2 - t1!r} s, peak {peak!r} GiB; max |full() - source| "
              f"{worst!r} (0 expected) ({smi})")
        if worst != 0.0:
            failures.append(f"(b) reshard off by {worst}")
        del tree_a, tree_b

        # (c) a checkpoint from (2, 2) restored onto (4, 1), reduced width
        small = transformer.build(cfg.reduced(), seed=1, train=True)
        sp = {n: p.detach() for n, p in small.named_parameters()}
        ss = {n: LogicalAxes(a) for n, a in small.logical_axes().items()}
        with tempfile.TemporaryDirectory() as tmp:
            mgr = CheckpointManager(tmp)
            t0 = time.perf_counter()
            mgr.save(1, reshard_tree(sp, shardings_from_specs(
                mesh_a, rules, ss)))
            back = mgr.restore(1, sp, shardings=shardings_from_specs(
                mesh_b, rules, ss))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        off = max(float((back[n].full() - p).abs().max())
                  for n, p in sp.items())
        on_b = all(t.sharding.mesh is mesh_b and all(
            piece.device.type == "cuda" for piece in t.pieces)
            for t in back.values())
        print(f"\n-- (c) checkpoint of the reduced {cfg.name} from (2, 2) "
              f"restored onto (4, 1) through restore(shardings=): "
              f"{len(sp)} leaves in {dt!r} s, max |full() - source| {off!r}, "
              f"pieces on the card's (4, 1) mesh: {on_b} (the 15.5 GB "
              f"full-width disk copy is left out)")
        if off != 0.0 or not on_b:
            failures.append(f"(c) restore(shardings=) off by {off}")
        del small, sp, back

        # (d) 4 pattern units as pipeline stages
        mesh_p = make_local_mesh((PIPE_STAGES,), ("pod",))
        units = [transformer.PatternUnit(model, u)
                 for u in range(PIPE_STAGES)]
        names = [n for n, _ in units[0].named_parameters()]
        stacked = {n: torch.stack([dict(u.named_parameters())[n].detach()
                                   for u in units]) for n in names}
        del params
        gen = torch.Generator(device="cuda").manual_seed(5)
        x = torch.randn((PIPE_MICRO,) + PIPE_SHAPE, generator=gen,
                        device="cuda").to(torch.bfloat16)

        def stage_fn(p, h):
            return torch.func.functional_call(units[0], p, (h,))

        def piped():
            return pipeline_apply(stage_fn, stacked, x, mesh=mesh_p)

        def in_turn():
            out = torch.empty_like(x)
            for m in range(PIPE_MICRO):
                h = x[m]
                for s in range(PIPE_STAGES):
                    h = stage_fn({n: t[s] for n, t in stacked.items()}, h)
                out[m] = h
            return out

        with torch.no_grad():
            got, want = piped(), in_turn()
            direct = x.clone()
            for m in range(PIPE_MICRO):
                for u in units:
                    direct[m] = u(direct[m])
            torch.cuda.synchronize()
            ms = {}
            for name, fn in (("pipeline", piped), ("in turn", in_turn),
                             ("pipeline again", piped)):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms[name] = (time.perf_counter() - t0) * 1e3
        gap = float((got.float() - want.float()).abs().max())
        gap_direct = float((got.float() - direct.float()).abs().max())
        finite = bool(got.isfinite().all())
        print(f"\n-- (d) pipeline_apply over {PIPE_STAGES} stages (one "
              f"pattern unit of {cfg.name} each, {len(cfg.pattern)} layers, "
              f"float32 weights cast to bf16 at use), {PIPE_MICRO} "
              f"microbatches of {PIPE_SHAPE} bf16: max |pipeline - units "
              f"in turn| {gap!r}, against the PatternUnit modules "
              f"{gap_direct!r} (0 expected: the same kernels on the same "
              f"values), finite {finite}; {ms} ms (host clock, "
              f"synchronised; the stages of a tick run one after another on "
              f"the card's stream); bubble_fraction({PIPE_MICRO}, "
              f"{PIPE_STAGES}) = {bubble_fraction(PIPE_MICRO, PIPE_STAGES)!r}"
              f" ({smi})")
        if gap != 0.0 or gap_direct != 0.0 or not finite:
            failures.append(f"(d) pipeline off by {gap}, {gap_direct}")
        if bubble_fraction(PIPE_MICRO, PIPE_STAGES) != 3 / 11:
            failures.append("(d) bubble_fraction(8, 4) != 3/11")
        del model, units, stacked
    finally:
        if saved is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = saved
    gc.collect()
    torch.cuda.empty_cache()

    counts = cuda.launches()
    print(f"\n-- (e) stencil kernel launches during phase 17: {counts} "
          f"(none: the mesh tooling reaches no pallas_call in the "
          f"reference)")
    if any(counts.values()):
        failures.append(f"the mesh tooling launched stencil kernels: "
                        f"{counts}")
    print(f"  phase 17: {time.perf_counter() - t_phase!r} s")
    if failures:
        raise AssertionError("phase 17: " + "; ".join(failures))


#: Phase 18 (module docstring): each legacy run's name, configuration
#: (``None``: the periodic spec), step count (``None``: one superstep) and
#: the kernel it must reach.
LEGACY_RUNS = (
    ("StencilEngine.create(...).run", "2d_r4_paper", 9, "B1"),
    ("StencilEngine.create(...).superstep", "2d_r4_paper", None, "B5"),
    ("ops.stencil_run(pipelined=True)", "3d_r4_paper", 3, "B4"),
    ("StencilEngine(pipelined=True).superstep", "3d_r4_paper", None, "B6"),
    ("ops.stencil_run(variant='temporal')", "2d_r4_paper", 19, "B3"),
    ("StencilEngine.create(periodic spec).run", None, 9, "B2"),
)
LEGACY_WARM_RUNS = 5


def _own_deprecations(caught):
    """The DeprecationWarnings of the port's shims among ``caught``."""
    src = os.path.join(HERE, "src", "repro_torch")
    return [w for w in caught if issubclass(w.category, DeprecationWarning)
            and (w.filename.startswith(src) or w.filename == __file__)]


def legacy_phase(smi):
    """The legacy surface and the lint tail on the card (module docstring,
    phase 18)."""
    t_phase = time.perf_counter()
    print(f"\n== phase 18: the legacy surface and the lint tail ({smi})")
    # the port's linter, in a process of its own on this machine, on the
    # host's cores while the runs below keep the card busy
    tests = sorted(os.path.join("tests", f)
                   for f in os.listdir(os.path.join(HERE, "tests"))
                   if f.startswith("test_torch_") and f.endswith(".py"))
    examples = sorted(os.path.join("examples", f)
                      for f in os.listdir(os.path.join(HERE, "examples"))
                      if f.endswith("_torch.py"))
    lint = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.lint",
         os.path.join("src", "repro_torch"), *tests, "chip_smoke.py",
         *examples],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=HERE, env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")))
    try:
        failures = legacy_runs(lint)
    finally:
        if lint.poll() is None:
            lint.kill()
            lint.wait()
    print(f"  phase 18: {time.perf_counter() - t_phase!r} s ({smi})")
    if failures:
        raise AssertionError("phase 18: " + "; ".join(failures))


def legacy_runs(lint) -> list:
    """Phase 18's checks (:func:`legacy_phase`); ``lint`` is the running
    linter, read last.  Returns the failures."""
    import warnings
    import torch
    import repro_torch
    from repro_torch.backends import lower
    from repro_torch.configs import stencil2d, stencil3d
    from repro_torch.core.spec import StencilSpec
    from repro_torch.core.temporal import StencilEngine
    from repro_torch.kernels import common, cuda, ops
    from repro_torch.lint.artifact import (analyze_launches, audit_run,
                                           check_trace_budget,
                                           record_launches)

    t_lint = time.perf_counter()
    work = {**stencil2d.workloads(), **stencil3d.workloads()}
    failures = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        specs = {"2d_r4_paper": StencilSpec(2, 4),
                 "3d_r4_paper": StencilSpec(3, 4),
                 None: StencilSpec(2, 4, boundary="periodic")}
    for i, (label, config, steps, kernel) in enumerate(LEGACY_RUNS):
        spec = specs[config]
        prog = spec.to_program()
        w = work[config or "2d_r4_paper"]
        plan = w.plan()
        shape = w.grid_shape
        coeffs = spec.default_coeffs()
        pc = prog.coeffs_from_legacy(coeffs)
        if not (torch.equal(pc.taps, prog.default_coeffs().taps)
                and torch.equal(pc.center, prog.default_coeffs().center)):
            failures.append(f"{label}: the spec's coefficients are not the "
                            f"program's")
        grid = random_grid(shape, seed=18 + i)
        variant = "pipelined" if "pipelined" in label else (
            "temporal" if "temporal" in label else "plain")
        if label.startswith("StencilEngine.create(") and steps:
            run = lambda: StencilEngine.create(  # noqa: E731
                spec, shape, plan=plan).run(grid, steps)
        elif label.startswith("StencilEngine.create("):
            run = lambda: StencilEngine.create(  # noqa: E731
                spec, shape, plan=plan).superstep(grid)
        elif label.startswith("StencilEngine("):
            run = lambda: StencilEngine(  # noqa: E731
                spec=spec, coeffs=coeffs, plan=plan,
                pipelined=True).superstep(grid)  # legacy-ok
        elif variant == "pipelined":
            run = lambda: ops.stencil_run(  # noqa: E731
                grid, spec, coeffs, plan, steps, pipelined=True)  # legacy-ok
        else:
            run = lambda: ops.stencil_run(  # noqa: E731
                grid, spec, coeffs, plan, steps, variant=variant)
        cuda.reset_launches()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with record_launches() as log:
                out = run()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: n for k, n in cuda.launches().items() if n}
        if steps is None:
            want_counts = {"pipelined_superstep" if variant == "pipelined"
                           else "superstep": 1}
            low = lower(prog, plan, coeffs=pc, backend="cuda-pipelined"
                        if variant == "pipelined" else "cuda")
            want = low.superstep(grid)
        else:
            want_counts = expected_launches(prog, plan, steps, variant)
            cs = repro_torch.stencil(prog, pc).compile(
                shape, steps=steps, plan=plan, variant=variant)
            want = cs.run(grid)
        torch.cuda.synchronize()
        gap = max_err(out, want)
        audit = analyze_launches(log.launches, expect_dtype=prog.dtype,
                                 inputs=(grid,), results=(out,))
        mine = _own_deprecations(caught)
        print(f"  {label} ({kernel}) at {config or 'periodic 16384^2'} "
              f"grid={shape} block={plan.block_shape} "
              f"par_time={plan.par_time} steps={steps}: launches {counts} "
              f"(expected {want_counts}), against the front door "
              f"max_abs_err={gap!r}, {len(mine)} DeprecationWarning "
              f"({[str(m.message)[:40] for m in mine]}), audit of "
              f"{len(log.launches)} launches: "
              f"{[d.code for d in audit] or 'clean'}; {wall!r} s")
        if counts != want_counts:
            failures.append(f"{label}: launches {counts} != {want_counts}")
        if gap != 0.0 or not bool(out.isfinite().all()) \
                or out.shape != grid.shape:
            failures.append(f"{label}: off the front door by {gap}")
        if len(mine) != 1:
            failures.append(f"{label}: {len(mine)} DeprecationWarnings")
        if audit:
            failures.append(f"{label}: audit {[d.describe() for d in audit]}")
        del out, want, grid
    torch.cuda.empty_cache()

    # the audit must be able to fail: a planted alias, two ways
    w = work["2d_r4_paper"]
    prog, plan = w.plan().spec, w.plan()
    layout = common.ring_schedule(prog, plan, w.grid_shape,
                                  plan.par_time).layout
    c = prog.default_coeffs().to("cuda")
    src = random_grid(layout.padded_shape, seed=30)
    with record_launches() as log:
        cuda.padded_superstep(src, src, c.center, c.taps, program=prog,
                              plan=plan, layout=layout)
    torch.cuda.synchronize()
    planted = [d.code for d in analyze_launches(log.launches)]
    _, view = audit_run(lambda g: g[1:], src)
    view = [d.code for d in view]
    print(f"  planted: B1 with dst = src -> {planted}; a result that is a "
          f"view of the grid -> {view}")
    if planted != ["RP204"] or "RP204" not in view:
        failures.append(f"the planted aliases read {planted}, {view}")
    del src
    torch.cuda.empty_cache()

    # RP203: warm loops move no trace counter
    spec = specs["2d_r4_paper"]
    grid = random_grid(w.grid_shape, seed=31)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        engine = StencilEngine.create(spec, w.grid_shape, plan=plan)
    cs = repro_torch.stencil(prog).compile(w.grid_shape, steps=9, plan=plan)
    engine.run(grid, 9)
    cs.run(grid)
    torch.cuda.synchronize()
    before = common.trace_counts()
    for _ in range(LEGACY_WARM_RUNS):
        engine.run(grid, 9)
        cs.run(grid)
    torch.cuda.synchronize()
    delta = common.trace_delta(before)
    budget = check_trace_budget(delta, 0, context="the warm loops")
    print(f"  {LEGACY_WARM_RUNS} warm engine and front-door runs: trace "
          f"delta {delta}, budget {[d.code for d in budget] or 'clean'} "
          f"(counters {common.trace_counts()})")
    if budget:
        failures.append(f"warm loops: {budget[0].describe()}")
    del grid, engine, cs
    torch.cuda.empty_cache()

    # the user path: examples/quickstart_torch.py and wave3d_torch.py
    failures += example_runs()

    # the port's linter, started with the phase
    out, _ = lint.communicate(timeout=600)
    lines = out.strip().splitlines()
    print(f"  python -m repro_torch.lint src/repro_torch "
          f"tests/test_torch_*.py chip_smoke.py examples/*_torch.py: exit "
          f"{lint.returncode}, "
          f"done {time.perf_counter() - t_lint!r} s after the phase's "
          f"start: {lines[-1][-120:] if lines else ''}")
    if lint.returncode != 0:
        failures.append("the port's linter: " + "; ".join(lines[-5:]))
    return failures


#: Phase 18's examples: each one's arguments and the kernels it must
#: launch.  At 16 steps the quickstart's temporal run is one chunk-deep
#: launch of B3 (at its default 8 the chunk is longer than the run).
EXAMPLE_RUNS = (("quickstart_torch", ["--steps", "16"],
                 ("padded_superstep", "temporal_superstep")),
                ("wave3d_torch", [], ("padded_superstep",)))


def example_runs() -> list:
    """Phase 18: the stencil examples on the card, launches zeroed before
    each and read after, each result held to the port's oracle on the
    card (the examples assert their own checks too).  Returns the
    failures."""
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.kernels.ref import program_nsteps

    failures = []
    for name, argv, kernels in EXAMPLE_RUNS:
        cuda.reset_launches()
        t0 = time.perf_counter()
        got = example(name).main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {k: n for k, n in cuda.launches().items() if n}
        if name == "quickstart_torch":
            plan = got["plan"]
            steps = got["steps"]
            want = program_nsteps(plan.spec, got["coeffs"], got["grid"],
                                  steps)
            errs = {"run against the oracle": max_err(got["out"], want),
                    "temporal against plain": max_err(got["temporal"],
                                                      got["out"]),
                    "batched against single": max_err(got["batched"][0],
                                                      got["out"])}
            ok = errs["run against the oracle"] <= 1e-4 \
                and torch.allclose(got["temporal"], got["out"], **ULP) \
                and errs["batched against single"] == 0.0
            what = (f"plan block={plan.block_shape} par_time="
                    f"{plan.par_time}, {steps} steps")
        else:
            want = program_nsteps(got["program"], got["coeffs"],
                                  got["u0"], 8)
            errs = {"run against the oracle": max_err(got["u"], want)}
            bound = max(got["energies"]) / got["e0"]
            ok = bool(torch.allclose(got["u"], want, **ULP)) \
                and bound <= 1.01
            what = f"energy/e0 at most {bound!r} (limit 1.01)"
        print(f"  examples/{name}.py {' '.join(argv)}: {what}; launches "
              f"{counts}; max_abs_err {errs}; {secs!r} s")
        missing = [k for k in kernels if not counts.get(k)]
        if missing:
            failures.append(f"{name}: no launch of {missing} ({counts})")
        if not ok:
            failures.append(f"{name}: {errs}")
        del got, want
    torch.cuda.empty_cache()
    return failures


#: Phase 14 (module docstring): the 16-bit main path.  Each case of
#: :func:`cases` and :func:`queue_cases` whose name and check are listed
#: runs again with its program in the dtype; bfloat16 covers B1-B6 on
#: both bodies at the paper shapes (the radius-4 stars' B1, B5 and B6 on
#: the register queues, as in float32), float16 one configuration per body
#: and the queues at radius 4.
HALF_CASES = {
    "bfloat16": (("2d_r4_paper", "carry"), ("3d_r4_paper", "carry"),
                 ("2d_box_periodic_pod", "carry"), ("3d_r2_paper", "carry"),
                 ("2d_r4_paper", "temporal"), ("3d_r4_paper", "pipelined"),
                 ("2d_box_periodic_pod", "pipelined"),
                 ("2d_r4_paper", "prepadded"), ("3d_r4_paper", "prepadded"),
                 ("2d_box_periodic_pod", "prepadded"),
                 ("3d_r2_paper", "prepadded")),
    "float16": (("3d_r2_paper", "carry"), ("2d_box_periodic_pod", "carry"),
                ("2d_r4_paper", "carry"), ("2d_r4_paper", "temporal"),
                ("2d_box_periodic_pod", "pipelined"),
                ("3d_r2_paper", "prepadded"),
                ("2d_box_periodic_pod", "prepadded")),
}


def queue_cases():
    """The register-queue body at ``3d_r2_paper`` (par_time 2): a plain
    run of 5 steps (2 full supersteps and a remainder of 1), B5 and B6
    through ``lower()``."""
    from repro_torch.configs import stencil3d
    r2 = stencil3d.workloads()["3d_r2_paper"]
    return [
        dict(name="3d_r2_paper", work=r2, steps=5,
             expect={"padded_superstep": 3}, check="carry"),
        dict(name="3d_r2_paper", work=r2, backend="cuda",
             expect={"superstep": 1}, check="prepadded"),
        dict(name="3d_r2_paper", work=r2, backend="cuda-pipelined",
             expect={"pipelined_superstep": 1}, check="prepadded"),
    ]
#: The card-against-CPU check of each front-door variant runs on a cut of
#: the paper grid: the plain versions on the CPU would take minutes at full
#: width.
HALF_CPU_GRIDS = {2: (1024, 1024), 3: (32, 64, 704)}


def half_cases(dtype):
    """The :func:`cases` of :data:`HALF_CASES` with their programs (and
    so their plans) in ``dtype``; a backend case keeps its backend."""
    import dataclasses
    out = []
    for case in cases() + queue_cases():
        if "plan" in case:
            continue
        for name, check in HALF_CASES[dtype]:
            if case["name"] == name and case["check"] == check:
                work = case["work"]
                out.append(dict(case, work=dataclasses.replace(
                    work, spec=dataclasses.replace(work.spec,
                                                   dtype=dtype))))
    found = {(c["name"], c["check"]) for c in out}
    if found != set(HALF_CASES[dtype]):
        raise AssertionError(f"{dtype} cases: {sorted(found)}")
    return out


def half_phase(smi, chip):
    """Phase 14 (module docstring): every kernel in bfloat16 at the paper
    shapes and float16 at one configuration per body, through the front
    door with counts zeroed before and read after, each kernel against its
    plain version at 0 and timed; each front-door variant's result on the
    card against the CPU at 0; one bfloat16 mesh run; the NaN canary on
    B1-B4; ``plan="model"``.  Returns the kernel records."""
    import dataclasses
    import torch
    import repro_torch
    from repro_torch.configs import stencil2d, stencil3d
    from repro_torch.core.distributed import ENV_DEVICE_COUNT as ENV_MESH
    from repro_torch.kernels import cuda
    from repro_torch.lint import sanitize_run
    from repro_torch.lint.sanitize import canary_grid

    t_phase = time.perf_counter()
    records = []
    for dtype in ("bfloat16", "float16"):
        print(f"\n== 16-bit grids: {dtype} ({smi})")
        for case in half_cases(dtype):
            state = drive_main_path(case, chip)
            records += check_kernels(case, state, chip)
            if "backend" not in case:
                # the same front door on a cut of the grid, card against CPU
                prog, plan = state["prog"], state["plan"]
                shape = HALF_CPU_GRIDS[prog.ndim]
                g = random_grid(shape, seed=5, dtype=dtype)
                kw = dict(steps=state["steps"], plan=plan,
                          variant=case.get("variant"))
                on_card = repro_torch.stencil(prog).compile(shape, **kw).run(
                    g)
                on_cpu = repro_torch.stencil(prog).compile(
                    shape, device="cpu", **kw).run(g.cpu())
                check_close(f"{case['name']} {dtype} "
                            f"{case.get('variant') or 'plain'} on the card "
                            f"vs the CPU at {shape}", on_card.cpu(), on_cpu,
                            atol=0.0, rtol=0.0)
                del g, on_card, on_cpu
            del state
            torch.cuda.empty_cache()

    works = {**stencil2d.workloads(), **stencil3d.workloads()}
    work = works["2d_r4_paper"]
    prog = dataclasses.replace(work.spec, dtype="bfloat16")
    plan = dataclasses.replace(work.plan(), spec=prog)
    shape = work.grid_shape
    grid = random_grid(shape, seed=6, dtype="bfloat16")

    print(f"\n== bfloat16 mesh: 2d_r4_paper on 2x2 shards of one card "
          f"({ENV_MESH}={MESH_DEVICES})")
    saved = os.environ.get(ENV_MESH)
    os.environ[ENV_MESH] = str(MESH_DEVICES)
    try:
        mesh = repro_torch.stencil(prog).compile(shape, steps=9, plan=plan,
                                                 devices=(2, 2))
        cuda.reset_launches()
        got = mesh.run(grid)
        torch.cuda.synchronize()
        counts = {k: v for k, v in cuda.launches("bfloat16").items() if v}
    finally:
        if saved is None:
            del os.environ[ENV_MESH]
        else:
            os.environ[ENV_MESH] = saved
    print(f"  {mesh.describe()}: launches {counts}")
    if counts != {"padded_superstep_sharded": 4 * 5}:
        raise AssertionError(f"bfloat16 mesh launched {counts}")
    one = repro_torch.stencil(prog).compile(shape, steps=9, plan=plan)
    check_close("bfloat16 mesh 2x2 vs the single device", got,
                one.run(grid), atol=0.0, rtol=0.0)
    del got, mesh

    print("\n== bfloat16 plan=\"model\" at 2d_r4_paper")
    cs = repro_torch.stencil(prog).compile(shape, steps=9, plan="model")
    print(f"  plan block {cs.plan.block_shape} par_time "
          f"{cs.plan.par_time}, body {cs.plan.body('padded_superstep')}, "
          f"model {cs.predicted_seconds(9) * 1e3!r} ms")
    cuda.reset_launches()
    planned = cs.run(grid)
    torch.cuda.synchronize()
    print(f"  launches {dict((k, v) for k, v in cuda.launches().items() if v)}")
    check_close("bfloat16 plan=model vs the pinned plan", planned,
                one.run(grid), atol=0.0, rtol=0.0)
    walls = {"model": [], "pinned": []}
    for _ in range(3):
        for key, exe in (("model", cs), ("pinned", one)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            exe.run(grid)
            torch.cuda.synchronize()  # lint-ok: RP302
            walls[key].append(time.perf_counter() - t0)
    for key, w in walls.items():
        med = statistics.median(w)
        print(f"  {key}: median wall of 3 {med * 1e3!r} ms, "
              f"{math.prod(shape) * 9 / med / 1e6!r} MCell/s")
    del planned, grid, cs, one

    for name, variant, steps, want in CANARIES[:3] + CANARIES[3:4]:
        work = works[name]
        prog = dataclasses.replace(work.spec, dtype="bfloat16")
        plan = dataclasses.replace(work.plan(), spec=prog)
        shape = (16384, 16384) if name == "2d_box_periodic_pod" \
            else work.grid_shape
        coeffs = prog.default_coeffs(0)
        cuda.reset_launches()
        t0 = time.perf_counter()
        report = sanitize_run(prog, plan, shape, steps=steps,
                              variant=variant, coeffs=coeffs)
        torch.cuda.synchronize()
        counts = {k: v for k, v in cuda.launches("bfloat16").items() if v}
        print(f"  bfloat16 canary {name} {variant} {steps} steps: "
              f"{report.describe()}; "
              f"{time.perf_counter() - t0!r} s; launches {counts}")
        if not report.ok or counts != want:
            raise AssertionError(f"bfloat16 canary {name} {variant}: "
                                 f"{report}")
        cs = repro_torch.stencil(prog, coeffs).compile(
            shape, steps=steps, plan=plan, variant=variant)
        g = torch.from_numpy(canary_grid(shape)).to("cuda", torch.bfloat16)
        check_close(f"bfloat16 canary {name} {variant} interior vs the "
                    f"front door's run", report.interior, cs.run(g),
                    atol=0.0, rtol=0.0)
        del report, g, cs
        torch.cuda.empty_cache()
    print(f"  phase 14: {time.perf_counter() - t_phase!r} s")
    return records


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.analysis.hw import GpuChip, datasheet
    from repro_torch.kernels import build

    smi = nvidia_smi()
    print(f"nvidia-smi: {smi}")
    props = torch.cuda.get_device_properties(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}: {props}")
    chip = datasheet(smi)
    print(f"card: {GpuChip.from_device(0)}; bounds use the {chip.name} "
          f"data sheet: {chip.hbm_bytes_per_s!r} B/s, "
          f"{chip.peak_fp32_flops!r} FP32 FLOP/s")
    t0 = time.perf_counter()
    logs = build.build(dtypes=tuple(build.DTYPES))
    for (src, dtype), log in logs.items():
        print(f"nvcc {src} ({dtype}):\n{log.strip()}")
    print(f"kernel build: {time.perf_counter() - t0!r} s "
          f"({len(logs)} libraries built in parallel)")
    for (src, dtype), secs in sorted(build.BUILD_SECONDS.items()):
        print(f"  build {src} {dtype}: done {secs!r} s after the start")

    records = []
    for case in cases() + queue_cases():
        state = drive_main_path(case, chip)
        records += check_kernels(case, state, chip)
        del state
        torch.cuda.empty_cache()
    exact_checks()
    plane_corners()
    refuse_other_step_count()
    # a cache of this run's own, so that no stale record hides the model
    with tempfile.TemporaryDirectory() as tmp:
        planner_phase(os.path.join(tmp, "plans.json"))
        autotune_phase(os.path.join(tmp, "plans.json"))
    serving_phase(smi)
    recorder_phase(smi)
    preflight_phase(smi)
    records += mesh_phase(smi, chip)
    records += half_phase(smi, chip)
    ptxas_report()
    lm_phase(smi, chip)
    families_phase(smi, chip)
    train_phase(smi, chip)
    mesh_tooling_phase(smi)
    legacy_phase(smi)
    for dtype in ("float32", "bfloat16"):
        ported = {r["name"].split("@")[0] for r in records
                  if r["dtype"] == dtype}
        if len(ported) != 6:
            raise AssertionError(f"{dtype} kernel records cover "
                                 f"{sorted(ported)}")
    for (kernel, name), ms in EARLIER_MS.items():
        unit = "ms/refresh" if kernel == "wrap_halo" else "ms/launch"
        print(f"earlier design of {kernel}@{name}, quoted from PERF.md's "
              f"earlier ms, not measured in this run: {ms!r} {unit}")

    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
