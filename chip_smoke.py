#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold every kernel to its
plain PyTorch version.

    python3 chip_smoke.py        # from the repo root, one CUDA card

Phases (any failure raises, so the exit code is non-zero):

1. device: ``nvidia-smi`` name and power limit, the card's properties,
   and the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``;
2. the main path, ``repro_torch.stencil(...).compile(...).run(grid)``, at
   the paper's single-device workloads (``2d_r4_paper`` 16384², 9 steps;
   ``3d_r4_paper`` 512x1024x704, 3 steps) and the periodic box workload at
   16384² (10 steps).  Launch counts are zeroed just before each run and
   read just after; each result is compared with the port's oracle
   (``core/reference.program_nsteps``) on the same card tensors;
3. each kernel's wrapper against its plain version on the same inputs at
   the shapes the main path gives it;
4. small exact checks: 2D/3D x clamp/periodic/constant x batch 2 x a
   remainder superstep against the float64 oracle on the card;
5. times: CUDA events, two warm-ups, the median of 7 runs, beside the
   card's bound and a PyTorch convolution yardstick (``library_ms``).

The last lines are the ``{"kernels": [...]}`` record, the ``nvidia-smi``
line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

#: kernel vs plain version, and front door vs oracle, in float32: both sides
#: multiply then add in the same order without FMA contraction, so 0 is
#: expected; the tolerance is the repo's ULP (tests/test_padded_carry.py).
ULP = dict(atol=1e-6, rtol=1e-5)
#: float32 run vs the float64 oracle (the repo's TOL).
TOL = 5e-4
#: a float32 convolution vs the float32 oracle: cuDNN sums in its own order.
LIBRARY_TOL = 1e-4
RUNS = 7


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def check_close(what: str, got, want, atol: float, rtol: float) -> float:
    import torch
    err = max_err(got, want)
    ok = torch.allclose(got.double(), want.double(), atol=atol, rtol=rtol)
    print(f"  {what}: max_abs_err={err!r} (atol {atol}, rtol {rtol})")
    if not ok:
        raise AssertionError(f"{what} disagrees: max_abs_err {err}")
    return err


def median_ms(fn, runs: int = RUNS) -> float:
    """Median over ``runs`` of one call's device time (CUDA events), after
    two warm-up calls."""
    import torch
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
    return statistics.median(times)


def bound(bytes_moved: float, flops: float, chip):
    t_bytes = bytes_moved / chip.hbm_bytes_per_s * 1e3
    t_ops = flops / chip.peak_fp32_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_grid(shape, seed: int):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand(shape, generator=gen, device="cuda") * 2 - 1


def library_step(program, coeffs, grid, steps: int):
    """``steps`` calls of ``F.pad`` + ``F.conv2d``/``conv3d`` with the taps
    in a dense (2r+1)^d weight: the PyTorch yardstick, used nowhere in the
    port."""
    import torch
    import torch.nn.functional as F
    r = program.halo_radius
    nd = program.ndim
    k = 2 * r + 1
    weight = torch.zeros((k,) * nd, device=grid.device)
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


def main_path_cases():
    from repro_torch.configs import stencil2d, stencil3d
    w2 = stencil2d.workloads()
    w3 = stencil3d.workloads()
    box = w2["2d_box_periodic_pod"]
    return [
        dict(name="2d_r4_paper", work=w2["2d_r4_paper"],
             grid=w2["2d_r4_paper"].grid_shape, steps=9),
        dict(name="3d_r4_paper", work=w3["3d_r4_paper"],
             grid=w3["3d_r4_paper"].grid_shape, steps=3),
        dict(name="2d_box_periodic_pod", work=box, grid=(16384, 16384),
             steps=10,
             reduced="grid 16384^2 instead of 65536^2: four float32 "
                     "buffers of 17 GB would not fit 80 GB"),
    ]


def drive_main_path(case, chip):
    """One front-door run with zeroed launch counts, checked against the
    oracle; returns the counts and the state the kernel checks reuse."""
    import torch
    import repro_torch
    from repro_torch.core.reference import program_nsteps
    from repro_torch.kernels import cuda

    work, shape, steps = case["work"], case["grid"], case["steps"]
    prog, plan = work.spec, work.plan()
    print(f"\n== main path: {case['name']} grid={shape} steps={steps} "
          f"block={plan.block_shape} par_time={plan.par_time} "
          f"{prog.shape} r={prog.radius} {prog.boundary}")
    if "reduced" in case:
        print(f"  reduced: {case['reduced']}")
    grid = random_grid(shape, seed=0)
    cs = repro_torch.stencil(prog).compile(shape, steps=steps, plan=plan)
    cuda.reset_launches()
    out = cs.run(grid)
    torch.cuda.synchronize()
    counts = cuda.launches()
    full, rem = divmod(steps, plan.par_time)
    supersteps = full + (1 if rem else 0)
    want = {"padded_superstep": supersteps,
            "wrap_halo": supersteps * prog.ndim
            if prog.boundary == "periodic" else 0}
    print(f"  launches {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    if tuple(out.shape) != tuple(shape) or not bool(out.isfinite().all()):
        raise AssertionError("run output has the wrong shape or non-finite "
                             "values")
    ref = program_nsteps(prog, cs.coeffs, grid, steps)
    check_close("front door vs program_nsteps (float32, same card)",
                out, ref, **ULP)
    del ref, out
    # wall time of one more run (host clock around a synchronised run)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs.run(grid)
    torch.cuda.synchronize()  # lint-ok: RP302
    wall = time.perf_counter() - t0
    cells = math.prod(shape) * steps
    print(f"  run: {wall * 1e3!r} ms, {cells / wall / 1e6!r} MCell/s, "
          f"{cells * prog.flops_per_cell / wall / 1e9!r} GFLOP/s")
    return dict(counts=counts, grid=grid, coeffs=cs.coeffs, prog=prog,
                plan=plan)


def check_and_time_kernels(case, state, chip):
    """Each kernel's wrapper against its plain version on the path's
    shapes, then the times.  Returns the ``kernels`` records."""
    import torch
    from repro_torch.core.reference import program_nsteps
    from repro_torch.kernels import common, cuda

    prog, plan, grid, coeffs = (state["prog"], state["plan"], state["grid"],
                                state["coeffs"])
    sched = common.ring_schedule(prog, plan, tuple(grid.shape), plan.par_time)
    layout = sched.layout
    H, n = layout.halo, tuple(grid.shape)
    interior = (Ellipsis,) + tuple(slice(H, H + s) for s in n)
    src = grid.new_zeros(layout.padded_shape)
    src[interior] = grid
    records = []
    name = case["name"]
    print(f"  kernels at {name}: padded {layout.padded_shape}, ring H={H}")

    if layout.wrap_axes:
        copies = common.wrap_copies(layout)
        got = src.clone()
        cuda.refresh_wrap_halo(got, copies, layout.padded_shape)
        want = common.refresh_wrap_halo_plain(src.clone(), layout)
        torch.cuda.synchronize()
        err = check_close("wrap_halo vs refresh_wrap_halo_plain", got, want,
                          **ULP)
        naxes = len(layout.wrap_axes)
        buf = src.clone()
        ms = median_ms(lambda: cuda.refresh_wrap_halo(
            buf, copies, layout.padded_shape)) / naxes
        plain_ms = median_ms(lambda: common.refresh_wrap_halo_plain(
            buf, layout)) / naxes
        moved = sum(2 * 4 * c.width * math.prod(layout.padded_shape)
                    // layout.padded_shape[c.axis] for c in copies) / naxes
        b_ms, b_by = bound(moved, 0.0, chip)
        print(f"  wrap_halo: {ms!r} ms/launch, plain {plain_ms!r} ms, "
              f"bound {b_ms!r} ms ({b_by})")
        records.append(dict(
            name=f"wrap_halo@{name}", route="cuda",
            source="src/repro_torch/kernels/csrc/wrap_halo.cu",
            replaces="src/repro/kernels/common.py:678",
            launches=state["counts"]["wrap_halo"], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None))
        common.refresh_wrap_halo_plain(src, layout)

    center, taps = coeffs.center, coeffs.taps
    got = torch.zeros_like(src)
    want = torch.zeros_like(src)
    cuda.padded_superstep(src, got, center, taps, program=prog, plan=plan,
                          layout=layout)
    common.padded_superstep_plain(src, want, center, taps, program=prog,
                                  plan=plan, layout=layout)
    torch.cuda.synchronize()
    err = check_close("padded_superstep vs padded_superstep_plain",
                      got[interior], want[interior], **ULP)
    del want
    ms = median_ms(lambda: cuda.padded_superstep(
        src, got, center, taps, program=prog, plan=plan, layout=layout))
    plain_ms = median_ms(lambda: common.padded_superstep_plain(
        src, got, center, taps, program=prog, plan=plan, layout=layout))
    torch.backends.cudnn.allow_tf32 = False
    lib = library_step(prog, coeffs, grid, plan.par_time)
    ref = program_nsteps(prog, coeffs, grid, plan.par_time)
    check_close("library yardstick vs program_nsteps", lib, ref,
                atol=LIBRARY_TOL, rtol=0.0)
    del lib, ref
    library_ms = median_ms(lambda: library_step(prog, coeffs, grid,
                                                plan.par_time))
    cells = math.prod(n)
    moved = 4 * (math.prod(layout.padded_shape) + cells)
    flops = cells * plan.par_time * prog.flops_per_cell
    b_ms, b_by = bound(moved, flops, chip)
    tile = cuda.pick_tile(prog.ndim, plan.halo, plan.par_time,
                          prog.num_taps, cuda.smem_optin(grid.device.index))
    print(f"  padded_superstep: CTA tile {tile}, {ms!r} ms/launch, plain "
          f"{plain_ms!r} ms, library {library_ms!r} ms "
          f"(cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}), bound "
          f"{b_ms!r} ms ({b_by}: {moved} bytes, {flops} flop)")
    records.append(dict(
        name=f"padded_superstep@{name}", route="cuda",
        source="src/repro_torch/kernels/csrc/padded_superstep.cu",
        replaces="src/repro/kernels/common.py:707",
        launches=state["counts"]["padded_superstep"], max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=library_ms))
    return records


def exact_checks():
    """Small configurations through the front door against the float64
    oracle on the card; a wrap-degenerate layout must refuse the card."""
    import torch
    import repro_torch
    from repro_torch.core.reference import program_nsteps
    from repro_torch.kernels import cuda

    print("\n== small exact checks vs the float64 oracle")
    shapes = {2: ((37, 150), (16, 128)), 3: ((20, 18, 140), (8, 16, 128))}
    cases = [(ndim, kind, 2, boundary) for ndim in (2, 3)
             for boundary in ("clamp", "periodic", "constant")
             for kind in ("star", "box")] + [(3, "box", 4, "clamp")]
    for ndim, kind, radius, boundary in cases:
        shape, block = shapes[ndim]
        prog = repro_torch.StencilProgram(
            ndim=ndim, radius=radius, shape=kind, boundary=boundary,
            boundary_value=0.25)
        plan = repro_torch.BlockPlan(spec=prog, block_shape=block,
                                     par_time=2)
        grid = random_grid((2,) + shape, seed=ndim)
        cs = repro_torch.stencil(prog).compile(
            shape, steps=3, batch=2, plan=plan)
        before = cuda.launches()["padded_superstep"]
        out = cs.run(grid)
        if cuda.launches()["padded_superstep"] - before != 2:
            raise AssertionError("small run did not launch twice")
        c64 = repro_torch.ProgramCoeffs(cs.coeffs.center.double(),
                                        cs.coeffs.taps.double())
        want = program_nsteps(prog, c64, grid.double(), 3)
        check_close(f"{ndim}D {kind} r={radius} {boundary} batch 2 "
                    f"steps 3",
                    out, want, atol=TOL, rtol=0.0)
    prog = repro_torch.StencilProgram(ndim=3, radius=2, boundary="periodic")
    plan = repro_torch.BlockPlan(spec=prog, block_shape=(8, 16, 128),
                                 par_time=2)
    cs = repro_torch.stencil(prog).compile((9, 18, 140), steps=3, plan=plan)
    try:
        cs.run(random_grid((9, 18, 140), seed=0))
    except NotImplementedError as e:
        print(f"  wrap-degenerate periodic refuses the card: {e}")
    else:
        raise AssertionError("wrap-degenerate run did not refuse the card")


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
    logs = build.build()
    for src, log in logs.items():
        print(f"nvcc {src}:\n{log.strip()}")
    print(f"kernel build: {time.perf_counter() - t0!r} s "
          f"({len(logs)} built in parallel)")

    records = []
    for case in main_path_cases():
        state = drive_main_path(case, chip)
        records += check_and_time_kernels(case, state, chip)
        del state
        torch.cuda.empty_cache()
    exact_checks()

    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
