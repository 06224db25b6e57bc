"""Measure the carry kernels on one card and write the H100 planner's
calibration, ``src/repro_torch/core/h100_calibration.py``.

    python3 tools/planner_calibration.py [OUT] [--dtype D]   # repo root

For every paper configuration of ``configs/`` (2D star r1-r4 at 16384^2,
3D star r1-r4 at 512x1024x704, the periodic box at 16384^2) and every
launcher the planner can pick for it (``blocking.launcher``: the register
queues, the streamed kernel's one-shot grid, its persistent CTAs), each
fused step count of :data:`STEPS` that some candidate plan launches
(``blocking.candidate_plans`` under each variant: every kernel fits a CTA
tile and more than ``MIN_USEFUL_FRACTION`` of the computed cells are
output) is timed as one launch on a padded carry of the grid: the median
of 5 after 2 warm-ups (CUDA events).  Its efficiency is the model's bound
for that launch (``cells * max(bytes / hbm, flops / (peak / 2))`` from
``blocking.launch_work``) over the time less :data:`LAUNCH_S`.  A
one-superstep front-door run per configuration (host clock around a
synchronised run) gives the run executor's fills and copies:
``COPY_EFFICIENCY`` is the median of their bytes over the memory rate,
over the run's wall time less its launch.

Keys carry the grid's bytes per cell: ``--dtype`` (float32, bfloat16 or
float16; default float32) times the same launches on a carry of that
dtype, and the module keeps the current module's rows of every other
cell size as they are.  ``COPY_EFFICIENCY`` is measured in float32 runs
only (a 16-bit run keeps the current value).

Every row prints as a JSON line, then the module, which is also written
to ``OUT`` (default ``build/repro_torch/h100_calibration.py``); copy it over
``src/repro_torch/core/h100_calibration.py`` to take it.  Needs a CUDA
card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: The fused step counts timed, where a candidate plan launches them.
STEPS = tuple(range(1, 17)) + (20, 24, 28, 32)
#: Seconds one launch adds beside its work: B2, a launch with almost no
#: work, took 0.032 ms per refresh in ``chip_smoke.py`` on an NVIDIA H100
#: 80GB HBM3 at 700.00 W.
LAUNCH_S = 3.2e-5


def median_ms(fn, runs: int = 5) -> float:
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


def wall_ms(fn) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()  # lint-ok: RP302
    return (time.perf_counter() - t0) * 1e3


def configs(dtype: str = "float32"):
    """``(workload, grid)`` of the paper configurations, their programs
    in ``dtype``."""
    from repro_torch.configs import stencil2d, stencil3d
    w2 = stencil2d.workloads()
    w3 = stencil3d.workloads()
    out = [(w2[f"2d_r{r}_paper"], (16384, 16384)) for r in (1, 2, 3, 4)]
    out += [(w3[f"3d_r{r}_paper"], w3[f"3d_r{r}_paper"].grid_shape)
            for r in (1, 2, 3, 4)]
    out.append((w2["2d_box_periodic_pod"], (16384, 16384)))
    return [(dataclasses.replace(
        w, spec=dataclasses.replace(w.spec, dtype=dtype)), g)
        for w, g in out]


def launches(work, chip):
    """``{key: (variant, plan)}``: one launch per calibration key the
    planner could use for ``work``'s program."""
    from repro_torch.core import blocking
    prog = work.spec
    out = {}
    for variant, kernel in blocking.CARRY_KERNELS.items():
        for plan in blocking.candidate_plans(
                prog, chip, max_par_time=32, variant=variant,
                block_candidates=[work.block_shape]):
            steps = plan.kernel_steps(kernel)
            if steps in STEPS:
                key = (blocking.launcher(plan, kernel), prog.shape,
                       prog.ndim, prog.radius, steps, plan.itemsize)
                out.setdefault(key, (variant, plan))
    return out


def time_kernels(chip, dtype: str = "float32"):
    """One row per calibration key of ``dtype``."""
    import torch
    from repro_torch.core import blocking
    from repro_torch.kernels import common, cuda
    rows = []
    for work, shape in configs(dtype):
        prog = work.spec
        coeffs = prog.default_coeffs().to("cuda")
        for key, (variant, plan) in sorted(launches(work, chip).items()):
            kernel = blocking.CARRY_KERNELS[variant]
            launch = getattr(cuda, kernel)
            layout = common.ring_schedule(prog, plan, shape, plan.par_time,
                                          variant=variant).layout
            gen = torch.Generator(device="cuda").manual_seed(0)
            src = torch.rand(layout.padded_shape, generator=gen,
                             device="cuda").to(getattr(torch, dtype))
            dst = torch.zeros_like(src)
            ms = median_ms(lambda: launch(
                src, dst, coeffs.center, coeffs.taps, program=prog,
                plan=plan, layout=layout))
            del src, dst
            tile, moved, flops, _ = blocking.launch_work(plan, kernel, chip)
            cells = math.prod(layout.rounded)
            bound = cells * max(moved / chip.hbm_bytes_per_s,
                                flops / (chip.peak_fp32_flops / 2))
            row = dict(key=list(key), config=work.name, kernel=kernel,
                       par_time=plan.par_time, tile=list(tile), cells=cells,
                       bytes_per_cell=moved, flops_per_cell=flops, ms=ms,
                       bound_ms=bound * 1e3,
                       efficiency=bound / (ms / 1e3 - LAUNCH_S))
            print(json.dumps(row), flush=True)
            rows.append(row)
        torch.cuda.empty_cache()
    return rows


def time_runs(chip, rows):
    """The one-superstep front-door run of each configuration's own plan
    against its launch: the run executor's fills and copies."""
    import torch
    import repro_torch
    from repro_torch.core import blocking
    from repro_torch.kernels import common
    launch_ms = {tuple(r["key"]): r["ms"] for r in rows
                 if r["kernel"] == "padded_superstep"}
    out = []
    for work, shape in configs():
        prog, plan = work.spec, work.plan()
        k = launch_ms.get((blocking.launcher(plan, "padded_superstep"),
                           prog.shape, prog.ndim, prog.radius,
                           plan.par_time, plan.itemsize))
        if k is None:
            continue
        grid = torch.rand(shape, device="cuda")
        cs = repro_torch.stencil(prog).compile(shape, steps=plan.par_time,
                                               plan=plan)
        ms = wall_ms(lambda: cs.run(grid))
        layout = common.ring_schedule(prog, plan, shape,
                                      plan.par_time).layout
        moved = 4 * (2 * math.prod(layout.padded_shape)
                     + 4 * math.prod(shape))
        wraps = LAUNCH_S * 1e3 if layout.wrap_axes else 0.0
        row = dict(config=work.name, wall_ms=ms, launch_ms=k,
                   copy_bytes=moved,
                   copy_efficiency=moved / chip.hbm_bytes_per_s
                   / ((ms - k - wraps) / 1e3))
        print(json.dumps(row), flush=True)
        out.append(row)
        del grid
        torch.cuda.empty_cache()
    return out


def module(card, rows, copy, kept=()) -> str:
    """The text of ``core/h100_calibration.py``: the measured ``rows``
    and the ``kept`` rows (``{"key", "efficiency"}``) of the other cell
    sizes."""
    rows = list(rows) + list(kept)
    per = {}
    for r in rows:
        per.setdefault((r["key"][0], r["key"][2], r["key"][5]), []).append(
            r["efficiency"])
    lines = [
        '"""Measured efficiencies of the carry kernels, for the H100 '
        'planner',
        "(``core/blocking.py``).",
        "",
        "Written by ``tools/planner_calibration.py`` from its run on "
        f"{card}:",
        "each efficiency is a launch's bound (``cells * max(bytes / hbm, "
        "flops /",
        "(peak / 2))`` from ``blocking.launch_work``) over its measured "
        "time less",
        "``LAUNCH_S``.  Run the tool on the card to renew it.",
        '"""',
        "",
        "#: The card and its power limit, as ``nvidia-smi`` prints them.",
        f"CARD = {card!r}",
        "#: Seconds one launch adds beside its work: B2, a launch with "
        "almost no",
        "#: work, took 0.032 ms per refresh in ``chip_smoke.py`` on the "
        "card above.",
        f"LAUNCH_S = {LAUNCH_S!r}",
        "#: Share of the memory rate the run executor's fills and copies "
        "reach: the",
        "#: median over the paper configurations of their bytes over a "
        "one-superstep",
        "#: front-door run's wall time less its launch.",
        f"COPY_EFFICIENCY = {copy!r}",
        "#: (launcher, shape, ndim, radius, fused steps, bytes per cell) -> "
        "share of",
        "#: the bound.",
        "EFFICIENCY = {",
    ]
    for r in sorted(rows, key=lambda r: r["key"]):
        lines.append(f"    {tuple(r['key'])!r}: {r['efficiency']!r},")
    lines += [
        "}",
        "#: (launcher, ndim, bytes per cell) -> the median of its rows "
        "above, for",
        "#: tap sets not measured.",
        "LAUNCHER_EFFICIENCY = {",
    ]
    for key in sorted(per):
        lines.append(f"    {key!r}: {statistics.median(per[key])!r},")
    lines.append("}")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default=os.path.join(
        ROOT, "build", "repro_torch", "h100_calibration.py"))
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16", "float16"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("planner_calibration: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.analysis.hw import GpuChip
    from repro_torch.core import h100_calibration as current
    from repro_torch.core.program import dtype_bytes
    from repro_torch.kernels import build
    build.build(dtypes=(args.dtype,))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {card}")
    chip = GpuChip.from_device(0)
    rows = time_kernels(chip, args.dtype)
    if args.dtype == "float32":
        runs = time_runs(chip, rows)
        copy = statistics.median(r["copy_efficiency"] for r in runs)
    else:
        copy = current.COPY_EFFICIENCY
    size = dtype_bytes(args.dtype)
    kept = [dict(key=list(k), efficiency=e)
            for k, e in current.EFFICIENCY.items() if k[5] != size]
    text = module(card, rows, copy, kept)
    out = args.out
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w", encoding="utf-8") as f:
        f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
