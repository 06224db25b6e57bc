"""Time the superstep kernels (B1, B3, B4, B5, B6) at several column tiles
on one card.

    python3 tools/streamed_tile_sweep.py          # from the repo root
    python3 tools/streamed_tile_sweep.py B1 B6    # only those kernels

For the paper shapes that ``chip_smoke.py`` gives them, prints each
candidate in-plane tile's shared memory, its cost (B3/B4:
``streamed.column_cost``, what ``pick_streamed_tile`` minimises; B1/B6:
``QueuedPlanes.cost``, what ``pick_queued_tile`` minimises), the CTAs one
SM holds by shared memory and registers, and the median ms of 7 launches
after 2 warm-ups (CUDA events), beside the tile ``cuda.pick_tile`` takes:
it shows where the cost and the time disagree.  At the periodic box every
kernel runs the streamed kernel (B1 and B5 one-shot, B4 and B6
persistent; B5 and B6 in its pre-padded mode).  Needs a CUDA card; exits
non-zero without one.
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def median_ms(fn, runs: int = 7) -> float:
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


#: Shared memory of one SM; the queued and streamed kernels' register
#: budget allows two CTAs per SM.
SM_SMEM = 233472
REGISTER_CTAS = 2


def ctas_per_sm(smem: int) -> int:
    from repro_torch.kernels.queued import CTA_RESERVED
    return min(REGISTER_CTAS, SM_SMEM // (smem + CTA_RESERVED))


def cases():
    """(label, program, plan, kernel, grid, tiles)."""
    from repro_torch.configs import stencil2d, stencil3d
    w2 = stencil2d.workloads()
    w3 = stencil3d.workloads()
    r2 = w3["3d_r2_paper"]
    box = w2["2d_box_periodic_pod"]
    return [
        ("B3 2d_r4_paper", w2["2d_r4_paper"], w2["2d_r4_paper"].plan(),
         "temporal_superstep", (16384, 16384),
         [(128,), (160,), (192,), (224,), (256,), (320,), (448,)]),
        ("B3 3d_r2_paper par_time 1", r2,
         dataclasses.replace(r2.plan(), par_time=1), "temporal_superstep",
         r2.grid_shape,
         [(4, 32), (8, 32), (4, 64), (16, 32), (8, 64), (16, 64),
          (32, 32)]),
        ("B4 3d_r4_paper", w3["3d_r4_paper"], w3["3d_r4_paper"].plan(),
         "padded_pipelined", w3["3d_r4_paper"].grid_shape,
         [(16, 32), (32, 32), (16, 64), (32, 64), (32, 96), (8, 128),
          (16, 128)]),
        ("B4 2d_box_periodic_pod 16384^2", box, box.plan(),
         "padded_pipelined", (16384, 16384),
         [(224,), (480,), (736,), (992,)]),
        ("B1 2d_r4_paper", w2["2d_r4_paper"], w2["2d_r4_paper"].plan(),
         "padded_superstep", (16384, 16384),
         [(496,), (744,), (992,), (1008,)]),
        ("B1 2d_box_periodic_pod 16384^2", box, box.plan(),
         "padded_superstep", (16384, 16384),
         [(224,), (480,), (736,), (992,)]),
        ("B5 2d_box_periodic_pod 16384^2", box, box.plan(), "superstep",
         (16384, 16384), [(224,), (480,), (736,), (992,)]),
        ("B6 2d_box_periodic_pod 16384^2", box, box.plan(),
         "pipelined_superstep", (16384, 16384),
         [(224,), (480,), (736,), (992,)]),
        ("B5 2d_r4_paper", w2["2d_r4_paper"], w2["2d_r4_paper"].plan(),
         "superstep", (16384, 16384), [(496,), (744,), (992,), (1008,)]),
        ("B1 3d_r4_paper", w3["3d_r4_paper"], w3["3d_r4_paper"].plan(),
         "padded_superstep", w3["3d_r4_paper"].grid_shape,
         [(10, 96), (10, 72), (12, 64), (14, 56), (16, 48), (20, 40),
          (24, 32)]),
        ("B5 3d_r4_paper", w3["3d_r4_paper"], w3["3d_r4_paper"].plan(),
         "superstep", w3["3d_r4_paper"].grid_shape,
         [(10, 96), (10, 72), (12, 64), (14, 56), (16, 48), (20, 40),
          (24, 32)]),
        ("B6 3d_r4_paper", w3["3d_r4_paper"], w3["3d_r4_paper"].plan(),
         "pipelined_superstep", w3["3d_r4_paper"].grid_shape,
         [(10, 96), (10, 72), (12, 64), (14, 56), (16, 48), (20, 40),
          (24, 32)]),
    ]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("streamed_tile_sweep: no CUDA device visible",
              file=sys.stderr)
        return 2
    from repro_torch.core.blocking import queued_planes
    from repro_torch.kernels import common, cuda, streamed

    limit = cuda.smem_optin(0)
    print(f"{torch.cuda.get_device_name(0)}; {limit} bytes of shared "
          f"memory per block")
    only = sys.argv[1:]
    for label, work, plan, kernel, shape, tiles in cases():
        if only and label.split()[0] not in only:
            continue
        prog = work.spec
        variant = {"temporal_superstep": "temporal",
                   "padded_pipelined": "pipelined"}.get(kernel, "plain")
        steps = plan.kernel_steps(kernel)
        coeffs = prog.default_coeffs().to("cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        if kernel in ("superstep", "pipelined_superstep"):
            h = plan.halo
            src = torch.rand(tuple(n + 2 * h for n in shape),
                             generator=gen, device="cuda")
            launch = {"superstep": cuda.superstep,
                      "pipelined_superstep": cuda.pipelined_superstep}[kernel]
            runs = {"": lambda t: launch(
                src, coeffs.center, coeffs.taps, program=prog, plan=plan,
                true_shape=shape, tile=t)}
        else:
            layout = common.ring_schedule(prog, plan, shape, plan.par_time,
                                          variant=variant).layout
            src = torch.rand(layout.padded_shape, generator=gen,
                             device="cuda")
            dst = torch.zeros_like(src)
            launch = {"temporal_superstep": cuda.temporal_superstep,
                      "padded_pipelined": cuda.padded_pipelined,
                      "padded_superstep": cuda.padded_superstep}[kernel]

            def run(t, **kw):
                return launch(src, dst, coeffs.center, coeffs.taps,
                              program=prog, plan=plan, layout=layout,
                              tile=t, **kw)

            runs = {"": run}
        print(f"{label}: {plan.body(kernel)} body, pick "
              f"{cuda.pick_tile(plan, kernel, limit)}")
        for tile in tiles:
            need = plan.smem_bytes_for(tile, kernel)
            if plan.body(kernel) == "streamed":
                cost = streamed.column_cost(prog.ndim, prog.halo_radius,
                                            steps, tile)
            else:
                cost = queued_planes(prog, steps, tile).cost
            if need > limit:
                print(f"  {tile}: {need} bytes, does not fit")
                continue
            times = ", ".join(
                f"{median_ms(lambda: fn(tile))!r} ms{how}"
                for how, fn in runs.items())
            print(f"  {tile}: {need} bytes, {ctas_per_sm(need)} CTAs per "
                  f"SM, cost {cost!r}, {times}")
        del src
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
