"""Time the streamed kernels (B3, B4) at several column tiles on one card.

    python3 tools/streamed_tile_sweep.py      # from the repo root

For the paper shapes that ``chip_smoke.py`` gives B3 and B4, prints each
candidate in-plane tile's shared memory, column cost
(``repro_torch.kernels.streamed.column_cost``, what
``pick_streamed_tile`` minimises) and median ms of 7 launches after 2
warm-ups (CUDA events), beside the tile ``cuda.pick_tile`` takes: it
shows where the column cost and the time disagree.  Needs a CUDA card;
exits non-zero without one.
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
    ]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("streamed_tile_sweep: no CUDA device visible",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import common, cuda, streamed

    limit = cuda.smem_optin(0)
    print(f"{torch.cuda.get_device_name(0)}; {limit} bytes of shared "
          f"memory per block")
    for label, work, plan, kernel, shape, tiles in cases():
        prog = work.spec
        variant = "temporal" if kernel == "temporal_superstep" \
            else "pipelined"
        layout = common.ring_schedule(prog, plan, shape, plan.par_time,
                                      variant=variant).layout
        gen = torch.Generator(device="cuda").manual_seed(0)
        src = torch.rand(layout.padded_shape, generator=gen, device="cuda")
        dst = torch.zeros_like(src)
        coeffs = prog.default_coeffs().to("cuda")
        launch = {"temporal_superstep": cuda.temporal_superstep,
                  "padded_pipelined": cuda.padded_pipelined}[kernel]
        steps = plan.kernel_steps(kernel)
        print(f"{label}: pick {cuda.pick_tile(plan, kernel, limit)}")
        for tile in tiles:
            need = streamed.streamed_need(prog, steps, tile)
            cost = streamed.column_cost(prog.ndim, prog.halo_radius, steps,
                                        tile)
            if need > limit:
                print(f"  {tile}: {need} bytes, does not fit")
                continue
            ms = median_ms(lambda: launch(
                src, dst, coeffs.center, coeffs.taps, program=prog,
                plan=plan, layout=layout, tile=tile))
            print(f"  {tile}: {need} bytes, column cost {cost!r}, "
                  f"{ms!r} ms")
        del src, dst
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
