"""Quickstart on the H100: high-order heat diffusion through the port's
front door.

The PyTorch port's counterpart of ``examples/quickstart.py``: describes a
radius-4 2D stencil (the paper's hardest 2D case) as a
``StencilProgram``, compiles it through ``repro_torch.stencil(program)
.compile(grid_shape, steps=...)``, which resolves the blocking plan (the
H100 autotuner and its plan cache), the backend and the H100 model's
cost, then runs it on the card and checks it against the plain oracle.
It imports only torch, numpy and ``repro_torch``.

    PYTHONPATH=src python examples/quickstart_torch.py               # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # plain versions

``--steps`` sets the run's length (8 by default, as the reference's
example): at 16 the temporal run below is one chunk-deep launch of the
temporal kernel, at 8 its one superstep runs as a plain one.
"""

import argparse

import torch

import repro_torch
from repro_torch.core.blocking import estimate
from repro_torch.core.perf_model import predicted_gbps
from repro_torch.kernels.ref import program_nsteps_unrolled, random_grid


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="a CUDA device (the default; RP110 without one) "
                         "or 'cpu'")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)

    program = repro_torch.StencilProgram(ndim=2, radius=4, shape="star",
                                         boundary="clamp")
    print(f"program: 2D star radius={program.radius}  "
          f"taps={program.num_taps}  "
          f"FLOP/cell={program.flops_per_cell} (paper Table I: 33)")

    # one front door: plan="auto" searches the legal (block, par_time)
    # space, ranks it by the H100 model and caches the winner; the second
    # compile for this (program, grid, card, backend) is a cache hit.
    # variant="plain" keeps the search to the plain kernel, the run the
    # temporal variant is held against below
    grid_shape = (256, 512)
    steps = args.steps
    cs = repro_torch.stencil(program).compile(
        grid_shape, steps=steps, plan="auto", max_par_time=4,
        variant="plain", device=args.device)
    plan = cs.plan
    est = estimate(plan, cs.chip, cs.variant)
    smem = plan.smem_bytes_for(est.tile, est.kernel)
    print(f"backend: {cs.backend} v{cs.backend_version} on {cs.device}"
          f"{'  [plan cache]' if cs.from_plan_cache else ''}")
    print(f"plan: block={plan.block_shape} par_time={plan.par_time} "
          f"halo={plan.halo} shared memory={smem / 2**10:.1f} KiB per CTA "
          f"({est.body} body, column tile {est.tile})")
    print(f"{cs.chip.name} model: {est.gcells_per_s:.0f} GCell/s "
          f"{est.gflops_per_s:.0f} GFLOP/s ({est.bound}-bound), effective "
          f"{predicted_gbps(program, plan, cs.chip, cs.variant):.0f} GB/s"
          f" vs {cs.chip.hbm_bytes_per_s / 1e9:.0f} GB/s HBM")

    grid = random_grid(program, grid_shape, seed=0).to(cs.device)
    out = cs.run(grid)
    want = program_nsteps_unrolled(program, cs.coeffs, grid, steps)
    err = float((out - want).abs().max())
    assert torch.allclose(out, want, atol=1e-4), err
    print(f"{steps} steps via temporal blocking == naive reference "
          f"(max err {err:.2e})  OK")

    # kernel variants ride the same front door: variant="temporal" fuses a
    # whole chunk of supersteps into each launch (one window held on chip,
    # a fraction of the plain run's device-memory traffic), the same
    # arithmetic as the plain kernel
    cst = repro_torch.stencil(program).compile(
        grid_shape, steps=steps, plan=plan, variant="temporal",
        device=args.device)
    outt = cst.run(grid)
    assert torch.allclose(outt, out, atol=1e-6, rtol=1e-5)
    ratio = plan.run_bytes_per_superstep(grid_shape, "temporal") \
        / plan.run_bytes_per_superstep(grid_shape)
    print(f"variant={cst.variant}: matches plain at ulp; modeled "
          f"device-memory bytes/superstep {ratio:.2f}x of plain  OK")

    # the same handle compiles every execution shape: a batched executable
    # runs B independent grids in one run
    B = 2
    csb = repro_torch.stencil(program).compile(
        grid_shape, steps=steps, plan=plan, batch=B, device=args.device)
    outs = csb.run(torch.stack([grid, grid]))
    assert outs.shape == (B, *grid_shape)
    assert torch.equal(outs[0], out) and torch.equal(outs[1], out)
    print(f"batched: {B} grids, one executable, bit-equal to the single "
          f"run  OK")
    print("(multi-device: compile(devices=N) searches mesh decompositions; "
          "see README)")
    return {"grid": grid, "out": out, "temporal": outt, "batched": outs,
            "plan": plan, "coeffs": cs.coeffs, "steps": steps}


if __name__ == "__main__":
    main()
