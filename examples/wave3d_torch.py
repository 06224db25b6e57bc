"""3D acoustic wave propagation with a 4th-order star stencil on the H100:
the seismic workload class the paper targets (its refs [1], [19] are
RTM/earthquake codes).

The PyTorch port's counterpart of ``examples/wave3d.py``.  The scalar wave
equation u_tt = c^2 ∇²u, discretised with a radius-4 Laplacian, is a
repeated LINEAR star-stencil operator, exactly the paper's kernel with
particular coefficients.  It runs through the port's front door with
temporal blocking on the card and checks that the energy stays bounded
(CFL respected).  It imports only torch, numpy and ``repro_torch``.

    PYTHONPATH=src python examples/wave3d_torch.py               # the card
    PYTHONPATH=src python examples/wave3d_torch.py --device cpu  # plain versions
"""

import argparse

import numpy as np
import torch

import repro_torch
from repro_torch.core import StencilProgram
from repro_torch.core.blocking import BlockPlan
from repro_torch.core.program import ProgramCoeffs


def laplacian_coeffs(program: StencilProgram,
                     courant2: float) -> ProgramCoeffs:
    """4th-order-accurate central-difference Laplacian weights (radius 4),
    folded into the paper's update  u' = c_c*u + sum c_i u_i.

    The Laplacian is distance-symmetric, so the weights are the IR's
    *distance-shared* coefficient case: one value per shell, expanded to
    the full tap vector by ``coeffs_from_shells``.

    The damped-wave surrogate applies  u' = u + k * L(u)  with
    k = courant^2: a single-grid linear stencil (the (u, u_prev) leapfrog
    needs 2 fields; the single-field form is the heat-kernel-like limit,
    which exercises the identical compute/memory pattern)."""
    # 8th-order central difference weights for d2/dx2, radius 4:
    w = np.array([-205.0 / 72, 8.0 / 5, -1.0 / 5, 8.0 / 315, -1.0 / 560])
    center = np.float32(1.0 + 3 * w[0] * courant2)
    shells = (w[1:] * courant2).astype(np.float32)
    return program.coeffs_from_shells(torch.tensor(center),
                                      torch.from_numpy(shells))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="a CUDA device (the default; RP110 without one) "
                         "or 'cpu'")
    args = ap.parse_args(argv)

    spec = StencilProgram(ndim=3, radius=4, shape="star",
                          coeff_sharing="distance")
    courant2 = 0.05   # well inside stability for the surrogate update
    coeffs = laplacian_coeffs(spec, courant2)

    shape = (32, 48, 256)
    plan = BlockPlan(spec=spec, block_shape=(8, 16, 128), par_time=2)

    # one superstep (= par_time steps) per executor call, through the front
    # door; every call reuses the same compiled executable
    cs = repro_torch.stencil(spec, coeffs=coeffs).compile(
        shape, steps=plan.par_time, plan=plan, device=args.device)

    # Gaussian pulse source
    z, y, x = torch.meshgrid(*[torch.arange(s, device=cs.device)
                               for s in shape], indexing="ij")
    r2 = ((z - 16) ** 2 + (y - 24) ** 2 + (x - 128) ** 2).to(torch.float32)
    u0 = u = torch.exp(-r2 / 50.0)

    e0 = float(torch.sum(u ** 2))
    energies = []
    for superstep in range(4):
        u = cs.run(u)
        e = float(torch.sum(u ** 2))
        energies.append(e)
        print(f"superstep {superstep} ({(superstep + 1) * plan.par_time:2d} "
              f"steps): energy={e:.4f} (e/e0={e / e0:.3f}) "
              f"max|u|={float(torch.max(torch.abs(u))):.4f}")
        assert np.isfinite(e) and e <= e0 * 1.01, "instability!"

    cells = shape[0] * shape[1] * shape[2]
    total_flops = cells * 8 * spec.flops_per_cell
    print(f"done: {cells:,} cells x 8 steps, {total_flops / 1e6:.0f} MFLOP, "
          f"radius-4 pulse propagated without blow-up  OK")
    return {"program": spec, "coeffs": cs.coeffs, "u0": u0, "u": u,
            "e0": e0, "energies": energies}


if __name__ == "__main__":
    main()
