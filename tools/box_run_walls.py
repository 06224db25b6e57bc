"""Time the front door's periodic box runs on one card, from the package
under a given source directory.

    python3 tools/box_run_walls.py                      # this checkout
    python3 tools/box_run_walls.py --src OTHER/src --runs 9

Drives ``2d_box_periodic_pod`` at 16384^2 (the grid ``chip_smoke.py`` cuts
it to) for 10 steps through ``repro_torch.stencil(...).compile(...).run``
under the plain and the pipelined variant, as ``chip_smoke.py`` does: one
warm-up run, then ``--runs`` runs, each timed with the host clock around
a run that ends in ``torch.cuda.synchronize()``.  Prints every wall time
and the median per variant, with the card's name and power limit.  To
compare two checkouts, run it against each in turns (parent, change,
change, parent) within one call on the card.  Needs a CUDA card; exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(HERE, "src"),
                    help="directory that holds the repro_torch package")
    ap.add_argument("--runs", type=int, default=9)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("box_run_walls: no CUDA device visible", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.configs import stencil2d

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{smi}; repro_torch from {os.path.dirname(repro_torch.__file__)}")
    work = stencil2d.workloads()["2d_box_periodic_pod"]
    shape = (16384, 16384)
    gen = torch.Generator(device="cuda").manual_seed(0)
    grid = torch.rand(shape, generator=gen, device="cuda") * 2 - 1
    for variant in ("plain", "pipelined"):
        cs = repro_torch.stencil(work.spec).compile(
            shape, steps=10, plan=work.plan(), variant=variant)
        cs.run(grid)  # lint-ok: RP302 (a warm-up; synchronised below)
        torch.cuda.synchronize()
        walls = []
        for _ in range(args.runs):
            t0 = time.perf_counter()
            cs.run(grid)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        print(f"{variant}: wall ms {walls!r}; median "
              f"{statistics.median(walls)!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
