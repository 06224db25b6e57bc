"""The control of the comparison: the reference in the program's place,
computed one precision lower.

The precision is the configuration's ``check.control_dtype``: for the
float32 configurations, whose stencil has no matrix product, the step
below is bfloat16, the grid, the coefficients and every product and sum
in it.  For each seed the control takes the
answers whose inputs are the seed's own (the loop's ``start_answers``:
the first call of a simulation, every client's first request of a
served mix), at the cell's own sizes, and judges them as a run's answers
are judged.  A comparison that lets the control pass is no comparison.

    python3 stencilbench/control.py --workload 2d_r4_paper.sim \\
        --seeds 11,12,13

prints one JSON line per seed (``max_rel_err`` beside the configuration's
limit) on a CUDA card.  It runs neither the program nor its kernels.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Any, Dict, Optional

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from stencilbench import check, harness  # noqa: E402

def control_reading(workload: str, seed: int, device, *,
                    root: Path = ROOT,
                    overrides: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """The control's worst ``rel_err`` over the seed's start answers, and
    the configuration's limit."""
    root = Path(root)
    bench = harness.load_benchmark(root)
    cell, cfg_entry = harness.find_cell(bench, workload)
    config = {**harness.read_json(harness.config_file(root, cfg_entry)),
              **(overrides or {})}
    mix = harness.read_json(harness.mix_file(root, cell["traffic"]))
    reference = harness.load_module(root, "references", config["reference"])
    loop_module = harness.load_module(root, "loops", mix["loop"])
    ctx = harness.Context(config=config, mix=mix, seed=seed,
                          device=torch.device(device), port=None,
                          traced=False)
    answers = loop_module.Loop(ctx).start_answers()
    judged = check.judge(
        answers, config["program"], reference,
        dtype=check.precision(config, "reference_dtype"),
        program_dtype=check.precision(config, "control_dtype"))
    return {"workload": workload, "seed": seed,
            "answers": len(answers),
            "max_rel_err": judged["max_rel_err"],
            "limit": float(config["check"]["max_rel_err"])}


def main(argv=None) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(prog="python3 stencilbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, three or more")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card is visible", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",") if s):
        print(json.dumps(control_reading(args.workload, seed, "cuda")),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
