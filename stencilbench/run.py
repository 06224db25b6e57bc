"""Run one cell of BENCHMARK.json once and print its result line.

    python3 stencilbench/run.py --workload 2d_r4_paper.sim --seed 7 \\
        --seconds 10 --trace 0

From the root of a checkout.  Set-up (imports, the kernel build where it
is missing, planning, the inputs from ``--seed``, a warm-up call) is
followed by a window of ``--seconds``; then the checked answers are
judged against the configuration's plain reference.  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics read from a ``torch.profiler`` trace
of the window), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``: each number compared beside its limit, which also end
standard error.

Exits non-zero with no result line where no CUDA card is visible, where
fewer cards are visible than the cell asks for, where the checkout holds
no program, or where jax, the JAX package or the old benchmark was
loaded.  Every cache the run writes stays in the checkout's ``build/``.
"""

from __future__ import annotations

import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def process_start() -> float:
    """This process's start on ``time.time()``'s clock (to a hundredth of
    a second, from ``/proc``), or now where ``/proc`` has no answer."""
    now = time.time()
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime", encoding="ascii") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return now - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return now


T_START = process_start()


def cache_environment(root: Path) -> None:
    """Fixed cache directories inside the checkout, and the port's flight
    recorder and history ledger off: the window runs as a user's would."""
    cache = root / "build" / "stencilbench"
    os.environ["REPRO_TORCH_TUNING_CACHE"] = str(cache / "plans.json")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["REPRO_TORCH_OBS"] = "0"
    os.environ["REPRO_TORCH_OBS_HISTORY"] = ""
    os.environ["USE_FLAX"] = "0"


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    "not read"."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out[0] if out else "not read"


def finite(value):
    """A reading as JSON can hold it: an infinite or NaN one as the
    largest float, which fails every limit."""
    if isinstance(value, float) and not math.isfinite(value):
        return sys.float_info.max
    return value


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="python3 stencilbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache_environment(ROOT)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import json

    import torch

    from stencilbench import harness

    bench = harness.load_benchmark(ROOT)
    cell, _ = harness.find_cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("stencilbench: no CUDA card is visible", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"stencilbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result, checks = harness.run_cell(
        args.workload, seed=args.seed, seconds=args.seconds,
        traced=bool(args.trace), device="cuda", t_start=T_START, root=ROOT)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"stencilbench: forbidden modules were loaded: "
              f"{', '.join(loaded)}", file=sys.stderr)
        return 3
    result["card"] = power_limit()
    result["checks"] = {k: {n: finite(v) for n, v in c.items()}
                        for k, c in checks.items()}
    print(json.dumps(result, allow_nan=False), flush=True)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
