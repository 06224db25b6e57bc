"""Autotuner CLI — counterpart of ``repro/tuning/cli.py``.

    python -m repro_torch.tuning tune --ndim 2 --radius 4 --grid 16384,16384
    python -m repro_torch.tuning tune --ndim 3 --radius 2 \\
        --grid 512,1024,704 --variant auto --no-measure
    python -m repro_torch.tuning tune --ndim 2 --radius 1 --grid 64,256 \\
        --device cpu --top-k 2 --cache /tmp/plans.json
    python -m repro_torch.tuning inspect [--cache PATH]
    python -m repro_torch.tuning clear-cache [--cache PATH]

``tune`` prints the space and frontier sizes, each measured frontier
candidate's predicted and measured ms, and the winning plan; ``inspect``
prints the cache's records.  ``tune`` runs on the CUDA card unless given
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core.program import StencilProgram


def _parse_shape(text: str):
    try:
        return tuple(int(p) for p in text.replace("x", ",").split(",") if p)
    except ValueError:
        raise argparse.ArgumentTypeError(f"bad shape {text!r}")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="repro_torch.tuning",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("tune", help="search + rank + measure + cache a plan")
    t.add_argument("--ndim", type=int, default=2, choices=(2, 3))
    t.add_argument("--radius", type=int, default=4)
    t.add_argument("--shape", default="star",
                   choices=("star", "box", "diamond"))
    t.add_argument("--boundary", default="clamp",
                   choices=("clamp", "periodic", "constant"))
    t.add_argument("--grid", type=_parse_shape, required=True,
                   help="grid shape, e.g. 16384,16384")
    t.add_argument("--backend", default=None,
                   help="backend name (default: cuda)")
    t.add_argument("--variant", default=None,
                   choices=("auto", "plain", "pipelined", "temporal"),
                   help="'auto' searches every variant sibling of "
                        "--backend, a name pins that lowering (default: "
                        "the backend as given)")
    t.add_argument("--top-k", type=int, default=5,
                   help="measured frontier size")
    t.add_argument("--max-par-time", type=int, default=32)
    t.add_argument("--bsize", type=_parse_shape, action="append",
                   default=None, metavar="BLOCK",
                   help="a block candidate (repeatable), e.g. "
                        "--bsize 1024,1024")
    t.add_argument("--no-measure", action="store_true",
                   help="model-only ranking (no timing)")
    t.add_argument("--force", action="store_true",
                   help="ignore any cached plan and re-tune")
    t.add_argument("--cache", default=None, help="plan-cache path")
    t.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card); 'cpu' "
                        "plans, or times the plain versions, on the CPU")

    i = sub.add_parser("inspect", help="print cached plans")
    i.add_argument("--cache", default=None, help="plan-cache path")

    c = sub.add_parser("clear-cache", help="delete the plan cache")
    c.add_argument("--cache", default=None, help="plan-cache path")
    return p


def _cmd_tune(args) -> int:
    from repro_torch import tuning

    program = StencilProgram(ndim=args.ndim, radius=args.radius,
                             shape=args.shape, boundary=args.boundary)
    tuned = tuning.autotune(
        program, grid_shape=args.grid, backend=args.backend,
        variant=args.variant, top_k=args.top_k,
        measure=not args.no_measure, cache_path=args.cache,
        force=args.force, bsizes=args.bsize,
        max_par_time=args.max_par_time, device=args.device)
    src = "cache" if tuned.from_cache else \
        f"search (space={tuned.space_size}, frontier={tuned.frontier_size})"
    print(f"program: {args.ndim}D {args.shape} r={args.radius} "
          f"{args.boundary} on grid {'x'.join(map(str, args.grid))}")
    for m in tuned.measurements:
        print(f"  {m.describe()}")
    print(f"plan [{src}]: block={tuned.plan.block_shape} "
          f"par_time={tuned.plan.par_time} "
          f"backend={tuned.backend}@v{tuned.backend_version} "
          f"variant={tuned.variant}")
    print(f"model: {tuned.predicted_gbps:.2f} effective GB/s predicted")
    m = tuned.measurement
    if m is not None:
        print(f"measured on {m.device}: {m.achieved_gbps:.3f} GB/s "
              f"({m.achieved_gflops:.3f} GFLOP/s, {m.measured_ms:.4f} ms "
              f"for {m.steps} steps against {m.predicted_ms:.4f} "
              f"predicted, model accuracy {m.model_accuracy:.3f})")
    print(f"cache key: {tuned.key}")
    return 0


def _cmd_inspect(args) -> int:
    from repro_torch.tuning.cache import PlanCache

    store = PlanCache(args.cache)
    flat = [(key, rec) for key, recs in sorted(store.entries().items())
            for rec in (recs if isinstance(recs, list) else [recs])]
    print(f"# {store.path}: {len(flat)} plan(s)")
    for key, rec in flat:
        prog = rec.get("program", {})
        m = rec.get("measurement")
        print(json.dumps({
            "key": key[:12],
            "program": f"{prog.get('ndim')}d_{prog.get('shape')}"
                       f"_r{prog.get('radius')}_{prog.get('boundary')}",
            "block": rec.get("block_shape"),
            "par_time": rec.get("par_time"),
            "variant": rec.get("variant", "plain"),
            "backend": f"{rec.get('backend')}@v{rec.get('backend_version')}",
            "predicted_gbps": round(rec.get("predicted_gbps", 0.0), 3),
            "measured_on": None if m is None else m.get("device"),
            "measured_gbps": None if m is None
            else round(m.get("achieved_gbps", 0.0), 3),
        }))
    return 0


def _cmd_clear(args) -> int:
    from repro_torch.tuning.cache import PlanCache

    store = PlanCache(args.cache)
    print(f"cleared {store.clear()} plan(s) from {store.path}")
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.cmd == "tune":
        return _cmd_tune(args)
    if args.cmd == "inspect":
        return _cmd_inspect(args)
    return _cmd_clear(args)


if __name__ == "__main__":
    sys.exit(main())
