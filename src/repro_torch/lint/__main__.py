"""CLI of the port's pre-flight checks (counterpart of ``repro.lint``'s).

    python -m repro_torch.lint dataflow --ndim 2 --radius 1 \\
        --boundary periodic --grid 64,256 --steps 9    # the proof (RP4xx)
    python -m repro_torch.lint dataflow --devices 2,2 ...   # a mesh's proof
    python -m repro_torch.lint sanitize --ndim 2 --radius 1 \\
        --boundary periodic --grid 64,256 --steps 9    # the canary, on the card
    python -m repro_torch.lint sanitize --device cpu ...   # the plain versions
    python -m repro_torch.lint codes                   # the RP-code registry

The default plan is the H100 planner's (``core/blocking.plan_blocking``),
under ``--devices`` on one shard's extent, its block and ``par_time``
conformed to the shard as the reference's CLI does.  Exit status 1 when
any ERROR diagnostic fires, 0 otherwise (warnings print but never fail
the run); 2 for a request this port refuses: the canary on a mesh
(``sanitize --devices``: the canary runs one device's schedule, as the
reference's), or paths to lint (the codebase rules read JAX and Pallas;
lint the port with ``python -m repro.lint src tests``, ROADMAP A10).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.lint.diagnostics import (CODE_INFO, Diagnostic,
                                          DiagnosticError, error)

COMMANDS = ("dataflow", "sanitize", "codes")


def _render(diagnostics: List[Diagnostic], label: str,
            json_path: Optional[str]) -> int:
    diagnostics = sorted(diagnostics, key=lambda d: d.code)
    if json_path:
        with open(json_path, "w") as fh:
            json.dump([d.to_json() for d in diagnostics], fh, indent=2)
            fh.write("\n")
    for d in diagnostics:
        print(f"{d.severity.value}: {d.describe()}")
    errors = sum(1 for d in diagnostics if d.is_error)
    warnings = len(diagnostics) - errors
    if errors:
        print(f"{label}: {errors} error(s), {warnings} warning(s)",
              file=sys.stderr)
        return 1
    print(f"{label} OK: 0 errors, {warnings} warning(s)")
    return 0


def _parser(prog_name: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog_name)
    p.add_argument("--ndim", type=int, default=2, choices=(2, 3))
    p.add_argument("--radius", type=int, default=1)
    p.add_argument("--boundary", default="periodic",
                   choices=("clamp", "periodic", "constant"))
    p.add_argument("--grid", default=None,
                   help="comma-separated extents (default 64,256 / 16,64,256)")
    p.add_argument("--steps", type=int, default=None,
                   help="step count (default: 2 full supersteps + a "
                        "remainder)")
    p.add_argument("--variant", default="plain",
                   choices=("plain", "pipelined", "temporal"))
    p.add_argument("--block", default=None,
                   help="comma-separated block shape (default: the H100 "
                        "planner's)")
    p.add_argument("--par-time", type=int, default=None,
                   help="fused steps per superstep (default: the planner's)")
    p.add_argument("--json", default=None, help="write diagnostics JSON")
    p.add_argument("--devices", default=None,
                   help="comma-separated shards per grid axis (dataflow "
                        "only: the canary runs one device)")
    return p


def _config(ns, shards=None):
    """The (program, plan, grid, steps) both subcommands check; under
    ``shards`` the default plan blocks one shard's extent."""
    from repro_torch.core.blocking import (TEMPORAL_CHUNK, BlockPlan,
                                           plan_blocking)
    from repro_torch.core.program import StencilProgram

    prog = StencilProgram(ndim=ns.ndim, radius=ns.radius,
                          boundary=ns.boundary)
    if ns.grid:
        grid = tuple(int(s) for s in ns.grid.split(","))
    else:
        grid = (64, 256) if ns.ndim == 2 else (16, 64, 256)
    plan_shape = grid
    if shards is not None:
        if len(shards) != len(grid) or any(g % s for g, s in
                                           zip(grid, shards)):
            raise SystemExit(
                f"--devices {','.join(map(str, shards))} must divide the "
                f"grid {'x'.join(map(str, grid))} axis by axis")
        plan_shape = tuple(g // s for g, s in zip(grid, shards))
    # the planner only for what the flags leave open
    planned = None if ns.block and ns.par_time else plan_blocking(
        prog, grid_shape=plan_shape, variant=ns.variant).plan
    if planned is not None and shards is not None:
        # a shard takes blocks that tile it and a halo within it, as the
        # mesh tuner prunes; explicit --block/--par-time still override
        planned = BlockPlan(
            spec=prog,
            block_shape=tuple(b if b <= n and n % b == 0 else n
                              for b, n in zip(planned.block_shape,
                                              plan_shape)),
            par_time=max(1, min(planned.par_time,
                                min(plan_shape) // prog.halo_radius)))
    block = tuple(int(s) for s in ns.block.split(",")) if ns.block \
        else planned.block_shape
    plan = BlockPlan(spec=prog, block_shape=block,
                     par_time=ns.par_time or planned.par_time)
    period = plan.par_time * (TEMPORAL_CHUNK
                              if ns.variant == "temporal" else 1)
    steps = ns.steps if ns.steps is not None \
        else 2 * period + (1 if period > 1 else 0)
    return prog, plan, grid, steps


def _refused(message: str) -> int:
    print(f"repro_torch.lint: {message}", file=sys.stderr)
    return 2


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "codes":
        width = max(len(info.summary) for info in CODE_INFO.values())
        for code in sorted(CODE_INFO):
            info = CODE_INFO[code]
            print(f"{code}  {info.severity.value:<7}  "
                  f"{info.summary:<{width}}  fix: {info.hint}")
        return 0
    if not argv or argv[0] not in COMMANDS:
        return _refused(
            f"usage: python -m repro_torch.lint {{{','.join(COMMANDS)}}} "
            f"...; the codebase rules (RP3xx, a list of paths) read JAX "
            f"and Pallas and are not ported: lint the port with "
            f"`python -m repro.lint src tests` (ROADMAP A10)")
    command = argv[0]
    p = _parser(f"repro_torch.lint {command}")
    if command == "sanitize":
        p.add_argument("--device", default=None,
                       help="cuda (the default: the card's kernels) or cpu "
                            "(their plain versions)")
    ns = p.parse_args(argv[1:])
    shards = tuple(int(s) for s in ns.devices.split(",")) \
        if ns.devices else None
    if shards is not None and command == "sanitize":
        return _refused(DiagnosticError([error(
            "RP110",
            f"--devices {ns.devices}: the canary runs one device's "
            f"schedule, as the reference's does; prove a mesh's schedule "
            f"with `python -m repro_torch.lint dataflow --devices "
            f"{ns.devices}`",
            hint="drop --devices")]).args[0])
    prog, plan, grid, steps = _config(ns, shards)
    label = (f"{command} of {ns.ndim}D r={ns.radius} {ns.boundary} "
             f"{ns.variant} block={plan.block_shape} "
             f"par_time={plan.par_time} over {'x'.join(map(str, grid))}"
             + ("" if shards is None
                else f" on mesh {'x'.join(map(str, shards))}")
             + f", {steps} steps")
    if command == "dataflow":
        from repro_torch.lint.dataflow import verify_dataflow
        return _render(verify_dataflow(prog, plan, grid, steps=steps,
                                       variant=ns.variant, decomp=shards),
                       label, ns.json)
    from repro_torch.lint.sanitize import sanitize_run
    try:
        report = sanitize_run(prog, plan, grid, steps=steps,
                              variant=ns.variant, device=ns.device)
    except DiagnosticError as e:       # RP110: no card
        return _render(e.diagnostics, label, ns.json)
    print(report.describe())
    return _render(list(report.diagnostics), label, ns.json)


if __name__ == "__main__":
    sys.exit(main())
