"""CLI of the port's checks (counterpart of ``repro.lint``'s).

    python -m repro_torch.lint src/repro_torch tests   # codebase rules (RP3xx)
    python -m repro_torch.lint src --json diag.json    # + a JSON dump
    python -m repro_torch.lint audit --ndim 2 --radius 1 \\
        --boundary periodic --grid 64,256 --steps 9    # launch audit (RP2xx)
    python -m repro_torch.lint audit --device cpu ...   # the plain versions
    python -m repro_torch.lint dataflow --ndim 2 --radius 1 \\
        --boundary periodic --grid 64,256 --steps 9    # the proof (RP4xx)
    python -m repro_torch.lint dataflow --devices 2,2 ...   # a mesh's proof
    python -m repro_torch.lint sanitize --ndim 2 --radius 1 \\
        --boundary periodic --grid 64,256 --steps 9    # the canary, on the card
    python -m repro_torch.lint sanitize --device cpu ...   # the plain versions
    python -m repro_torch.lint codes                   # the RP-code registry

The default plan is the H100 planner's (``core/blocking.plan_blocking``),
under ``--devices`` on one shard's extent, its block and ``par_time``
conformed to the shard as the reference's CLI does.  ``audit`` compiles
that run through the front door, runs it once cold, then audits one warm
run: its launches and result (``lint/artifact.analyze_launches``) and its
trace budget of 0 (RP203).  Exit status 1 when any ERROR diagnostic
fires, 0 otherwise (warnings print but never fail the run); 2 for the
canary on a mesh (``sanitize --devices``: the canary runs one device's
schedule, as the reference's).  Findings print sorted by (path, line,
code).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.lint.diagnostics import (CODE_INFO, Diagnostic,
                                          DiagnosticError, error)

COMMANDS = ("audit", "dataflow", "sanitize", "codes")


def _render(diagnostics: List[Diagnostic], label: str,
            json_path: Optional[str]) -> int:
    diagnostics = sorted(diagnostics,
                         key=lambda d: (d.path or "", d.line or 0, d.code))
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
                        "only: the canary and the audit run one device)")
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


def _lint(argv: List[str]) -> int:
    """The codebase rules over paths (the reference's default command)."""
    from repro_torch.lint.engine import lint_paths, to_json
    p = argparse.ArgumentParser(prog="repro_torch.lint")
    p.add_argument("paths", nargs="+", help="files/trees to lint")
    p.add_argument("--json", default=None, help="write diagnostics JSON")
    ns = p.parse_args(argv)
    diags = lint_paths(ns.paths)
    if ns.json:
        with open(ns.json, "w") as fh:
            fh.write(to_json(diags))
    return _render(diags, f"lint of {' '.join(ns.paths)}", None)


def _audit(ns, prog, plan, grid, steps, label: str) -> int:
    """Compile the run through the front door, run it once cold, then
    audit one warm run: its launches and result, and its trace budget."""
    import torch

    import repro_torch
    from repro_torch.core.program import torch_dtype
    from repro_torch.kernels import common
    from repro_torch.lint.artifact import audit_run, check_trace_budget
    try:
        cs = repro_torch.stencil(prog).compile(
            grid, steps=steps, plan=plan, variant=ns.variant,
            device=ns.device)
    except DiagnosticError as e:       # RP110: no card
        return _render(e.diagnostics, label, ns.json)
    gen = torch.Generator().manual_seed(0)
    g = (torch.rand(grid, generator=gen) * 2 - 1).to(
        cs.device, torch_dtype(prog.dtype))
    cs.run(g)
    before = common.trace_counts()
    out, diags = audit_run(cs.run, g, expect_dtype=prog.dtype)
    delta = common.trace_delta(before)
    diags += check_trace_budget(delta, 0, context="a warm run")
    if cs.device.type == "cuda":
        torch.cuda.synchronize(cs.device)
    print(f"warm run on {cs.device}: result {tuple(out.shape)} "
          f"{out.dtype}, trace delta {delta}")
    return _render(diags, label, ns.json)


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
        return _lint(argv)
    command = argv[0]
    p = _parser(f"repro_torch.lint {command}")
    if command in ("sanitize", "audit"):
        p.add_argument("--device", default=None,
                       help="cuda (the default: the card's kernels) or cpu "
                            "(their plain versions)")
    ns = p.parse_args(argv[1:])
    shards = tuple(int(s) for s in ns.devices.split(",")) \
        if ns.devices else None
    if shards is not None and command in ("sanitize", "audit"):
        return _refused(DiagnosticError([error(
            "RP110",
            f"--devices {ns.devices}: the {command} runs one device's "
            f"schedule, as the reference's canary does; prove a mesh's "
            f"schedule with `python -m repro_torch.lint dataflow "
            f"--devices {ns.devices}`",
            hint="drop --devices")]).args[0])
    prog, plan, grid, steps = _config(ns, shards)
    label = (f"{command} of {ns.ndim}D r={ns.radius} {ns.boundary} "
             f"{ns.variant} block={plan.block_shape} "
             f"par_time={plan.par_time} over {'x'.join(map(str, grid))}"
             + ("" if shards is None
                else f" on mesh {'x'.join(map(str, shards))}")
             + f", {steps} steps")
    if command == "audit":
        return _audit(ns, prog, plan, grid, steps, label)
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
