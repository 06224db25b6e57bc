"""A time-stepping simulation: one caller, closed loop, on the front door.

The mix gives ``steps_per_call``.  Set-up compiles the configuration's
program once, ``repro_torch.stencil(program, coeffs).compile(grid,
steps=..., plan="auto")`` (the planner users get by default),
with coefficients drawn from the seed, and warms it up with one call.
The window then makes back-to-back ``run`` calls, each on the previous
call's output, and waits for each to finish (a snapshot every
``steps_per_call`` steps), until ``--seconds`` have passed.

Checked answers: the window's first call, whose input is the seed's grid,
drawn again after the window; and one later call drawn from the seed
(reservoir sampling), whose input is the program's own state, kept by
reference (``run`` never writes its input).
"""

from __future__ import annotations

import random
import time

from stencilbench import inputs, work
from stencilbench.check import Answer
from stencilbench.harness import Window


class Loop:
    def __init__(self, ctx):
        self.ctx = ctx
        self.desc = ctx.config["program"]
        self.shape = tuple(ctx.config["grid"])
        self.steps = int(ctx.mix["steps_per_call"])
        self.cs = None
        self.grid0 = None
        self.first = None       # the first call's output
        self.sampled = None     # (call index, input, output)

    def setup(self) -> None:
        ctx, port = self.ctx, self.ctx.port
        ctx.build_kernels(self.desc["dtype"])
        center, taps = inputs.seeded_coeffs(self.desc, ctx.seed, ctx.device)
        self.center, self.taps = float(center), taps.tolist()
        program = port.StencilProgram(**self.desc)
        self.cs = port.stencil(program, port.ProgramCoeffs(center, taps)) \
            .compile(self.shape, steps=self.steps, plan="auto",
                     device=ctx.device)
        self.grid0 = inputs.grid(self.shape, ctx.seed, 0, ctx.device,
                                 inputs.dtype_of(self.desc))
        with ctx.span("bench.warmup"):
            out = self.cs.run(self.grid0)
            ctx.sync()
        del out

    def window(self, seconds: float) -> Window:
        ctx = self.ctx
        rng = random.Random(inputs.derived_seed(ctx.seed, "sample"))
        grid, self.grid0 = self.grid0, None
        calls = 0
        t0 = time.perf_counter()
        while True:
            with ctx.span("bench.run"):
                out = self.cs.run(grid)
                ctx.sync()
            if calls == 0:
                self.first = out
            elif rng.randrange(calls) == 0:
                self.sampled = (calls, grid, out)
            calls += 1
            grid = out
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        steps = work.cell_steps(self.shape, self.steps) * calls
        return Window(seconds=elapsed, cell_steps=steps,
                      flops=steps * work.flops_per_cell(self.desc),
                      bytes=calls * work.call_bytes(self.desc, self.shape),
                      attempted=calls, failed=0)

    def start_answers(self):
        """The answers whose inputs are the seed's own (the window's first
        call), with no output: what the control computes in the program's
        place.  Needs no set-up and no program."""
        ctx = self.ctx
        center, taps = inputs.seeded_coeffs(self.desc, ctx.seed, ctx.device)
        return [Answer("call 0",
                       lambda: inputs.grid(self.shape, ctx.seed, 0,
                                           ctx.device,
                                           inputs.dtype_of(self.desc)),
                       None, self.steps, float(center), taps.tolist())]

    def answers(self):
        out = self.start_answers()
        out[0].output = self.first
        if self.sampled is not None:
            i, src, got = self.sampled
            out.append(Answer(f"call {i}", lambda: src, got, self.steps,
                              self.center, self.taps))
        return out

    def close(self) -> None:
        self.cs = None
        self.first = self.sampled = None

