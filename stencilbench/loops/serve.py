"""Closed-loop clients of the stencil server.

The mix gives ``clients``, ``max_batch`` and ``steps_per_request``.
Set-up starts one ``repro_torch.launch.stencil_serve.StencilServer(
max_batch=...)`` and draws each client's grid from the seed in the
configuration's dtype; one warm-up flush of every client's request
compiles and runs the chunk shapes the window uses.  In the window each
client submits its grid for ``steps_per_request`` steps, the loop calls
``flush()`` on everything pending, and each client takes its result as
its next grid.

The server takes no coefficients: it runs the program's default ones,
which the reference gets from the benchmark's own copy of that draw
(``inputs.program_default_coeffs``).

Checked answers (up to :data:`PER_FLUSH` requests of each flush, drawn
from the seed where it holds more): the first flush's, whose inputs are
the seed's grids, drawn again after the window; and the last flush's,
whose inputs are the program's own state and whose results are still
held when the window closes.  Nothing is copied inside the window: the
loop keeps only references to what the clients hold anyway.

A request's latency runs from just before its ``submit`` to the return
of the ``flush()`` that resolved it.  A request the flush does not
answer is failed; its client submits its old grid again.
"""

from __future__ import annotations

import importlib
import random
import time

from stencilbench import inputs, work
from stencilbench.check import Answer
from stencilbench.harness import Window

#: Requests judged of the window's first flush and of its last.
PER_FLUSH = 8


class Loop:
    def __init__(self, ctx):
        self.ctx = ctx
        mix = ctx.mix
        self.desc = ctx.config["program"]
        self.shape = tuple(ctx.config["grid"])
        self.steps = int(mix["steps_per_request"])
        self.clients = int(mix["clients"])
        self.max_batch = int(mix["max_batch"])
        self.server = None
        self.start = None
        self.first = {}         # client -> output of the first flush
        self.last = None        # (flush, {client: (input, output)})

    def setup(self) -> None:
        ctx, port = self.ctx, self.ctx.port
        ctx.build_kernels(self.desc["dtype"])
        serve = importlib.import_module("repro_torch.launch.stencil_serve")
        self.center, self.taps = inputs.program_default_coeffs(self.desc)
        self.program = port.StencilProgram(**self.desc)
        self.server = serve.StencilServer(max_batch=self.max_batch,
                                          device=ctx.device)
        self.start = [self._start_grid(c) for c in range(self.clients)]
        with ctx.span("bench.warmup"):
            for g in self.start:
                self.server.submit(self.program, g, self.steps)
            self.server.flush()
            ctx.sync()

    def _start_grid(self, client: int):
        return inputs.grid(self.shape, self.ctx.seed, client,
                           self.ctx.device, inputs.dtype_of(self.desc))

    def _judged(self, rng):
        """The clients whose requests of one flush are judged."""
        n = min(PER_FLUSH, self.clients)
        return set(rng.sample(range(self.clients), n))

    def window(self, seconds: float) -> Window:
        ctx, server = self.ctx, self.server
        rng = random.Random(inputs.derived_seed(ctx.seed, "sample"))
        judged_first, judged_last = self._judged(rng), self._judged(rng)
        current, self.start = self.start, None
        latencies = []
        attempted = failed = completed = flushes = 0
        t0 = time.perf_counter()
        while True:
            rids, sent, answered = [], [], {}
            # this flush's inputs, by reference: once it returns they are
            # held only until the next flush is sent
            given = list(current)
            with ctx.span("bench.submit"):
                for grid in current:
                    sent.append(time.perf_counter())
                    rids.append(server.submit(self.program, grid,
                                              self.steps))
            with ctx.span("bench.flush"):
                results = server.flush()
            back = time.perf_counter()
            attempted += len(rids)
            for c, rid in enumerate(rids):
                out = results.get(rid)
                if out is None:
                    failed += 1
                    continue
                completed += 1
                latencies.append(back - sent[c])
                if flushes == 0 and c in judged_first:
                    self.first[c] = out
                if c in judged_last:
                    answered[c] = (given[c], out)
                current[c] = out
            del results
            flushes += 1
            if back - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        if flushes > 1:
            self.last = (flushes - 1, answered)
        steps = work.cell_steps(self.shape, self.steps) * completed
        return Window(seconds=elapsed, cell_steps=steps,
                      flops=steps * work.flops_per_cell(self.desc),
                      bytes=completed * work.call_bytes(self.desc,
                                                        self.shape),
                      attempted=attempted, failed=failed,
                      latencies_s=latencies)

    def start_answers(self):
        """The answers whose inputs are the seed's own (every client's
        first request), with no output: what the control computes in the
        program's place.  Needs no set-up and no program."""
        center, taps = inputs.program_default_coeffs(self.desc)
        return [Answer(f"flush 0 client {c}",
                       lambda c=c: self._start_grid(c),
                       None, self.steps, center, taps)
                for c in range(self.clients)]

    def answers(self):
        start = self.start_answers()
        out = []
        for c in sorted(self.first):
            start[c].output = self.first[c]
            out.append(start[c])
        if self.last is not None:
            flush, answered = self.last
            for c in sorted(answered):
                src, got = answered[c]
                out.append(Answer(f"flush {flush} client {c}",
                                  lambda src=src: src, got, self.steps,
                                  self.center, self.taps))
        return out

    def close(self) -> None:
        self.server = None
        self.first, self.last = {}, None
