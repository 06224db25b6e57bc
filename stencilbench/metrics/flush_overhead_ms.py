"""flush_overhead_ms: host time per flush that the device does not cover.

For each ``bench.flush`` span of the traced window (the benchmark's own
span around ``StencilServer.flush()``): its wall time minus the time in
which any device operation ran inside it; the mean over the flushes, in
milliseconds.  A run without flushes has nothing to read.
"""

from stencilbench import trace

SPAN = "bench.flush"


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    flushes = run.trace.spans(SPAN)
    if not flushes:
        return None
    busy = trace.union((o.start, o.end) for o in run.trace.device)
    idle = [(f.end - f.start) - trace.covered(busy, f.start, f.end)
            for f in flushes]
    return sum(idle) / len(idle) / 1e3
