"""run_idle_ms: device-idle time inside each of the front door's runs.

For each of the program's ``run`` spans (``CompiledStencil.run``: the
front door's checks, the run driver's schedule, pad-in, launches and
slice-out, as the host enqueues them), clipped to the window: its wall
time minus the time in which any device operation ran inside it; the mean
over the runs, in milliseconds.  A trace without the spans has nothing to
read.
"""

from stencilbench import trace

SPAN = "run"


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    lo, hi = t.window
    runs = [(max(o.start, lo), min(o.end, hi)) for o in t.spans(SPAN)]
    runs = [(s, e) for s, e in runs if e > s]
    if not runs:
        return None
    busy = trace.union((o.start, o.end) for o in t.device)
    idle = [(e - s) - trace.covered(busy, s, e) for s, e in runs]
    return sum(idle) / len(idle) / 1e3
