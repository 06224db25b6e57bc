"""serve_idle_ms: device-idle time per flush inside the server's own spans.

The program's ``serve.submit`` and ``serve.flush`` spans (profiler ranges
of ``repro_torch.launch.stencil_serve``) are merged into the time the
server held the host, clipped to the window; the time in it in which no
device operation ran, summed over the window, is divided by the number of
``serve.flush`` spans, in milliseconds.  A trace without the spans (an
untraced run, a program that emits none) has nothing to read.
"""

from stencilbench import trace

SPANS = ("serve.submit", "serve.flush")
FLUSH = "serve.flush"


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    flushes = t.spans(FLUSH)
    if not flushes:
        return None
    lo, hi = t.window
    held = trace.union((max(o.start, lo), min(o.end, hi))
                       for name in SPANS for o in t.spans(name))
    busy = trace.union((o.start, o.end) for o in t.device)
    idle = sum((e - s) - trace.covered(busy, s, e) for s, e in held)
    return idle / len(flushes) / 1e3
