"""latency_p95_ms: the 95th percentile of request latency, nearest rank.

Over every request completed in the window, the time from just before its
``submit`` to the return of the ``flush()`` that resolved it (host clock):
what the client holds.  A run without requests has nothing to read.
"""

import math


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100)."""
    ranked = sorted(values)
    return ranked[max(0, math.ceil(q / 100.0 * len(ranked)) - 1)]


def read(run):
    if not run.window.latencies_s:
        return None
    return percentile(run.window.latencies_s, 95.0) * 1e3
