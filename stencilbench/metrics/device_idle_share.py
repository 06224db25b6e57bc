"""device_idle_share: the share of the traced window with no device work.

1 - (union of the device operations' intervals / the window), in
percent.  A trace with no device operation has nothing to read.
"""

from stencilbench import trace


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * trace.idle_share(run.trace)
