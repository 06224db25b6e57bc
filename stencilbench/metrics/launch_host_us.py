"""launch_host_us: the host's time per kernel launch, in microseconds.

The mean wall time of the program's ``launch.<kernel>`` spans in the
traced window (``repro_torch.kernels.common``: one per superstep or ring
refresh, covering the coefficient bank, the geometry lookup and the
launcher's call).  A trace without the spans has nothing to read.
"""

PREFIX = "launch."


def read(run):
    t = run.trace
    if t is None:
        return None
    lo, hi = t.window
    walls = [o.end - o.start for o in t.host
             if o.cat == "user_annotation" and o.name.startswith(PREFIX)
             and lo <= o.start < hi]
    if not walls:
        return None
    return sum(walls) / len(walls)
