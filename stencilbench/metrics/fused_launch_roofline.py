"""fused_launch_roofline: each fused launch's floor over the kernels' time.

Every superstep launch of the program opens one ``superstep.steps.<T>``
range inside its ``launch.<key>`` span (``repro_torch.kernels.common``),
T the steps it fuses.  A launch's floor is the least time the card could
take for it: the larger of its operations (T updates of the
configuration's N grid cells at ``flops_per_cell`` each) at the FP32
peak and its bytes (one read and one write of the grid, ``call_bytes``)
at the HBM peak.  The floors of the launches in the traced window are
summed and divided by the time in which any of the program's own kernels
ran (``trace.kernel_us``).

So where ``stencil_kernels_roofline`` counts a whole call's bytes once,
this counts them once a launch: it is how far each launch is from the
floor that fusing more steps into it lowers, and cannot pass 100% while
every launch reads and writes the whole grid at least once.  N comes from
the configuration, not from the program.  A card the peak table lacks, a
trace without the ranges (a program that opens none), or ranges whose
cell updates (T x N summed) differ from the window's has nothing to read.
"""

import math

from stencilbench import trace, work

PREFIX = "superstep.steps."


def fused_steps(t):
    """The fused steps of each ``superstep.steps.<T>`` range that starts
    in the traced window."""
    lo, hi = t.window
    return [int(o.name[len(PREFIX):]) for o in t.host
            if o.cat == "user_annotation" and o.name.startswith(PREFIX)
            and lo <= o.start < hi]


def read(run):
    if run.trace is None:
        return None
    peak = work.peaks(run.device_name)
    busy = trace.kernel_us(run.trace) / 1e6
    steps = fused_steps(run.trace)
    if peak is None or busy <= 0 or not steps:
        return None
    desc, grid = run.config["program"], run.config["grid"]
    cells = math.prod(grid)
    if sum(steps) * cells != run.window.cell_steps:
        return None
    nbytes = work.call_bytes(desc, grid)
    floor = sum(work.bound_seconds(t * cells * work.flops_per_cell(desc),
                                   nbytes, peak) for t in steps)
    return 100.0 * floor / busy
