"""gcell_steps_per_s: cell updates completed in the window, per second.

Every cell of every grid, every step, of every call or request that
finished in the window, over the window's seconds (host clock, from the
first call's start to the last one's end).  Times ``flops_per_cell`` it
is the run's GFLOP/s.
"""


def read(run):
    if run.window.seconds <= 0 or run.window.cell_steps == 0:
        return None
    return run.window.cell_steps / run.window.seconds / 1e9
