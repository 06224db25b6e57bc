"""stencil_kernels_roofline: the work's bound over the stencil kernels' time.

The bound is the least time the card could take for the work the window
completed: the larger of its operations (cell updates times
``flops_per_cell``) at the FP32 peak and its bytes (one read of each
input grid and one write of each output grid per call or request) at the
HBM peak (``work.PEAKS``).  It is divided by the time in which any of the
program's own kernels ran in the traced window (``trace.kernel_us``:
every device operation but PyTorch's fills, copies and stacks, memcpy
and memset, which ``aux_device_share`` counts).  So the run driver's
work moves ``aux_device_share`` and not this share; and since the bound
counts the work and not the launches, it reads the same however the
kernels split or fuse it, and cannot pass 100% while they do all of it.
A card the peak table lacks, or a trace with no kernel time, has
nothing to read.
"""

from stencilbench import trace, work


def read(run):
    if run.trace is None:
        return None
    peak = work.peaks(run.device_name)
    busy = trace.kernel_us(run.trace) / 1e6
    if peak is None or busy <= 0:
        return None
    bound = work.bound_seconds(run.window.flops, run.window.bytes, peak)
    return 100.0 * bound / busy
