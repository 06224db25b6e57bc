"""aux_device_share: device time outside the stencil kernels, in percent.

A device operation is auxiliary when ``trace.is_aux`` says so: one of
PyTorch's own kernels (its name holds ``at::``: fills, copies,
``cat``/``stack``, the coefficient bank), a memcpy or a memset.  Every
other kernel is one the port launches from its own sources.  The share
is the auxiliary operations' summed time over all device operations'
summed time in the traced window.
"""

from stencilbench import trace


def read(run):
    if run.trace is None:
        return None
    total = sum(o.end - o.start for o in run.trace.device)
    if total <= 0:
        return None
    aux = sum(o.end - o.start for o in run.trace.device if trace.is_aux(o))
    return 100.0 * aux / total
