"""setup_s: process start to the first timed call, host clock.

Importing torch and the port, initialising CUDA, building the kernel
libraries where they are missing, planning, drawing the inputs and the
warm-up call or flush.
"""


def read(run):
    return run.setup_s
