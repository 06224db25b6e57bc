"""stencilbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell of ``BENCHMARK.json`` once, from the root of a
checkout::

    python3 stencilbench/run.py --workload 2d_r4_paper.sim --seed 7 \\
        --seconds 10 --trace 0

Everything that belongs to one configuration, one traffic mix or one
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

    configs/<config>.json      the deployment: program, grid, reference, limit
    traffic/<traffic>.json     the mix: which loop drives it, and its numbers
    loops/<loop>.py            the general drivers a mix names
    metrics/<metric>.py        one reader per metric, ``read(run)``
    references/<name>.py       the plain reference a configuration names

The yardstick lives here too, out of the program's reach: the work count
(``work.py``), the input and coefficient draws (``inputs.py``), the
reduction of a profiler trace (``trace.py``) and the comparison that
decides ``correct`` (``check.py``).  Nothing here imports jax, the JAX
package or the old ``benchmarks`` folder.
"""
