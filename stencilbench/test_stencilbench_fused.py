"""The 3D radius-2 star on the CPU, and ``fused_launch_roofline``.

* the port (its kernels' plain versions) against the plain reference
  ``tap_stencil`` at a small 3D radius-2 clamp grid, with par_time 1, 2
  and 3 pinned and with ``plan="auto"``, each at a step count that leaves
  a tail launch: within 1e-5 of max|reference|, where float32 sums taken
  in another order stay, and which the reference in bfloat16 misses by
  far;
* ``fused_launch_roofline`` on synthetic traces: the sum of each
  ``superstep.steps.<T>`` range's floor over the kernels' time, by hand;
  nothing to read without the ranges, without the card's peaks, or where
  the ranges' cell updates differ from the window's.
"""

import math

import pytest
import torch

import repro_torch
from stencilbench import check, inputs, trace, work
from stencilbench.harness import ROOT, Run, Window, load_module

DESC = {"ndim": 3, "radius": 2, "shape": "star", "boundary": "clamp",
        "boundary_value": 0.0, "dtype": "float32"}
GRID = (12, 14, 19)
#: 7 steps: a tail launch at par_time 2 (3 x 2 + 1) and 3 (2 x 3 + 1)
STEPS = 7
#: float32 sums of 13 taps in another order, over 7 convex steps, stay
#: within a few ULP of max|reference|; bfloat16 keeps 8 bits
TOL = 1e-5


@pytest.fixture(autouse=True)
def plan_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE",
                       str(tmp_path / "plans.json"))


def _reference():
    return load_module(ROOT, "references", "tap_stencil")


def _inputs(seed=2**33 + 17):
    """The coefficients (tensors, as the port takes them) and the grid,
    drawn from the seed."""
    center, taps = inputs.seeded_coeffs(DESC, seed, "cpu")
    grid = inputs.grid(GRID, seed, 0, "cpu")
    return center, taps, grid


@pytest.mark.parametrize("plan", [1, 2, 3, "auto"])
def test_port_matches_tap_stencil_at_3d_r2(plan):
    center, taps, grid = _inputs()
    program = repro_torch.StencilProgram(**DESC)
    if plan != "auto":
        plan = repro_torch.BlockPlan(spec=program, block_shape=(4, 8, 16),
                                     par_time=plan)
    cs = repro_torch.stencil(
        program, repro_torch.ProgramCoeffs(center, taps)).compile(
        GRID, steps=STEPS, plan=plan, device="cpu")
    if not isinstance(plan, str):
        assert cs.plan.par_time == plan.par_time
    got = cs.run(grid)
    ref = _reference()
    want = ref.advance(DESC, float(center), taps.tolist(), grid, STEPS)
    assert got.dtype == torch.float32
    assert check.rel_err(got, want) <= TOL
    low = ref.advance(DESC, float(center), taps.tolist(), grid, STEPS,
                      torch.bfloat16)
    assert check.rel_err(low, want) > 100 * TOL


CELLS = math.prod(GRID)


def _trace(ranges, kernels=((10, 60), (70, 150), (150, 170)),
           aux=((60, 70),)):
    """A 200 us window; ``ranges`` as (fused steps, start, end)."""
    events = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
               "ts": 0.0, "dur": 200.0}]
    for t, s, e in ranges:
        events.append({"ph": "X", "cat": "user_annotation",
                       "name": f"superstep.steps.{t}", "ts": float(s),
                       "dur": float(e - s)})
        events.append({"ph": "X", "cat": "user_annotation",
                       "name": "launch.padded_superstep", "ts": float(s),
                       "dur": float(e - s)})
    for s, e in kernels:
        events.append({"ph": "X", "cat": "kernel",
                       "name": "queue_kernel<3, 2, 2, 0>", "ts": float(s),
                       "dur": float(e - s)})
    for s, e in aux:
        events.append({"ph": "X", "cat": "kernel",
                       "name": "void at::native::elementwise_kernel",
                       "ts": float(s), "dur": float(e - s)})
    return trace.from_events(events)


def _run(t, cell_steps, device="NVIDIA H100 80GB HBM3"):
    win = Window(seconds=2e-4, cell_steps=cell_steps, flops=0.0, bytes=0.0,
                 attempted=1, failed=0)
    return Run(cell={}, config={"program": DESC, "grid": list(GRID)},
               mix={}, device_name=device, setup_s=1.0, window=win, trace=t)


def _read(run):
    return load_module(ROOT, "metrics", "fused_launch_roofline").read(run)


#: two 2-step launches and a 1-step tail; one launch starts past the
#: window and is left out
RANGES = [(2, 5, 9), (2, 65, 69), (1, 140, 144), (3, 205, 210)]


def test_fused_launch_roofline_by_hand():
    got = _read(_run(_trace(RANGES), 5 * CELLS))
    # per launch: max(T x N x 25 flops at 67 TFLOP/s, 2 x N x 4 bytes at
    # 3.35 TB/s); kernels ran 50 + 100 us (the at:: copy left out)
    nbytes = 2 * CELLS * 4
    floors = [max(t * CELLS * 25 / 67e12, nbytes / 3.35e12)
              for t in (2, 2, 1)]
    assert got == pytest.approx(100 * sum(floors) / 150e-6)
    assert work.flops_per_cell(DESC) == 25
    assert 0 < got <= 100


def test_fused_launch_roofline_has_nothing_to_read():
    # a program without the ranges (the parent's)
    assert _read(_run(_trace([]), 5 * CELLS)) is None
    # the ranges' updates (T x N) are not the window's
    assert _read(_run(_trace(RANGES), 6 * CELLS)) is None
    # a card the peak table lacks, and an untraced run
    assert _read(_run(_trace(RANGES), 5 * CELLS, device="cpu")) is None
    assert _read(_run(None, 5 * CELLS)) is None
