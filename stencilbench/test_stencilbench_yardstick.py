"""The benchmark's yardstick on the CPU: the plain reference against a
float64 NumPy oracle of this file's own, the work count against hand
counts, the draws, the comparison and the trace arithmetic on synthetic
intervals."""

import math

import numpy as np
import pytest
import torch

from stencilbench import check, inputs, trace, work
from stencilbench.harness import ROOT, Run, Window, load_module


def _reference():
    return load_module(ROOT, "references", "tap_stencil")


def _oracle_step(desc, center, taps, g):
    """One step in float64 NumPy, each neighbour read by index
    arithmetic: clipped (clamp), wrapped (periodic) or masked (constant)."""
    out = center * g
    for c, off in zip(taps, work.neighbor_taps(desc)):
        idx = np.indices(g.shape)
        valid = np.ones(g.shape, dtype=bool)
        for ax, o in enumerate(off):
            i = idx[ax] + o
            n = g.shape[ax]
            if desc["boundary"] == "periodic":
                i = i % n
            else:
                valid &= (i >= 0) & (i < n)
                i = np.clip(i, 0, n - 1)
            idx[ax] = i
        v = g[tuple(idx)]
        if desc["boundary"] == "constant":
            v = np.where(valid, v, desc["boundary_value"])
        out = out + c * v
    return out


def _desc(ndim, radius, shape="star", boundary="clamp"):
    return {"ndim": ndim, "radius": radius, "shape": shape,
            "boundary": boundary, "boundary_value": 0.25,
            "dtype": "float32"}


@pytest.mark.parametrize("ndim,grid", [(2, (13, 21)), (3, (9, 11, 14))])
@pytest.mark.parametrize("shape", ["star", "box", "diamond"])
@pytest.mark.parametrize("boundary", ["clamp", "periodic", "constant"])
def test_reference_matches_float64_oracle(ndim, grid, shape, boundary):
    desc = _desc(ndim, 2 if shape != "star" else 4, shape, boundary)
    if shape != "star" and ndim == 3:
        desc["radius"] = 1
    center, taps = inputs.seeded_coeffs(desc, 5, "cpu")
    center, taps = float(center), taps.tolist()
    g = inputs.grid(grid, 5, 0, "cpu")
    got = _reference().advance(desc, center, taps, g, 3)
    want = g.double().numpy()
    for _ in range(3):
        want = _oracle_step(desc, center, taps, want)
    assert got.dtype == torch.float32
    assert np.abs(got.double().numpy() - want).max() <= 1e-6


def test_reference_in_bfloat16_departs_from_float32():
    desc = _desc(2, 4)
    center, taps = inputs.program_default_coeffs(desc)
    g = inputs.grid((32, 48), 9, 0, "cpu")
    ref = _reference()
    f32 = ref.advance(desc, center, taps, g, 8)
    bf16 = ref.advance(desc, center, taps, g, 8, torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    assert check.rel_err(bf16, f32) > 1e-3


def test_work_counts_match_hand_counts():
    star2, star3 = _desc(2, 4), _desc(3, 4)
    assert work.flops_per_cell(star2) == 17 + 16 == 33
    assert work.flops_per_cell(star3) == 25 + 24 == 49
    assert work.flops_per_cell(_desc(2, 1, "box")) == 9 + 8
    assert len(work.neighbor_taps(_desc(3, 2, "diamond"))) == 24
    # one read and one write of each grid of a call, 4 bytes a cell
    assert work.call_bytes(star2, (15680, 15680)) == 2 * 15680 ** 2 * 4
    assert work.call_bytes(star3, (2, 3, 5), batch=4) == 2 * 4 * 30 * 4
    assert work.cell_steps((696, 728, 696), 128) == 696 * 728 * 696 * 128
    assert work.cell_steps((8, 8), 8, batch=4) == 4 * 64 * 8
    peak = work.peaks("NVIDIA H100 80GB HBM3")
    # 2d_r4_paper, 256 steps: bound by operations, 31.0 ms
    flops = work.cell_steps((15680, 15680), 256) * 33
    t = work.bound_seconds(flops, work.call_bytes(star2, (15680, 15680)),
                           peak)
    assert t == pytest.approx(flops / 67e12)
    assert t == pytest.approx(0.0310, rel=1e-2)
    assert work.peaks("cpu") is None


def test_star_taps_are_direction_major():
    taps = work.star_taps(2, 2)
    assert taps == ((0, -1), (0, -2), (0, 1), (0, 2),
                    (-1, 0), (-2, 0), (1, 0), (2, 0))
    assert work.star_taps(3, 1)[-2:] == ((-1, 0, 0), (1, 0, 0))


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("ndim,shape", [(2, "star"), (3, "star"),
                                        (2, "box"), (3, "diamond")])
def test_default_draw_copy_equals_the_ports(dtype, ndim, shape):
    from stencilbench.harness import import_port
    port = import_port(ROOT)
    desc = {**_desc(ndim, 4 if shape == "star" else 1, shape),
            "dtype": dtype}
    center, taps = inputs.program_default_coeffs(desc)
    theirs = port.StencilProgram(ndim=ndim, radius=desc["radius"],
                                 shape=shape, dtype=dtype).default_coeffs()
    assert center == float(theirs.center)
    assert taps == theirs.taps.tolist()
    with pytest.raises(ValueError):
        inputs.program_default_coeffs({**desc, "coeff_sharing": "distance"})


def test_grids_of_every_dtype_are_the_same_field():
    g = inputs.grid((6, 7), 11, 0, "cpu")
    for dtype in (torch.bfloat16, torch.float16, torch.float64):
        other = inputs.grid((6, 7), 11, 0, "cpu", dtype)
        assert other.dtype == dtype
        assert torch.equal(other, g.to(dtype))
    assert inputs.dtype_of(_desc(2, 4)) == torch.float32


@pytest.mark.parametrize("seed", [0, 7, -3, 2**31 + 5, 2**70 + 1])
def test_draws_repeat_from_the_seed(seed):
    desc = _desc(3, 4)
    a = inputs.grid((4, 5, 6), seed, 2, "cpu")
    assert torch.equal(a, inputs.grid((4, 5, 6), seed, 2, "cpu"))
    assert not torch.equal(a, inputs.grid((4, 5, 6), seed, 3, "cpu"))
    assert -1.0 <= float(a.min()) and float(a.max()) < 1.0
    center, taps = inputs.seeded_coeffs(desc, seed, "cpu")
    assert float(center) == 0.5
    assert float(taps.sum()) == pytest.approx(0.5, abs=1e-6)
    assert float(taps.min()) > 0.0
    assert 0 <= inputs.derived_seed(seed, "grid", 1) < 2**63


def test_rel_err_reads_nan_and_shape_as_infinite():
    a = torch.ones(6, 5)
    assert check.rel_err(a, a.clone()) == 0.0
    b = a.clone()
    b[2, 3] = 3.0
    assert check.rel_err(b, a) == 2.0
    b[0, 0] = float("nan")
    assert math.isinf(check.rel_err(b, a))
    assert math.isinf(check.rel_err(a[:3], a))
    assert not check.verdict({"x": float("nan")}, {"x": 1.0})
    assert check.verdict({"x": 1.0, "y": 0}, {"x": 1.0, "y": 0})


def _op(name, cat, s, e):
    return trace.Op(name, cat, float(s), float(e))


def _synthetic():
    """A 100 us window: two stencil kernels, a PyTorch copy and a memset,
    overlapping in one place; two flush spans; host events."""
    events = []
    for o in [_op("bench.window", "user_annotation", 0, 100),
              _op("bench.flush", "user_annotation", 0, 50),
              _op("bench.flush", "user_annotation", 50, 100),
              _op("aten::stack", "cpu_op", 40, 55),
              _op("void (anonymous namespace)::queue_kernel<2, 4, 2, 0>"
                  "(float const*, float*)", "kernel", 10, 30),
              _op("void at::native::vectorized_elementwise_kernel<4, "
                  "at::native::FillFunctor<float> >(int)", "kernel", 25, 35),
              _op("Memset (Device)", "gpu_memset", 60, 70),
              _op("void (anonymous namespace)::queue_kernel<2, 4, 2, 0>"
                  "(float const*, float*)", "kernel", 70, 90),
              _op("outside", "kernel", 120, 130)]:
        events.append({"ph": "X", "cat": o.cat, "name": o.name,
                       "ts": o.start, "dur": o.end - o.start})
    return trace.from_events(events)


def test_trace_arithmetic_on_synthetic_intervals():
    t = _synthetic()
    assert t.window == (0.0, 100.0)
    assert len(t.device) == 4            # the op past the window is out
    assert trace.union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    assert trace.busy_us(t) == 25 + 10 + 20
    assert trace.idle_share(t) == pytest.approx(0.45)
    assert trace.gaps(t) == [(0.0, 10.0), (35.0, 60.0), (90.0, 100.0)]
    ops = trace.top_device_ops(t)
    assert ops[0] == ["queue_kernel<2, 4, 2, 0>", 40e-6]
    idle = dict(trace.top_idle_gaps(t))
    # labelled by the host at each gap's middle: 5, 47.5 and 95 us
    assert idle["bench.flush > aten::stack"] == pytest.approx(25e-6)
    assert idle["bench.flush"] == pytest.approx(20e-6)


def _run(t, flops=0.0, nbytes=0.0, name="NVIDIA H100 80GB HBM3"):
    win = Window(seconds=t.window_s, cell_steps=1, flops=flops,
                 bytes=nbytes, attempted=1, failed=0)
    return Run(cell={}, config={}, mix={}, device_name=name, setup_s=1.0,
               window=win, trace=t)


def test_layer_metrics_on_synthetic_intervals():
    read = {n: load_module(ROOT, "metrics", n).read
            for n in ("aux_device_share", "device_idle_share",
                      "flush_overhead_ms", "stencil_kernels_roofline")}
    t = _synthetic()
    # summed durations: 40 us of stencil kernels, 10 of fill, 10 of memset
    assert read["aux_device_share"](_run(t)) == pytest.approx(100 * 20 / 60)
    assert read["device_idle_share"](_run(t)) == pytest.approx(45.0)
    # flush 1: 50 us wall, 25 busy; flush 2: 50 wall, 30 busy
    assert read["flush_overhead_ms"](_run(t)) == pytest.approx(
        (25 + 20) / 2 / 1e3)
    # the stencil kernels ran 40 us of the 55 us busy; the fill and the
    # memset are left out: 67e12 * 11e-6 operations take 11 us of 40
    assert trace.kernel_us(t) == 40.0
    share = read["stencil_kernels_roofline"](_run(t, flops=67e12 * 11e-6))
    assert share == pytest.approx(27.5)
    bytes_bound = read["stencil_kernels_roofline"](
        _run(t, nbytes=3.35e12 * 40e-6))
    assert bytes_bound == pytest.approx(100.0)
    assert read["stencil_kernels_roofline"](_run(t, 1.0, 1.0, "cpu")) is None
    aux_only = trace.Trace(device=[o for o in t.device if trace.is_aux(o)],
                           host=t.host, window=t.window)
    assert read["stencil_kernels_roofline"](_run(aux_only, 1.0)) is None
    assert read["aux_device_share"](_run(aux_only)) == pytest.approx(100.0)
    empty = trace.Trace(device=[], host=t.host, window=t.window)
    for name in ("aux_device_share", "device_idle_share",
                 "flush_overhead_ms", "stencil_kernels_roofline"):
        assert read[name](_run(empty, 1.0, 1.0)) is None
        assert read[name](Run({}, {}, {}, "x", 1.0, _run(t).window)) is None


def test_end_to_end_metrics_read_the_window():
    gcell = load_module(ROOT, "metrics", "gcell_steps_per_s").read
    p95 = load_module(ROOT, "metrics", "latency_p95_ms")
    win = Window(seconds=2.0, cell_steps=6 * 10**9, flops=0, bytes=0,
                 attempted=20, failed=0,
                 latencies_s=[i / 1000 for i in range(1, 21)])
    run = Run({}, {}, {}, "x", 3.5, win)
    assert gcell(run) == 3.0
    # nearest rank: the 19th of 20
    assert p95.read(run) == pytest.approx(19.0)
    assert p95.percentile([5.0], 95) == 5.0
    assert load_module(ROOT, "metrics", "setup_s").read(run) == 3.5
    win.latencies_s = []
    assert p95.read(run) is None
