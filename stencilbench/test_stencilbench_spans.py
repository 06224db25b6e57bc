"""The readers of the program's spans on synthetic traces: ``serve_idle_ms``,
``run_idle_ms`` and ``launch_host_us`` against hand-computed values,
nested spans, spans past the window, and nothing to read where the spans
or the trace are absent (an untraced run, a program without the spans)."""

import pytest

from stencilbench import trace
from stencilbench.harness import ROOT, Run, Window, load_module

NAMES = ("serve_idle_ms", "run_idle_ms", "launch_host_us")


def _read(name):
    return load_module(ROOT, "metrics", name).read


def _trace(spans, device=((20, 60), (50, 90), (130, 170))):
    """A 200 us window; ``spans`` as (name, start, end) annotations."""
    events = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
               "ts": 0.0, "dur": 200.0}]
    for name, s, e in spans:
        events.append({"ph": "X", "cat": "user_annotation", "name": name,
                       "ts": float(s), "dur": float(e - s)})
    for s, e in device:
        events.append({"ph": "X", "cat": "kernel", "name": "queue_kernel",
                       "ts": float(s), "dur": float(e - s)})
    events.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaEventSynchronize", "ts": 92.0, "dur": 6.0})
    return trace.from_events(events)


def _run(t):
    win = Window(seconds=2e-4, cell_steps=1, flops=0.0, bytes=0.0,
                 attempted=1, failed=0)
    return Run(cell={}, config={}, mix={}, device_name="x", setup_s=1.0,
               window=win, trace=t)


SERVED = [("serve.submit", 0, 10), ("serve.submit", 10, 20),
          ("bench.flush", 20, 100), ("serve.flush", 20, 100),
          ("serve.group", 20, 25), ("serve.stack", 25, 30),
          ("serve.wait", 90, 99), ("serve.submit", 100, 110),
          ("serve.flush", 110, 180), ("serve.route", 175, 178)]
SIM = [("run", 20, 40), ("run", 110, 140), ("run", 195, 260),
       ("run_call.supersteps", 21, 30),
       ("launch.padded_superstep", 22, 26), ("launch.wrap_halo", 27, 29),
       ("launch.padded_superstep", 112, 118),
       ("launch.padded_superstep", 250, 260)]


def test_serve_idle_sums_submit_and_flush_idle_per_flush():
    # device busy [20, 90] and [130, 170]; idle inside the held spans:
    # submits [0, 20] 20, flush [20, 100] 10, submit [100, 110] 10,
    # flush [110, 180] 30; the nested group/stack/wait/route add nothing
    got = _read("serve_idle_ms")(_run(_trace(SERVED)))
    assert got == pytest.approx((20 + 10 + 10 + 30) / 2 / 1e3)


def test_serve_idle_clips_to_the_window():
    spans = SERVED + [("serve.submit", 190, 230)]
    got = _read("serve_idle_ms")(_run(_trace(spans)))
    assert got == pytest.approx((20 + 10 + 10 + 30 + 10) / 2 / 1e3)


def test_run_idle_is_the_mean_idle_inside_each_run():
    # run [20, 40] busy throughout: 0; [110, 140]: busy from 130, 20;
    # [195, 260] clipped to [195, 200]: 5
    got = _read("run_idle_ms")(_run(_trace(SIM)))
    assert got == pytest.approx((0 + 20 + 5) / 3 / 1e3)


def test_launch_host_is_the_mean_launch_wall_in_the_window():
    # 4, 2 and 6 us; the launch past the window is left out
    got = _read("launch_host_us")(_run(_trace(SIM)))
    assert got == pytest.approx((4 + 2 + 6) / 3)


def test_idle_gaps_name_the_program_spans():
    idle = dict(trace.top_idle_gaps(_trace(SERVED)))
    # the gap [0, 20] in a submit; [90, 130] centred at 110, where the
    # second flush starts; [170, 200] at 185, under no span
    assert idle["serve.submit"] == pytest.approx(20e-6)
    assert idle["serve.flush"] == pytest.approx(40e-6)
    assert "bench.flush" not in idle


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read_without_the_spans_or_the_trace(name):
    read = _read(name)
    bare = _trace([("bench.flush", 20, 100), ("bench.run", 110, 140)])
    assert read(_run(bare)) is None
    assert read(_run(None)) is None


def test_serve_idle_needs_a_flush_and_the_device():
    read = _read("serve_idle_ms")
    assert read(_run(_trace([("serve.submit", 0, 10)]))) is None
    assert read(_run(_trace(SERVED, device=()))) is None
    assert _read("run_idle_ms")(_run(_trace(SIM, device=()))) is None
    assert _read("launch_host_us")(_run(_trace(SIM, device=()))) == \
        pytest.approx(4.0)
