"""The port's spans on the profiler's clock (``repro_torch.obs``).

* under ``torch.profiler`` a front-door ``run`` and a two-chunk
  ``StencilServer`` flush on the CPU export a Chrome trace whose
  ``user_annotation`` events hold every span, nested as the layers nest:
  ``serve.flush`` > ``serve.group``/``serve.dispatch``/``serve.wait``/
  ``serve.route``, ``serve.dispatch`` > ``run`` > ``run_call.*``,
  ``run_call.supersteps`` > ``launch.<kernel>``;
* a batched chunk stacks nothing: its row copies and the ring fills lie in
  ``run_call.pad_in``; only an identity chunk stacks, in ``serve.stack``;
* the off path, structurally: with ``record_function`` made to raise and
  neither the recorder nor a profiler on, the helpers return the shared
  no-op and a run and a flush succeed; with only the profiler on, the
  front door never takes its synchronising recorded path;
* with the recorder on, the launch spans carry their attributes and the
  server's own recorder keeps only its ``serve.flush``;
* every latency sample of a flush is stamped after its last chunk's wait;
* each superstep launch opens one ``superstep.steps.<T>`` range inside
  its launch span, T its own fused steps (a call's tail and a temporal
  chunk included), a ring refresh none; with the recorder on, the
  launches' cell updates count as ``superstep.cell_steps``;
* on the card (``gpu`` marker), every ``launch.*`` range holds the
  launcher's runtime call.
"""

import json
import math

import pytest
import torch

import repro_torch
from repro_torch import executor, obs
from repro_torch.kernels import common, cuda
from repro_torch.launch import stencil_serve
from repro_torch.launch.stencil_serve import StencilServer

SHAPE = (20, 140)
#: the program's spans, and the span each lies inside
PARENT = {
    "serve.group": "serve.flush",
    "serve.dispatch": "serve.flush",
    "serve.wait": "serve.flush",
    "serve.route": "serve.flush",
    "run_call.pad_in": "run",
    "run_call.supersteps": "run",
    "run_call.slice_out": "run",
    "launch.padded_superstep": "run_call.supersteps",
}


@pytest.fixture(autouse=True)
def _obs_isolation(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_OBS", raising=False)
    obs.reset()
    yield
    obs.reset()


def _program(**fields):
    return repro_torch.StencilProgram(**{"ndim": 2, "radius": 1, **fields})


def _compiled(variant="plain", steps=5, **fields):
    """A CPU executable; a periodic program gets a block of the grid's own
    extent, so that its ring refreshes in place (no re-pad fallback)."""
    prog = _program(**fields)
    plan = "model"
    if prog.boundary == "periodic":
        plan = repro_torch.BlockPlan(spec=prog, block_shape=SHAPE,
                                     par_time=2)
    return repro_torch.stencil(prog).compile(
        SHAPE, steps=steps, plan=plan, max_par_time=2, variant=variant,
        device="cpu")


def _grid(seed=0, shape=SHAPE):
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed))


def _profiled(fn, tmp_path):
    """``fn()`` under a CPU ``torch.profiler``; the exported trace's
    ``user_annotation`` and ``cpu_op`` events, as (name, start, end)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    out = {"user_annotation": [], "cpu_op": []}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in out:
            t0 = float(e["ts"])
            out[e["cat"]].append((e["name"], t0, t0 + float(e["dur"])))
    return out


def _named(events, name):
    return [e for e in events if e[0] == name]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _serve_two_chunks():
    """Three requests at ``max_batch`` 2: a stacked chunk and a lone one."""
    server = StencilServer(max_batch=2, max_par_time=2, device="cpu")
    prog = _program()
    rids = [server.submit(prog, _grid(i), 3) for i in range(3)]
    results = server.flush()
    assert set(results) == set(rids) and not server.failed
    return server


def test_run_and_flush_spans_nest_in_the_profiler_trace(tmp_path):
    cs = _compiled()
    grid = _grid()
    cs.run(grid)                    # plans and geometries cached before

    def work():
        cs.run(grid)
        _serve_two_chunks()

    ua = _profiled(work, tmp_path)["user_annotation"]
    names = {e[0] for e in ua}
    assert set(PARENT) | {"serve.submit", "serve.flush", "run"} <= names
    for child, parent in PARENT.items():
        for e in _named(ua, child):
            assert any(_inside(e, p) for p in _named(ua, parent)), child
    (flush,) = _named(ua, "serve.flush")
    assert len(_named(ua, "serve.submit")) == 3
    assert all(s[2] <= flush[1] for s in _named(ua, "serve.submit"))
    # one front-door run, then one per chunk, each under its dispatch
    runs = _named(ua, "run")
    assert len(runs) == 3 and not _inside(runs[0], flush)
    for r in runs[1:]:
        assert any(_inside(r, d) for d in _named(ua, "serve.dispatch"))
    assert len(_named(ua, "serve.dispatch")) == 2
    assert len(_named(ua, "serve.wait")) == 2
    assert not _named(ua, "serve.stack")    # the batched one goes as rows
    # the route follows every wait
    (route,) = _named(ua, "serve.route")
    assert all(w[2] <= route[1] for w in _named(ua, "serve.wait"))


def _serve_identity():
    """Two requests of 0 steps: one identity chunk, stacked, no run."""
    server = StencilServer(max_batch=2, max_par_time=2, device="cpu")
    rids = [server.submit(_program(), _grid(i), 0) for i in range(2)]
    assert set(server.flush()) == set(rids) and not server.failed


def test_stack_and_launches_lie_in_their_spans(tmp_path):
    events = _profiled(_serve_two_chunks, tmp_path)
    ua, ops = events["user_annotation"], events["cpu_op"]
    # no stack: the batched chunk's two rows and the lone grid are copied
    # into their padded carries, and only the ring and slack are zeroed
    # (two buffers, a lo and a hi slab per axis), all inside the pad-in
    assert not _named(ua, "serve.stack") and not _named(ops, "aten::stack")
    pads = _named(ua, "run_call.pad_in")
    assert len(pads) == 2
    for pad, rows in zip(sorted(pads, key=lambda e: e[1]), (2, 1)):
        inside = [o[0] for o in ops if _inside(o, pad)]
        assert inside.count("aten::copy_") == rows
        assert inside.count("aten::zero_") == 2 * 2 * len(SHAPE)
        assert not {"aten::zeros", "aten::zeros_like",
                    "aten::new_zeros"} & set(inside)
    launches = _named(ua, "launch.padded_superstep")
    # 3 steps at par_time 2: a full superstep and a remainder, per chunk
    assert len(launches) == 4
    loops = _named(ua, "run_call.supersteps")
    assert all(any(_inside(x, lp) for lp in loops) for x in launches)
    # an identity chunk still stacks its grids, inside serve.stack
    events = _profiled(_serve_identity, tmp_path)
    ua, ops = events["user_annotation"], events["cpu_op"]
    (stack,) = _named(ua, "serve.stack")
    stacks = _named(ops, "aten::stack")
    assert stacks and all(_inside(s, stack) for s in stacks)
    assert not _named(ua, "run")


@pytest.mark.parametrize("variant,fields,key", [
    ("plain", {}, "padded_superstep"),
    ("pipelined", {}, "padded_pipelined"),
    ("temporal", {}, "temporal_superstep"),
    ("plain", {"shape": "box", "boundary": "periodic"}, "wrap_halo"),
])
def test_each_kernel_launch_has_its_span(tmp_path, variant, fields, key):
    # 40 steps: the temporal variant's chunks and a remainder
    cs = _compiled(variant, steps=40, **fields)
    grid = _grid()
    ua = _profiled(lambda: cs.run(grid), tmp_path)["user_annotation"]
    spans = _named(ua, common.LAUNCH_SPANS[key])
    assert spans and key in cuda.KERNELS
    (loop,) = _named(ua, "run_call.supersteps")
    assert all(_inside(s, loop) for s in spans)
    assert {e[0] for e in ua if e[0].startswith("launch.")} <= \
        set(common.LAUNCH_SPANS.values())


@pytest.mark.parametrize("variant,key", [("plain", "superstep"),
                                         ("pipelined", "pipelined_superstep")])
def test_prepadded_superstep_has_its_span(tmp_path, variant, key):
    cs = _compiled(variant)
    coeffs = cs.coeffs
    grid = _grid()

    def one():
        common.pad_superstep(grid, coeffs.center, coeffs.taps,
                             program=cs.program, plan=cs.plan,
                             variant=variant)

    ua = _profiled(one, tmp_path)["user_annotation"]
    assert len(_named(ua, common.LAUNCH_SPANS[key])) == 1


def test_off_path_returns_the_shared_no_op(monkeypatch):
    def refuse(name, *args, **kwargs):
        raise AssertionError(f"record_function({name!r}) on the off path")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert obs.active() is None and not obs.profiling()
    for name in ("serve.submit", "run_call.pad_in", "launch.wrap_halo",
                 common.STEPS_SPAN + "2"):
        assert obs.span(name) is obs.NULL_SPAN
        assert obs.profiler_range(name) is obs.NULL_SPAN
    assert obs.NULL_SPAN.recording is False
    cs = _compiled()
    want = cs.run(_grid())
    server = _serve_two_chunks()
    assert server.recorder.spans("serve.flush")
    assert torch.equal(_compiled().run(_grid()), want)


def test_profiler_alone_never_takes_the_recorded_run(monkeypatch, tmp_path):
    def refuse(self, rec, grid, steps):
        raise AssertionError("_run_recorded with the recorder off")

    monkeypatch.setattr(executor.CompiledStencil, "_run_recorded", refuse)
    cs = _compiled()
    grid = _grid()
    want = cs.run(grid)
    got = []
    ua = _profiled(lambda: got.append(cs.run(grid)),
                   tmp_path)["user_annotation"]
    assert torch.equal(got[0], want)
    assert len(_named(ua, "run")) == 1
    assert obs.active() is None


def test_profiler_alone_gives_ranges_that_record_nothing(tmp_path):
    seen = []

    def work():
        assert obs.profiling()
        sp = obs.span("run_call.pad_in", ignored=1)
        seen.append(sp)
        with sp as inner:
            assert inner.set(k=1) is inner

    ua = _profiled(work, tmp_path)["user_annotation"]
    assert isinstance(seen[0], obs.ProfilerRange)
    assert not seen[0].recording
    assert len(_named(ua, "run_call.pad_in")) == 1
    assert not obs.profiling()


def test_recorder_and_profiler_record_both(tmp_path):
    cs = _compiled(boundary="periodic", shape="box")
    grid = _grid()
    cs.run(grid)
    recs = []

    def work():
        with obs.profile() as rec:
            recs.append(rec)
            cs.run(grid)

    ua = _profiled(work, tmp_path)["user_annotation"]
    rec = recs[0]
    for name in ("run", "run_call.pad_in", "run_call.supersteps",
                 "run_call.slice_out", "launch.padded_superstep",
                 "launch.wrap_halo"):
        assert rec.spans(name), name
        assert len(_named(ua, name)) == len(rec.spans(name)), name
    pad = cs.plan.halo
    for sp in rec.spans("launch.padded_superstep"):
        assert sp["dtype"] == "float32" and sp["batch"] == 1
        assert sp["cells"] == math.prod(SHAPE)
        assert sp["steps"] in (cs.plan.par_time, 5 % cs.plan.par_time)
    for sp in rec.spans("launch.wrap_halo"):
        assert sp["steps"] == 0 and sp["batch"] == 1
        # both axes wrap: a lo and a hi strip of the ring's depth each,
        # across the other axis's padded extent
        assert sp["cells"] == 2 * pad * sum(s + 2 * pad for s in SHAPE)


def test_batched_launch_counts_every_grid():
    cs = repro_torch.stencil(_program()).compile(
        SHAPE, steps=2, batch=3, plan="model", max_par_time=2, device="cpu")
    with obs.profile() as rec:
        cs.run(torch.zeros((3,) + SHAPE))
    (sp,) = rec.spans("launch.padded_superstep")
    assert (sp["batch"], sp["cells"], sp["steps"]) == \
        (3, 3 * math.prod(SHAPE), 2)


def test_server_recorder_keeps_only_its_flush():
    with obs.profile() as rec:
        server = _serve_two_chunks()
    assert {e["name"] for e in server.recorder.spans()} == {"serve.flush"}
    got = {e["name"] for e in rec.spans()}
    assert {"serve.submit", "serve.group", "serve.dispatch",
            "serve.wait", "serve.route", "run"} <= got
    assert "serve.flush" not in got and "serve.stack" not in got
    # the run driver's bytes go to the global recorder too
    assert rec.counter("run_call.copy_bytes") > 0
    assert server.recorder.counter("run_call.copy_bytes") == 0


def test_compiling_records_no_span(monkeypatch):
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with obs.profile() as rec:
        assert obs.span("launch.padded_superstep") is obs.NULL_SPAN
        _compiled().run(_grid())
    assert rec.events == []


def _pinned(variant, steps, par_time=2, **fields):
    """A CPU executable of a pinned plan, one block the grid's extent."""
    prog = _program(**fields)
    plan = repro_torch.BlockPlan(spec=prog, block_shape=SHAPE,
                                 par_time=par_time)
    return repro_torch.stencil(prog).compile(
        SHAPE, steps=steps, plan=plan, variant=variant, device="cpu")


def _steps_ranges(ua):
    return [e for e in ua if e[0].startswith(common.STEPS_SPAN)]


CHUNK = common.TEMPORAL_CHUNK


@pytest.mark.parametrize("variant,steps,fields,key,depths", [
    # two full supersteps and a one-step tail
    ("plain", 5, {}, "padded_superstep", [2, 2, 1]),
    ("pipelined", 5, {}, "padded_pipelined", [2, 2, 1]),
    # two chunks of CHUNK supersteps, then a plain tail of 3 steps
    ("temporal", 4 * CHUNK + 3, {}, "temporal_superstep",
     [2 * CHUNK, 2 * CHUNK, 3]),
    ("plain", 3, {"shape": "box", "boundary": "periodic"},
     "padded_superstep", [2, 1]),
])
def test_each_superstep_launch_opens_one_steps_range(tmp_path, variant,
                                                     steps, fields, key,
                                                     depths):
    cs = _pinned(variant, steps, **fields)
    grid = _grid()
    cs.run(grid)
    ua = _profiled(lambda: cs.run(grid), tmp_path)["user_annotation"]
    launches = sorted(
        (e for e in ua if e[0] in {common.LAUNCH_SPANS[k] for k in (
            key, "padded_superstep")}), key=lambda e: e[1])
    ranges = _steps_ranges(ua)
    assert len(ranges) == len(launches)
    got = []
    for sp in launches:
        (inner,) = [r for r in ranges if _inside(r, sp)]
        got.append(int(inner[0][len(common.STEPS_SPAN):]))
    assert got == depths and sum(got) == steps
    # a ring refresh fuses no steps: it opens no range
    for sp in _named(ua, common.LAUNCH_SPANS["wrap_halo"]):
        assert not [r for r in ranges if _inside(r, sp)]
    if fields:
        assert _named(ua, common.LAUNCH_SPANS["wrap_halo"])
    with obs.profile() as rec:
        cs.run(grid)
    assert rec.counter(common.CELL_STEPS) == steps * math.prod(SHAPE)
    assert sorted(sp["steps"] for name in {common.LAUNCH_SPANS[key],
                                           "launch.padded_superstep"}
                  for sp in rec.spans(name)) == sorted(got)
    assert sum(len(rec.spans(common.STEPS_SPAN + str(t)))
               for t in set(got)) == len(got)


@pytest.mark.parametrize("par_time", [1, 3])
def test_prepadded_superstep_opens_its_steps_range(tmp_path, par_time):
    cs = _pinned("plain", 6, par_time=par_time)
    coeffs = cs.coeffs
    grid = _grid()

    def one():
        common.pad_superstep(grid, coeffs.center, coeffs.taps,
                             program=cs.program, plan=cs.plan)

    ua = _profiled(one, tmp_path)["user_annotation"]
    (launch,) = _named(ua, common.LAUNCH_SPANS["superstep"])
    (inner,) = _steps_ranges(ua)
    assert inner[0] == f"{common.STEPS_SPAN}{par_time}"
    assert _inside(inner, launch)


def test_latency_is_stamped_after_the_last_wait(monkeypatch):
    """A fake clock that ticks once a reading: every request's latency is
    one stamp, read after the last chunk's wait returned."""
    ticks = iter(range(1, 10**6))

    class Clock:
        @staticmethod
        def perf_counter():
            return float(next(ticks))

    monkeypatch.setattr(stencil_serve, "time", Clock)
    waited = []
    orig = stencil_serve.wait_ready

    def wait(out, done):
        out = orig(out, done)
        waited.append(Clock.perf_counter())
        return out

    monkeypatch.setattr(stencil_serve, "wait_ready", wait)
    server = StencilServer(max_batch=2, max_par_time=2, device="cpu")
    prog = _program()
    for i in range(3):
        server.submit(prog, _grid(i), 3)
    reqs = list(server._pending)
    server.flush()
    samples = server.recorder.samples("serve.request_latency_s")
    assert len(waited) == 2 and len(samples) == 3
    done = {r.t_submit + s for r, s in zip(reqs, samples)}
    assert len(done) == 1 and done.pop() > max(waited)


@pytest.mark.gpu
def test_launch_ranges_hold_their_runtime_call_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    prog = repro_torch.StencilProgram(ndim=2, radius=4)
    cs = repro_torch.stencil(prog).compile((512, 1024), steps=9,
                                           plan="auto")
    grid = torch.rand((512, 1024), device="cuda")
    cs.run(grid)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        cs.run(grid)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"].startswith("launch.")]
    calls = [e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "Launch" in e["name"]]
    assert ranges and calls
    for r in ranges:
        lo, hi = float(r["ts"]), float(r["ts"]) + float(r["dur"])
        assert any(lo <= float(c["ts"]) and
                   float(c["ts"]) + float(c["dur"]) <= hi
                   for c in calls), r["name"]
