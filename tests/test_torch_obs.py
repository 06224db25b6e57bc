"""The port's flight recorder (``repro_torch.obs``) against the reference's
``repro.obs``, and its instrumentation of the front door on the CPU.

* the same sequence of recorder calls gives the same counters, samples,
  percentiles, span records (timing fields aside), error classes and JSONL
  lines in both packages;
* the history ledger, the report and its CLI, the env switch (the port's
  own), ``profile()`` nesting and ``reset()``;
* the ``compile`` and ``run`` spans of ``device="cpu"`` runs, the trace
  guard (``torch.compiler.is_compiling``), RP105 counted through
  ``lint/diagnostics.raise_on_error``, and the kernel build span;
* the disabled path, structurally: no recorder, the shared no-op span.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import obs as ref_obs

import repro_torch
from repro_torch import obs
from repro_torch.analysis.hw import H100_SXM
from repro_torch.kernels import build
from repro_torch.lint import diagnostics
from repro_torch.lint.diagnostics import DiagnosticError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = ("REPRO_TORCH_OBS", "REPRO_TORCH_OBS_JSONL", "REPRO_TORCH_OBS_HISTORY",
       "REPRO_OBS", "REPRO_OBS_JSONL", "REPRO_OBS_HISTORY")
#: per-emit timing fields, which differ between any two recordings
TIMING = ("dur_s", "ts", "unix_time")


@pytest.fixture(autouse=True)
def _obs_isolation(monkeypatch):
    """Every test starts with both recorders off and no env spillover."""
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    obs.reset()
    ref_obs.reset()
    yield
    obs.reset()
    ref_obs.reset()


def _untimed(event):
    return {k: v for k, v in event.items() if k not in TIMING}


def _script(rec, variant):
    """One sequence of recorder calls; ``variant`` picks its mix."""
    with rec.span("work", tag="t", n=variant) as sp:
        sp.set(extra=1)
    rec.event("marker", x=variant)
    for i in range(variant + 1):
        rec.count("c", i + 1)
        rec.observe("lat", float(i * i + variant))
    rec.observe("occupancy", 0.25 * variant)
    rec.record_accuracy(backend="cuda", device="cpu", model_accuracy=0.5,
                        key="k", steps=variant)
    with pytest.raises(RuntimeError):
        with rec.span("boom", stage=variant):
            raise RuntimeError("x")
    if variant:
        with pytest.raises(KeyError):
            with rec.span("boom", stage=-variant):
                raise KeyError("y")


# ---- recorder parity with repro.obs ------------------------------------------

@pytest.mark.parametrize("variant", [0, 1, 4])
def test_recorder_matches_reference(tmp_path, variant):
    paths = {}
    recs = {}
    for name, mod in (("port", obs), ("ref", ref_obs)):
        paths[name] = tmp_path / name / "events.jsonl"
        recs[name] = mod.Recorder(jsonl_path=str(paths[name]))
        _script(recs[name], variant)
    port, ref = recs["port"], recs["ref"]
    assert dict(port.counters) == dict(ref.counters)
    for name in ("lat", "occupancy", "absent"):
        assert port.samples(name) == ref.samples(name)
        assert port.sample_sum(name) == ref.sample_sum(name)
        assert port.percentiles(name) == ref.percentiles(name)
        for q in (0, 50, 90, 100):
            assert port.percentile(name, q) == ref.percentile(name, q)
    assert [_untimed(e) for e in port.spans()] == \
        [_untimed(e) for e in ref.spans()]
    assert [e.get("error") for e in port.spans("boom")] == \
        [e.get("error") for e in ref.spans("boom")]
    assert [_untimed(e) for e in port.accuracy_samples()] == \
        [_untimed(e) for e in ref.accuracy_samples()]
    assert [_untimed(e) for e in port.events] == \
        [_untimed(e) for e in ref.events]
    port.close()
    ref.close()
    lines = {name: [json.loads(ln) for ln in p.read_text().splitlines()]
             for name, p in paths.items()}
    assert [sorted(e) for e in lines["port"]] == \
        [sorted(e) for e in lines["ref"]]
    assert [_untimed(e) for e in lines["port"]] == \
        [_untimed(e) for e in lines["ref"]]
    assert lines["port"][-1]["type"] == "counter"
    assert lines["port"][-1]["counters"] == dict(port.counters)


@pytest.mark.parametrize("values,q", [
    ([], 50), ([3.0], 99), ([1.0, 2.0, 3.0, 4.0, 10.0], 50),
    ([5.0, 1.0, 4.0, 2.0], 95), ([0.1 * i for i in range(101)], 99)])
def test_percentile_matches_reference(values, q):
    assert obs.percentile(values, q) == ref_obs.percentile(values, q)


def test_span_records_error_class():
    rec = obs.Recorder()
    with pytest.raises(ValueError):
        with rec.span("boom"):
            raise ValueError("x")
    (sp,) = rec.spans("boom")
    assert sp["error"] == "ValueError" and sp["dur_s"] >= 0


# ---- history ledger and report ----------------------------------------------

def test_history_schema_read_back_and_report(tmp_path):
    history = tmp_path / "history.jsonl"
    events = tmp_path / "events.jsonl"
    with obs.profile(jsonl_path=str(events),
                     history_path=str(history)) as rec:
        with rec.span("compile", backend="cuda@1", cache_hit=True):
            pass
        with rec.span("compile", backend="cuda@1", cache_hit=False):
            pass
        rec.count("compile.plan_cache_hit")
        for acc, device in ((0.5, "cpu"), (0.7, "cpu"), (1.02, "cuda")):
            rec.record_accuracy(backend="cuda", device=device,
                                chip="NVIDIA H100 SXM", model_accuracy=acc)
    with open(history, "a") as f:
        f.write("not json\n")
        f.write(json.dumps({"schema": 999, "model_accuracy": 9.0}) + "\n")
    ledger = obs.read_history(str(history))
    assert [s["model_accuracy"] for s in ledger] == [0.5, 0.7, 1.02]
    assert all(s["schema"] == obs.SCHEMA_VERSION and "unix_time" in s
               for s in ledger)

    from repro_torch.obs.report import render, summarize
    summary = summarize(str(history), events_path=str(events))
    groups = summary["history"]["backends"]
    # a CPU run of the H100 model never averages with the card's
    assert set(groups) == {"cuda on cpu", "cuda on cuda"}
    assert groups["cuda on cpu"]["count"] == 2
    assert groups["cuda on cpu"]["mean"] == pytest.approx(0.6)
    assert groups["cuda on cuda"]["p50"] == 1.02
    assert summary["events"]["compile"]["cache_hit_rate"] == 0.5
    assert summary["events"]["counters"]["compile.plan_cache_hit"] == 1
    text = render(summary)
    assert "cuda on cuda" in text and "plan cache" in text

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "report",
         "--history", str(history), "--events", str(events), "--json"],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout)
    assert loaded["history"]["samples"] == 3
    assert loaded["history"]["backends"]["cuda on cpu"]["count"] == 2


def test_report_on_missing_history(tmp_path):
    from repro_torch.obs.report import render, summarize
    summary = summarize(str(tmp_path / "absent.jsonl"))
    assert summary["history"]["samples"] == 0
    assert "no accuracy samples" in render(summary)


def test_ledgers_and_switches_are_the_ports_own():
    """No TPU sample lands in the port's ledger and no port sample in the
    reference's: other files, other environment variables."""
    from repro.obs import history as ref_history
    from repro_torch.obs import history
    assert os.path.abspath(history.DEFAULT_HISTORY_PATH) != \
        os.path.abspath(ref_history.DEFAULT_HISTORY_PATH)
    assert history.DEFAULT_HISTORY_PATH.endswith(
        os.path.join("build", "repro_torch", "history.jsonl"))
    assert history.ENV_HISTORY_PATH != ref_history.ENV_HISTORY_PATH
    assert obs.ENV_SWITCH != ref_obs.ENV_SWITCH


# ---- switch semantics --------------------------------------------------------

def test_disabled_path_builds_nothing():
    assert obs.active() is None and not obs.enabled()
    assert obs.span("anything", a=1) is obs.NULL_SPAN
    with obs.span("x") as sp:
        assert sp is obs.NULL_SPAN and sp.set(k=2) is sp
    obs.event("e", x=1)
    obs.count("c", 3)
    obs.observe("s", 0.5)
    assert obs.record_accuracy(model_accuracy=1.0) is None
    from repro_torch.obs import _state
    assert _state["env_recorder"] is None and _state["override"] is None


def test_env_switch(monkeypatch, tmp_path):
    for off in ("0", "false", "off", "no", ""):
        monkeypatch.setenv("REPRO_TORCH_OBS", off)
        obs.reset()
        assert obs.active() is None
    # the reference's switch does not turn the port on
    monkeypatch.delenv("REPRO_TORCH_OBS")
    monkeypatch.setenv("REPRO_OBS", "1")
    obs.reset()
    assert obs.active() is None
    monkeypatch.setenv("REPRO_TORCH_OBS", "1")
    monkeypatch.setenv("REPRO_TORCH_OBS_JSONL", str(tmp_path / "ev.jsonl"))
    monkeypatch.setenv("REPRO_TORCH_OBS_HISTORY", str(tmp_path / "h.jsonl"))
    obs.reset()
    rec = obs.active()
    assert rec is not None and obs.active() is rec
    assert rec.jsonl_path == str(tmp_path / "ev.jsonl")
    assert rec.history_path == str(tmp_path / "h.jsonl")
    obs.record_accuracy(backend="cuda", device="cpu", model_accuracy=1.0)
    assert len(obs.read_history(str(tmp_path / "h.jsonl"))) == 1
    # an empty history variable disables the ledger
    monkeypatch.setenv("REPRO_TORCH_OBS_HISTORY", "")
    obs.reset()
    assert obs.active().history_path is None


def test_profile_nests_restores_and_reset_forgets(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_OBS", "0")
    obs.reset()
    with obs.profile() as outer:
        assert obs.active() is outer
        obs.count("outer")
        with obs.profile() as inner:
            assert obs.active() is inner
            obs.count("inner")
        assert obs.active() is outer
        obs.count("outer")
    assert obs.active() is None
    assert outer.counter("outer") == 2 and outer.counter("inner") == 0
    assert inner.counter("inner") == 1
    rec = obs.enable()
    assert obs.active() is rec
    obs.reset()
    assert obs.active() is None


# ---- front-door instrumentation ---------------------------------------------

def _compiled(**kwargs):
    prog = repro_torch.StencilProgram(ndim=2, radius=1)
    kwargs.setdefault("plan", "model")
    cs = repro_torch.stencil(prog).compile((20, 140), steps=3,
                                           max_par_time=2, device="cpu",
                                           **kwargs)
    grid = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, (20, 140)).astype(np.float32))
    return cs, grid


@pytest.mark.parametrize("variant", ["plain", "temporal"])
def test_compile_and_run_spans_on_the_cpu(tmp_path, variant):
    from repro_torch.core.blocking import run_seconds
    from repro_torch.tuning.cache import cache_key
    history = tmp_path / "history.jsonl"
    with obs.profile(history_path=str(history)) as rec:
        cs, grid = _compiled(variant=variant)
        out = cs.run(grid)
        cs.run(grid, steps=5)
    assert torch.equal(out, cs.run(grid))       # recording changes nothing

    (sp,) = rec.spans("compile")
    assert sp["plan_source"] == "model" and sp["cache_hit"] is False
    assert sp["backend"] == f"{cs.backend}@{cs.backend_version}"
    assert sp["variant"] == variant == cs.variant
    assert sp["block_shape"] == list(cs.plan.block_shape)
    assert sp["par_time"] == cs.plan.par_time
    assert sp["supersteps"] == -(-3 // cs.plan.par_time)
    assert sp["model_bytes_per_superstep"] == \
        cs.plan.run_bytes_per_superstep((20, 140), variant) > 0
    assert sp["predicted_s"] == run_seconds(cs.plan, (20, 140), 3, H100_SXM,
                                            variant)
    assert sp["device"] == "cpu" and sp["chip"] == H100_SXM.name
    assert rec.counter("compile.plan_cache_miss") == 1

    first, second = rec.spans("run")
    assert (first["steps"], second["steps"]) == (3, 5)
    for run_sp, steps in ((first, 3), (second, 5)):
        cells = 20 * 140 * steps
        wall = run_sp["wall_s"]
        assert wall > 0 and run_sp["dur_s"] >= wall
        assert run_sp["device_s"] is None and run_sp["host_s"] is None
        assert run_sp["launch_delta"] is None
        assert run_sp["mcells_per_s"] == pytest.approx(cells / wall / 1e6)
        assert run_sp["achieved_gbps"] == pytest.approx(
            cells * cs.program.bytes_per_cell / wall / 1e9)
        assert run_sp["achieved_gflops"] == pytest.approx(
            cells * cs.program.flops_per_cell / wall / 1e9)
        assert run_sp["predicted_s"] == run_seconds(
            cs.plan, (20, 140), steps, H100_SXM, variant)
        assert run_sp["model_accuracy"] == pytest.approx(
            run_sp["predicted_s"] / wall)
        assert run_sp["model_accuracy"] == pytest.approx(
            run_sp["achieved_gbps"] / run_sp["predicted_gbps"])

    samples = rec.accuracy_samples()
    assert [s["steps"] for s in samples] == [3, 5]
    key = cache_key(cs.program, (20, 140), H100_SXM.name, cs.backend,
                    cs.backend_version, device="cpu")
    assert cs.history_key() == key and cs.history_key() is cs.history_key()
    for s, run_sp in zip(samples, (first, second)):
        assert s["key"] == key and s["device"] == "cpu"
        assert s["chip"] == H100_SXM.name and s["backend"] == cs.backend
        assert s["model_accuracy"] == run_sp["model_accuracy"]
        assert s["source"] == "executor.run"
    assert [s["steps"] for s in obs.read_history(str(history))] == [3, 5]


def test_batched_run_span_counts_every_grid():
    prog = repro_torch.StencilProgram(ndim=2, radius=1)
    cs = repro_torch.stencil(prog).compile((20, 140), steps=3, batch=3,
                                           plan="model", max_par_time=2,
                                           device="cpu")
    with obs.profile() as rec:
        cs.run(torch.zeros(3, 20, 140))
    (sp,) = rec.spans("run")
    assert sp["batch"] == 3
    assert sp["mcells_per_s"] == pytest.approx(
        3 * 20 * 140 * 3 / sp["wall_s"] / 1e6)


def test_autotuned_compile_reports_the_plan_cache(tmp_path):
    path = str(tmp_path / "plans.json")
    with obs.profile() as rec:
        cold, _ = _compiled(plan="auto", cache_path=path)
        warm, _ = _compiled(plan="auto", cache_path=path)
    assert cold.tuned is not None and not cold.from_plan_cache
    assert warm.tuned.from_cache and warm.from_plan_cache
    assert [s["cache_hit"] for s in rec.spans("compile")] == [False, True]
    assert [s["plan_source"] for s in rec.spans("compile")] == ["auto"] * 2
    assert rec.counter("compile.plan_cache_miss") == 1
    assert rec.counter("compile.plan_cache_hit") == 1
    pinned, _ = _compiled(plan=warm.plan)
    assert pinned.tuned is None and not pinned.from_plan_cache


def test_trace_guard_records_nothing(monkeypatch):
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with obs.profile() as rec:
        cs, grid = _compiled()
        cs.run(grid)
    assert rec.events == [] and not rec.counters


def test_recorder_off_records_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_OBS", "0")
    monkeypatch.setenv("REPRO_TORCH_OBS_JSONL", str(tmp_path / "ev.jsonl"))
    monkeypatch.setenv("REPRO_TORCH_OBS_HISTORY", str(tmp_path / "h.jsonl"))
    obs.reset()
    cs, grid = _compiled()
    cs.run(grid)
    assert obs.active() is None
    assert not (tmp_path / "ev.jsonl").exists()
    assert not (tmp_path / "h.jsonl").exists()


def _rp105_config():
    """A 3D diamond r4 plan whose 4 steps fit a CTA tile and whose 5 and 9
    do not (the H100's shared memory)."""
    prog = repro_torch.StencilProgram(ndim=3, radius=4, shape="diamond")
    plan = repro_torch.BlockPlan(spec=prog, block_shape=(32, 64, 704),
                                 par_time=8)
    return prog, plan, (6, 8, 40)


def test_rp105_is_counted_through_raise_on_error():
    prog, plan, shape = _rp105_config()
    with obs.profile() as rec:
        with pytest.raises(DiagnosticError, match="RP105"):
            repro_torch.stencil(prog).compile(shape, steps=9, plan=plan,
                                              device="cpu", chip=H100_SXM)
        (sp,) = rec.spans("compile")
        assert sp["error"] == "DiagnosticError"
        cs = repro_torch.stencil(prog).compile(shape, steps=4, plan=plan,
                                               device="cpu", chip=H100_SXM)
        with pytest.raises(DiagnosticError, match="RP105"):
            cs.run(torch.zeros(shape), steps=5)
    assert rec.counter("lint.code.RP105") == 2
    assert rec.counter("lint.verify.error") == 2
    # the 4-step compile that fits carries one warning: its CTA tile keeps
    # under a quarter of its work (RP113)
    assert rec.counter("lint.code.RP113") == 1
    assert rec.counter("lint.verify.warning") == 1
    assert rec.counter("lint.diagnostics") == 3
    assert rec.spans("run") == []       # refused before the span


def test_raise_on_error_passes_warnings_and_counts_them():
    warn = diagnostics.warning("RP105", "close to the limit", hint="h")
    err = diagnostics.error("RP110", "no card")
    assert not warn.is_error and err.is_error
    assert warn.to_json() == {"code": "RP105", "severity": "warning",
                              "message": "close to the limit", "hint": "h"}
    with obs.profile() as rec:
        assert diagnostics.raise_on_error([warn], source="verify") == [warn]
        with pytest.raises(DiagnosticError) as info:
            diagnostics.raise_on_error([warn, err], source="plan")
    assert info.value.diagnostics == [err]
    assert rec.counter("lint.diagnostics") == 3
    assert rec.counter("lint.verify.warning") == 1
    assert rec.counter("lint.plan.warning") == 1
    assert rec.counter("lint.plan.error") == 1
    assert rec.counter("lint.code.RP110") == 1
    # off: nothing to count, the same refusal
    with pytest.raises(DiagnosticError):
        diagnostics.raise_on_error([err])


def test_kernel_build_span(tmp_path, monkeypatch):
    """A build runs inside a ``kernels.build`` span naming its sources; a
    library already built emits nothing."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    src = "wrap_halo.cu"

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "nvcc", no_nvcc)
    with obs.profile() as rec:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.build([src])
        build.library_path(src).write_bytes(b"")
        build.log_path(src).write_text("ptxas info\n")
        assert build.build([src]) == {}
    (sp,) = rec.spans("kernels.build")
    assert sp["sources"] == [src] and sp["error"] == "RuntimeError"
