"""The port's autotuner (``repro_torch.tuning``) on the CPU: its space,
ranking, plan cache (its own file, environment variable and schema, the
GPU's name in the key; TPU records never serve) and measurement harness,
beside the reference's tuner where they share a contract.  Every test
keeps its plan cache under ``tmp_path``."""

from __future__ import annotations

import json

import pytest

from repro.analysis.hw import V5E
from repro.tuning import cache as ref_cache

import repro_torch
from repro_torch.analysis.hw import H100_SXM
from repro_torch.configs import stencil2d, stencil3d
from repro_torch.core import blocking
from repro_torch.lint.verify import smem_diagnostics
from repro_torch.tuning import (PlanCache, autotune, cache_key,
                                enumerate_space, program_fingerprint, rank)
from repro_torch.tuning import cache as tcache
from repro_torch.tuning import cli
from repro_torch.tuning.measure import measure_candidate

PROG = repro_torch.StencilProgram(ndim=2, radius=1)
GRID = (24, 96)


def _tune(tmp_path, **kw):
    args = dict(grid_shape=GRID, measure=False, device="cpu",
                cache_path=str(tmp_path / "plans.json"))
    args.update(kw)
    return autotune(PROG, **args)


# ---- space and ranking -------------------------------------------------------

@pytest.mark.parametrize("variant", ["plain", "pipelined", "temporal"])
def test_space_holds_only_plans_that_fit(variant):
    name = "cuda" if variant == "plain" else f"cuda-{variant}"
    work = stencil3d.workloads()["3d_r2_paper"]
    space = enumerate_space(work.spec, H100_SXM, backends=(name,),
                            grid_shape=work.grid_shape, max_par_time=32)
    assert space and {c.variant for c in space} == {variant}
    for c in space:
        assert smem_diagnostics(c.plan, variant, H100_SXM) == []
        kernel = blocking.CARRY_KERNELS[variant]
        assert blocking.launch_work(c.plan, kernel)[3] > \
            blocking.MIN_USEFUL_FRACTION
    assert {c.csize for c in space} <= set(blocking.candidate_blocks(
        3, work.grid_shape))


def test_rank_is_best_first_and_deterministic():
    work = stencil2d.workloads()["2d_r4_paper"]
    space = enumerate_space(work.spec, H100_SXM, grid_shape=work.grid_shape)
    ranked = rank(work.spec, space, H100_SXM, grid_shape=work.grid_shape)
    gbps = [r.predicted_gbps for r in ranked]
    assert gbps == sorted(gbps, reverse=True)
    again = rank(work.spec, list(reversed(space)), H100_SXM,
                 grid_shape=work.grid_shape)
    assert [r.candidate for r in again] == [r.candidate for r in ranked]
    assert rank(work.spec, space, top_k=3, grid_shape=work.grid_shape) == \
        ranked[:3]
    assert ranked[0].body == "queue"


# ---- the plan cache ------------------------------------------------------------

def test_cache_key_holds_the_gpu_name():
    keys = {cache_key(PROG, GRID, name, "cuda", 1)
            for name in ("NVIDIA H100 80GB HBM3", H100_SXM.name, V5E.name)}
    assert len(keys) == 3
    assert cache_key(PROG, GRID, H100_SXM.name, "cuda", 1, device="cpu") \
        != cache_key(PROG, GRID, H100_SXM.name, "cuda", 1, device="cuda")
    assert program_fingerprint(PROG) == program_fingerprint(
        repro_torch.StencilProgram(ndim=2, radius=1))


def test_default_path_and_env_differ_from_the_reference(monkeypatch,
                                                          tmp_path):
    monkeypatch.delenv(tcache.ENV_CACHE_PATH, raising=False)
    monkeypatch.delenv(ref_cache.ENV_CACHE_PATH, raising=False)
    assert tcache.ENV_CACHE_PATH != ref_cache.ENV_CACHE_PATH
    assert tcache.default_cache_path() != ref_cache.default_cache_path()
    assert tcache.default_cache_path().endswith(
        "build/repro_torch/plans.json")
    monkeypatch.setenv(ref_cache.ENV_CACHE_PATH, str(tmp_path / "tpu.json"))
    assert PlanCache().path != str(tmp_path / "tpu.json")
    monkeypatch.setenv(tcache.ENV_CACHE_PATH, str(tmp_path / "gpu.json"))
    assert PlanCache().path == str(tmp_path / "gpu.json")


def test_reference_records_never_serve(tmp_path):
    """A TPU record, under the reference's key or under the port's key
    with the reference's chip name, is never a hit."""
    path = tmp_path / "plans.json"
    from repro.core.program import StencilProgram as RefProgram
    ref_prog = RefProgram(ndim=2, radius=1)
    bogus = {"block_shape": [8, 128], "par_time": 7, "backend": "cuda",
             "backend_version": 1, "predicted_gbps": 1e9, "variant": "plain",
             "search": {"max_par_time": 64, "bsizes": None},
             "measurement": None}
    keys = [ref_cache.cache_key(ref_prog, GRID, V5E.name, "pallas-tpu", 1),
            cache_key(PROG, GRID, V5E.name, "cuda", 1, device="cpu")]
    path.write_text(json.dumps({k: [bogus] for k in keys}))
    tuned = _tune(tmp_path)
    assert not tuned.from_cache and tuned.plan.par_time != 7
    assert tuned.key not in keys


def test_model_only_record_does_not_satisfy_measure(tmp_path):
    first = _tune(tmp_path)
    assert not first.from_cache and first.measurement is None
    assert _tune(tmp_path).from_cache
    measured = _tune(tmp_path, measure=True, top_k=1, reps=1)
    assert not measured.from_cache and measured.measurement is not None
    assert _tune(tmp_path, measure=True, top_k=1, reps=1).from_cache


def test_force_retunes(tmp_path):
    first = _tune(tmp_path)
    again = _tune(tmp_path, force=True)
    assert not again.from_cache and again.plan == first.plan
    assert len(PlanCache(str(tmp_path / "plans.json"))) == 1


def test_narrower_bounds_are_served_only_from_within(tmp_path):
    wide = _tune(tmp_path, max_par_time=32)
    narrow = _tune(tmp_path, max_par_time=wide.plan.par_time - 1) \
        if wide.plan.par_time > 1 else None
    if narrow is not None:
        assert not narrow.from_cache
        assert narrow.plan.par_time <= wide.plan.par_time - 1
    blocks = [(24, 96)]
    pinned = _tune(tmp_path, bsizes=blocks)
    assert pinned.plan.block_shape == (24, 96)
    assert _tune(tmp_path, bsizes=blocks).from_cache


# ---- measurement on the CPU --------------------------------------------------

def test_measure_on_the_cpu_then_hit_the_cache(tmp_path):
    tuned = _tune(tmp_path, measure=True, top_k=2, reps=1, variant="auto")
    m = tuned.measurement
    assert m is not None and m.ok and m.device == "cpu"
    assert m.measured_ms > 0 and m.predicted_ms > 0
    assert m.model_accuracy == pytest.approx(m.predicted_ms / m.measured_ms)
    assert len(tuned.measurements) == 2
    assert all(x.ok for x in tuned.measurements)
    # one step count for the whole frontier: two of its deepest supersteps
    deepest = max(x.candidate.par_time * (
        4 if x.candidate.variant == "temporal" else 1)
        for x in tuned.measurements)
    assert {x.steps for x in tuned.measurements} == {2 * deepest}
    again = _tune(tmp_path, measure=True, top_k=2, reps=1, variant="auto")
    assert again.from_cache and again.plan == tuned.plan
    assert again.measurement.device == "cpu"
    assert again.measurement.measured_ms == m.measured_ms


def test_a_failing_candidate_is_recorded_and_all_failing_raises(
        tmp_path, monkeypatch):
    work = rank(PROG, enumerate_space(PROG, H100_SXM, grid_shape=GRID),
                grid_shape=GRID)
    bad = measure_candidate(PROG, work[0], (24,), device="cpu")
    assert not bad.ok and bad.stage is not None and bad.error
    from repro_torch.tuning import measure
    monkeypatch.setattr(
        measure, "lower",
        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
    with pytest.raises(RuntimeError, match="every frontier candidate"):
        _tune(tmp_path, measure=True, top_k=2, reps=1)


def test_measure_rejects_caller_errors():
    ranked = rank(PROG, enumerate_space(PROG, H100_SXM, grid_shape=GRID),
                  grid_shape=GRID)[0]
    for kw in (dict(reps=0), dict(warmup=-1), dict(supersteps=0)):
        with pytest.raises(ValueError):
            measure_candidate(PROG, ranked, GRID, device="cpu", **kw)


def test_autotune_runs_on_the_card_by_default(monkeypatch, tmp_path):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="device='cpu'"):
        autotune(PROG, grid_shape=GRID, measure=False,
                 cache_path=str(tmp_path / "p.json"))


def test_variant_requests(tmp_path):
    assert _tune(tmp_path, variant="temporal").backend == "cuda-temporal"
    assert _tune(tmp_path, backend="cuda-pipelined").variant == "pipelined"
    searched = _tune(tmp_path, variant="auto")
    assert searched.backend in ("cuda", "cuda-pipelined", "cuda-temporal")
    with pytest.raises(ValueError, match="no 'temporal' lowering"):
        _tune(tmp_path, backend="torch-reference", variant="temporal")


# ---- the CLI -------------------------------------------------------------------

def test_cli_tune_inspect_clear(tmp_path, capsys):
    path = str(tmp_path / "plans.json")
    assert cli.main(["tune", "--ndim", "2", "--radius", "1", "--grid",
                     "24,96", "--device", "cpu", "--top-k", "1",
                     "--cache", path]) == 0
    out = capsys.readouterr().out
    assert "plan [search" in out and "measured on cpu" in out \
        and "predicted" in out
    assert cli.main(["tune", "--ndim", "2", "--radius", "1", "--grid",
                     "24,96", "--device", "cpu", "--top-k", "1",
                     "--cache", path]) == 0
    assert "plan [cache]" in capsys.readouterr().out
    assert cli.main(["inspect", "--cache", path]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert "1 plan(s)" in lines[0]
    assert json.loads(lines[1])["measured_on"] == "cpu"
    assert cli.main(["clear-cache", "--cache", path]) == 0
    assert "cleared 1 plan(s)" in capsys.readouterr().out


def test_configs_autotune_workloads(tmp_path):
    small = {"tiny": stencil2d.StencilWorkload(
        name="tiny", spec=PROG, grid_shape=GRID, block_shape=(1024, 1024),
        par_time=1)}
    tuned = stencil2d.autotune_workloads(
        small, cache_path=str(tmp_path / "p.json"), device="cpu")
    want = _tune(tmp_path).plan
    assert (tuned["tiny"].block_shape, tuned["tiny"].par_time) == \
        (want.block_shape, want.par_time)
    works = stencil3d.workloads(radius=1, autotune=True,
                                cache_path=str(tmp_path / "p.json"),
                                device="cpu")
    for name, w in works.items():
        plan = w.plan()
        assert smem_diagnostics(plan, "plain", H100_SXM) == []
