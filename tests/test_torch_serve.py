"""The port's serving front (``repro_torch.launch.stencil_serve``) against
the reference's (``repro.launch.stencil_serve``) on the same seeded
requests, and its own contract on the CPU: batching, failure isolation,
request validation, the cold/warm split, and no silent fallback.

The port serves on ``device="cpu"`` here (the kernels' plain versions);
the reference runs its Pallas kernels in interpret mode.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.program import StencilProgram as RefProgram
from repro.launch.stencil_serve import StencilServer as RefServer

import repro_torch
from repro_torch import convert, executor
from repro_torch.analysis.hw import H100_SXM
from repro_torch.launch import stencil_serve
from repro_torch.launch.stencil_serve import StencilServer
from repro_torch.lint.diagnostics import DiagnosticError

#: the reference's ULP tolerance (tests/test_padded_carry.py)
ULP = dict(atol=1e-6, rtol=1e-5)


def _program(**fields):
    """The same program in both packages."""
    ref = RefProgram(**fields)
    return ref, convert.program_from_fields(**dataclasses.asdict(ref))


def _mix(seed=0):
    """(program fields, grid, steps) of the parity mix, in submit order."""
    rng = np.random.RandomState(seed)
    star = dict(ndim=2, radius=1)
    box = dict(ndim=2, radius=1, shape="box", boundary="periodic")
    star3 = dict(ndim=3, radius=2)
    reqs = [(star, rng.uniform(-1, 1, (20, 140)), 3) for _ in range(5)]
    reqs += [(box, rng.uniform(-1, 1, (24, 130)), 2) for _ in range(2)]
    reqs += [(star3, rng.uniform(-1, 1, (8, 16, 128)), 2) for _ in range(3)]
    reqs += [(star, rng.uniform(-1, 1, (20, 140)), 0) for _ in range(2)]
    return reqs


def _untimed(span):
    return {k: span[k] for k in ("requests", "results", "failed", "groups")}


def test_server_matches_reference():
    port = StencilServer(max_batch=4, max_par_time=2, device="cpu")
    ref = RefServer(max_batch=4, max_par_time=2)
    rids = []
    for fields, grid, steps in _mix():
        rp, tp = _program(**fields)
        rids.append((ref.submit(rp, grid, steps),
                     port.submit(tp, grid, steps)))
    want = ref.flush()
    got = port.flush()
    assert set(got) == {p for _, p in rids} and not port.failed
    for (r, p), (_, grid, steps) in zip(rids, _mix()):
        assert isinstance(got[p], torch.Tensor)
        assert got[p].device == torch.device("cpu")
        assert tuple(got[p].shape) == grid.shape
        np.testing.assert_allclose(got[p].numpy(), np.asarray(want[r]),
                                   **ULP)
        if steps == 0:
            assert np.array_equal(got[p].numpy(), grid.astype(np.float32))
    ps, rs = port.stats, ref.stats
    for name in ("requests", "batches", "batched_requests", "cell_steps",
                 "sharded_batches"):
        assert getattr(ps, name) == getattr(rs, name), name
    assert (ps.requests, ps.batches, ps.batched_requests) == (12, 5, 11)
    assert ps.cell_steps == 5 * 20 * 140 * 3 + 2 * 24 * 130 * 2 \
        + 3 * 8 * 16 * 128 * 2
    assert port.failed == ref.failed == {}
    assert port.recorder.counter("serve.failed") == \
        ref.recorder.counter("serve.failed") == 0
    for name in ("serve.queue_depth", "serve.batch_occupancy"):
        assert port.recorder.samples(name) == ref.recorder.samples(name)
    assert port.recorder.samples("serve.batch_occupancy") == \
        [1.0, 0.25, 0.5, 0.75, 0.5]
    (pf,), (rf,) = port.recorder.spans("serve.flush"), \
        ref.recorder.spans("serve.flush")
    assert _untimed(pf) == _untimed(rf)
    assert len(port.recorder.samples("serve.request_latency_s")) == \
        len(ref.recorder.samples("serve.request_latency_s")) == 12
    assert port.mesh_fallbacks == {} and ps.sharded_batches == 0


def test_batched_results_equal_unbatched_runs():
    """Every served result equals the front door's unbatched run of its
    grid under the server's plan for that shape, at 0."""
    server = StencilServer(max_batch=4, max_par_time=2, device="cpu")
    requests = [(tp, torch.as_tensor(grid, dtype=torch.float32), steps)
                for fields, grid, steps in _mix(1)
                for tp in [_program(**fields)[1]]]
    rids = [server.submit(tp, grid, steps) for tp, grid, steps in requests]
    results = server.flush()
    from repro_torch.tuning.cache import program_fingerprint
    for rid, (tp, grid, steps) in zip(rids, requests):
        if steps == 0:
            torch.testing.assert_close(results[rid], grid, rtol=0, atol=0)
            continue
        plan, backend = server._resolved[(program_fingerprint(tp),
                                          tuple(grid.shape))]
        want = repro_torch.stencil(tp).compile(
            tuple(grid.shape), steps=steps, plan=plan, backend=backend,
            device="cpu").run(grid)
        torch.testing.assert_close(results[rid], want, rtol=0, atol=0)


@pytest.mark.parametrize("variant,backend", [
    (None, "cuda"), ("temporal", "cuda-temporal"),
    ("pipelined", "cuda-pipelined")])
def test_one_plan_per_shape_pins_every_chunk(variant, backend):
    prog = repro_torch.StencilProgram(ndim=2, radius=1)
    server = StencilServer(max_batch=2, max_par_time=2, device="cpu",
                           variant=variant)
    rng = np.random.RandomState(3)
    for steps in (3, 3, 3, 5):
        server.submit(prog, rng.uniform(-1, 1, (20, 140)), steps)
    results = server.flush()
    assert len(results) == 4
    compiled = list(server._compiled.values())
    assert {k[2] for k in server._compiled} == {2, None}
    assert len(server._resolved) == 1
    assert {(cs.plan, cs.backend) for cs in compiled} == \
        set(server._resolved.values())
    assert {cs.backend for cs in compiled} == {backend}


def test_autotuned_server_pins_the_tuned_plan(tmp_path):
    prog = repro_torch.StencilProgram(ndim=2, radius=1)
    server = StencilServer(max_batch=2, max_par_time=2, device="cpu",
                           use_autotune=True,
                           cache_path=str(tmp_path / "plans.json"))
    rng = np.random.RandomState(4)
    for _ in range(3):
        server.submit(prog, rng.uniform(-1, 1, (20, 140)), 3)
    assert len(server.flush()) == 3
    first, second = server._compiled.values()
    assert first.tuned is not None and second.tuned is None
    assert (second.plan, second.backend) == (first.plan, first.backend)


def test_server_stats_split_and_latency():
    prog = repro_torch.StencilProgram(ndim=2, radius=1)
    server = StencilServer(max_batch=4, max_par_time=2, device="cpu")
    rng = np.random.RandomState(0)
    rids = [server.submit(prog, rng.uniform(-1, 1, (20, 140)), steps=3)
            for _ in range(5)]
    results = server.flush()
    assert set(results) == set(rids) and not server.failed

    s = server.stats
    assert s.requests == 5
    assert s.batches == 2               # 4 + 1
    assert s.batched_requests == 4
    assert s.compile_seconds > 0        # both chunk shapes compiled cold
    assert s.run_seconds > 0            # the resolution pass always counts
    assert s.seconds == pytest.approx(s.compile_seconds + s.run_seconds)
    assert s.cell_steps == 5 * 20 * 140 * 3

    rec = server.recorder
    assert rec.samples("serve.queue_depth") == [5.0]
    assert rec.samples("serve.batch_occupancy") == [1.0, 0.25]
    lat = s.latency_percentiles()
    assert len(rec.samples("serve.request_latency_s")) == 5
    assert 0 < lat["p50"] <= lat["p95"] <= lat["p99"]
    (flush_span,) = rec.spans("serve.flush")
    assert flush_span["requests"] == 5
    assert flush_span["results"] == 5
    assert flush_span["failed"] == 0

    # a second flush of the same shapes is warm: run time, no compile time
    compile_before = s.compile_seconds
    rid = server.submit(prog, rng.uniform(-1, 1, (20, 140)), steps=3)
    for _ in range(3):
        server.submit(prog, rng.uniform(-1, 1, (20, 140)), steps=3)
    out = server.flush()
    assert rid in out
    assert s.compile_seconds == compile_before
    assert s.requests == 9
    assert len(rec.samples("serve.compile_s")) == 2


def test_server_records_failures_and_identity_batches(monkeypatch):
    prog = repro_torch.StencilProgram(ndim=2, radius=1)
    server = StencilServer(max_batch=4, max_par_time=2, device="cpu")
    rng = np.random.RandomState(1)
    ident = [server.submit(prog, rng.uniform(-1, 1, (20, 140)), steps=0)
             for _ in range(2)]
    bad = server.submit(prog, rng.uniform(-1, 1, (24, 130)), steps=2)

    def exploding(self, grid, steps=None):
        raise RuntimeError("deliberate failure")

    monkeypatch.setattr(executor.CompiledStencil, "run", exploding)
    results = server.flush()
    assert set(results) == set(ident)
    assert set(server.failed) == {bad}
    assert server.recorder.counter("serve.failed") == 1
    assert server.stats.batches == 1     # only the identity chunk ran
    assert server.stats.cell_steps == 0  # identity contributes no work


def test_server_isolates_group_failures(monkeypatch):
    """A group failing to plan, compile or run on the host loses only its
    own requests; every other group's results still come back."""
    prog = repro_torch.StencilProgram(ndim=2, radius=1)
    server = StencilServer(max_batch=4, max_par_time=2, device="cpu")
    rng = np.random.RandomState(1)
    good = [server.submit(prog, rng.uniform(-1, 1, (20, 140)), steps=2)
            for _ in range(2)]
    bad = [server.submit(prog, rng.uniform(-1, 1, (24, 130)), steps=2)]

    orig = executor.CompiledStencil.run

    def exploding(self, grid, steps=None):
        # by the executable's shape: a batched chunk's grid is a list
        if self.grid_shape == (24, 130):
            raise RuntimeError("deliberate group failure")
        return orig(self, grid, steps)

    monkeypatch.setattr(executor.CompiledStencil, "run", exploding)
    results = server.flush()
    assert set(results) == set(good)
    assert set(server.failed) == set(bad)
    assert "deliberate group failure" in server.failed[bad[0]]
    assert server.pending() == 0
    (span,) = server.recorder.spans("serve.flush")
    assert (span["results"], span["failed"]) == (2, 1)


def test_server_isolates_a_refused_plan():
    """A plan refused before any launch (RP105 on the H100's shared
    memory) fails its own group only."""
    prog = repro_torch.StencilProgram(ndim=3, radius=4, shape="diamond")
    plan = repro_torch.BlockPlan(spec=prog, block_shape=(32, 64, 704),
                                 par_time=8)
    small = repro_torch.StencilProgram(ndim=2, radius=1)
    server = StencilServer(max_batch=4, max_par_time=2, device="cpu",
                           chip=H100_SXM)
    good = server.submit(small, np.zeros((20, 140)), steps=2)
    bad = server.submit(prog, np.zeros((6, 8, 40)), steps=9)
    from repro_torch.tuning.cache import program_fingerprint
    server._resolved[(program_fingerprint(prog), (6, 8, 40))] = \
        (plan, "cuda")
    results = server.flush()
    assert set(results) == {good}
    assert "RP105" in server.failed[bad]


def test_server_isolates_deferred_execution_failures(monkeypatch):
    """A chunk whose wait raises (the resolution pass, after every group
    was enqueued) fails only its own rids."""
    prog = repro_torch.StencilProgram(ndim=2, radius=1)
    server = StencilServer(max_batch=4, max_par_time=2, device="cpu")
    rng = np.random.RandomState(2)
    good = [server.submit(prog, rng.uniform(-1, 1, (20, 140)), steps=2)
            for _ in range(2)]
    bad = [server.submit(prog, rng.uniform(-1, 1, (24, 130)), steps=2)]

    orig = stencil_serve.wait_ready

    def deferred_boom(out, done):
        if tuple(out.shape) == (1, 24, 130):
            raise RuntimeError("deferred execution failure")
        return orig(out, done)

    monkeypatch.setattr(stencil_serve, "wait_ready", deferred_boom)
    results = server.flush()
    assert set(results) == set(good)
    assert set(server.failed) == set(bad)
    assert "deferred execution failure" in server.failed[bad[0]]
    assert len(server.recorder.samples("serve.request_latency_s")) == 2


@pytest.mark.parametrize("where", ["dispatch", "wait"])
def test_device_fault_is_raised_not_isolated(monkeypatch, where):
    """A CUDA error leaves the context unusable for every group, so the
    flush raises it instead of serving the other groups as if sound."""
    prog = repro_torch.StencilProgram(ndim=2, radius=1)
    server = StencilServer(max_batch=4, max_par_time=2, device="cpu")
    server.submit(prog, np.zeros((20, 140)), steps=2)
    fault = RuntimeError("padded_superstep_launch: CUDA error 700 (an "
                         "illegal memory access was encountered)")

    def boom(*args, **kwargs):
        raise fault

    if where == "dispatch":
        monkeypatch.setattr(executor.CompiledStencil, "run", boom)
    else:
        monkeypatch.setattr(stencil_serve, "wait_ready", boom)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        server.flush()
    assert server.failed == {}


def test_server_validates_requests():
    prog = repro_torch.StencilProgram(ndim=2, radius=1)
    server = StencilServer(max_batch=2, device="cpu")
    with pytest.raises(ValueError):
        server.submit(prog, np.zeros((4, 4, 4)), steps=1)
    with pytest.raises(ValueError):
        server.submit(prog, np.zeros((16, 128)), steps=-1)
    with pytest.raises(TypeError):
        server.submit("star", np.zeros((16, 128)), steps=1)
    with pytest.raises(ValueError):
        StencilServer(max_batch=0, device="cpu")
    with pytest.raises(ValueError):
        StencilServer(mesh_devices=0, device="cpu")
    rid = server.submit(prog, np.zeros((16, 128), dtype=np.float64), 1)
    (req,) = server._pending
    assert req.rid == rid and req.grid.dtype == torch.float32
    assert req.grid.device == torch.device("cpu") and req.t_submit > 0


def test_mesh_request_is_rp110(monkeypatch):
    """Too few mesh devices visible (the variable unset: one CPU device)
    is RP110 at construction, its hint naming the variable; with it set
    the mesh server is built."""
    monkeypatch.delenv("REPRO_TORCH_FORCE_DEVICE_COUNT", raising=False)
    with pytest.raises(DiagnosticError, match="RP110") as info:
        StencilServer(mesh_devices=2, device="cpu")
    assert "REPRO_TORCH_FORCE_DEVICE_COUNT=2" in info.value.diagnostics[0].hint
    one = StencilServer(mesh_devices=1, device="cpu")
    assert one.mesh_devices is None and one.mesh_fallbacks == {}
    monkeypatch.setenv("REPRO_TORCH_FORCE_DEVICE_COUNT", "2")
    two = StencilServer(mesh_devices=2, device="cpu")
    assert two.mesh_devices == 2 and two.mesh_fallbacks == {}


def test_default_device_without_a_gpu_is_rp110(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DiagnosticError, match="RP110"):
        StencilServer(max_batch=2)


def test_cli_on_the_cpu(capsys, monkeypatch):
    stencil_serve.main(["--device", "cpu", "--requests", "5", "--grid",
                        "20,140", "--radius", "1", "--steps", "3",
                        "--max-batch", "4"])
    out = capsys.readouterr().out
    assert "5 requests -> 2 batches (4 batched) on cpu" in out
    assert "p50=" in out and "rid=0 out_shape=(20, 140)" in out
    monkeypatch.delenv("REPRO_TORCH_FORCE_DEVICE_COUNT", raising=False)
    with pytest.raises(DiagnosticError, match="RP110"):
        stencil_serve.main(["--device", "cpu", "--mesh-devices", "2"])


def test_cli_serves_on_a_cpu_mesh(capsys, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_FORCE_DEVICE_COUNT", "4")
    stencil_serve.main(["--device", "cpu", "--requests", "3", "--grid",
                        "32,128", "--radius", "1", "--steps", "3",
                        "--max-batch", "2", "--mesh-devices", "4"])
    out = capsys.readouterr().out
    assert "3 requests -> 2 batches (2 batched) on cpu" in out
    assert "rid=0 out_shape=(32, 128)" in out
