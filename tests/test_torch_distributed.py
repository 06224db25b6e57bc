"""The port's mesh executor (``repro_torch.core.distributed``) against the
reference's, on the CPU.

The port runs its kernels' plain versions (``device="cpu"``) on mesh
devices that ``REPRO_TORCH_FORCE_DEVICE_COUNT`` lays over the CPU, as the
reference's tests lay theirs with ``XLA_FLAGS=
--xla_force_host_platform_device_count``.  The reference's mesh runs in
a subprocess (its device count is fixed before jax imports), the rest
in process.

* parity matrix: radii 1-4 x 2D/3D x three boundaries at the reference's
  sizes and splits (``tests/dist_scripts/stencil_fused_dist.py``: 8
  devices as (4, 2) and (4, 2, 1), 5 steps at par_time 2): the mesh run
  equals the port's single-device run at 0, the JAX single-device run
  within the reference's sharded tolerance and the float64 oracle;
* the JAX mesh itself (``DistributedStencil`` on 4 fake CPU devices);
* the schedule: ``ring_schedule(decomp=)`` record for record, and
  ``verify_dataflow(decomp=)``'s findings, a broken exchange included;
* caching (one executable per (remainder, batch rank)), batches, the
  pipelined variant, ``superstep``;
* refusals (RP110, RP107) with the reference's codes; the tuner's
  decomposition axis; ``compile(devices=4)`` under ``plan="model"`` and
  ``"auto"``; the serving front's mesh; the ``exchange`` event.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest
import torch

import repro
from repro.core import reference as ref
from repro.core.blocking import BlockPlan as RefPlan
from repro.core.program import StencilProgram as RefProgram
from repro.kernels import common as ref_common
from repro.lint.dataflow import verify_dataflow as ref_verify_dataflow
from repro.lint.verify import verify as ref_verify
from repro.tuning import space as ref_space

import repro_torch
from repro_torch import convert, obs
from repro_torch.core import distributed
from repro_torch.kernels import common
from repro_torch.launch.stencil_serve import StencilServer
from repro_torch.lint.dataflow import verify_dataflow
from repro_torch.lint.diagnostics import DiagnosticError
from repro_torch.lint.verify import verify
from repro_torch.tuning import space

ENV = distributed.ENV_DEVICE_COUNT
#: the reference's mesh tolerance (stencil_fused_dist.py), and the oracle's
SHARDED = dict(atol=1e-6, rtol=1e-4)
TOL = 5e-4
BLOCKS = {2: (16, 128), 3: (8, 16, 128)}
GRIDS = {2: (64, 256), 3: (32, 32, 128)}
DECOMPS = {2: (4, 2), 3: (4, 2, 1)}
STEPS = 5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The grids here are small: one intra-op thread runs this file as
    fast as all of them and leaves the other cores to the test files
    running beside it (some of which time themselves)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def mesh8(monkeypatch):
    monkeypatch.setenv(ENV, "8")


@pytest.fixture
def mesh4(monkeypatch):
    monkeypatch.setenv(ENV, "4")


def _both(ndim, radius, boundary, block=None, par_time=2):
    rp = RefProgram(ndim=ndim, radius=radius, boundary=boundary,
                    boundary_value=0.25)
    rplan = RefPlan(spec=rp, block_shape=block or BLOCKS[ndim],
                    par_time=par_time)
    tp = convert.program_from_fields(**dataclasses.asdict(rp))
    tplan = convert.plan_from_fields(**dataclasses.asdict(rplan))
    return rp, rplan, tp, tplan


def _coeffs(rp, seed):
    rc = rp.default_coeffs(seed=seed)
    return rc, convert.coeffs_from_numpy(rc.center, rc.taps)


# ---- the parity matrix ------------------------------------------------------


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
@pytest.mark.parametrize("boundary", ["clamp", "periodic", "constant"])
def test_mesh_equals_single_device_jax_and_oracle(mesh8, ndim, radius,
                                                  boundary):
    rp, rplan, tp, tplan = _both(ndim, radius, boundary)
    rc, tc = _coeffs(rp, radius)
    G = GRIDS[ndim]
    g = ref.random_grid(rp, G, seed=radius)
    cs = repro_torch.stencil(tp, tc).compile(
        G, steps=STEPS, devices=DECOMPS[ndim], plan=tplan, device="cpu")
    assert cs.decomp == DECOMPS[ndim]
    assert cs.describe() == "mesh " + "x".join(map(str, DECOMPS[ndim]))
    tg = torch.from_numpy(np.array(g))
    got = cs.run(tg)
    one = repro_torch.stencil(tp, tc).compile(
        G, steps=STEPS, plan=tplan, device="cpu").run(tg)
    torch.testing.assert_close(got, one, rtol=0, atol=0)
    want = repro.stencil(rp, coeffs=rc).compile(G, steps=STEPS,
                                                plan=rplan).run(g)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SHARDED)
    oracle = ref.numpy_program_nsteps(rp, rc, g, STEPS)
    np.testing.assert_allclose(got.numpy(), oracle, atol=TOL, rtol=TOL)


# ---- the JAX mesh itself ----------------------------------------------------

_JAX_MESH = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4")
    import warnings
    import numpy as np
    from repro.core import compat, reference as ref
    from repro.core.blocking import BlockPlan
    from repro.core.distributed import Decomposition, DistributedStencil
    from repro.core.program import StencilProgram
    out = sys.argv[1]
    warnings.simplefilter("ignore", DeprecationWarning)
    for name, ndim, radius, boundary, shards, grid, block in (
            ("2d", 2, 2, "clamp", (2, 2), (64, 256), (16, 128)),
            ("3d", 3, 1, "periodic", (2, 2, 1), (32, 32, 128),
             (8, 16, 128))):
        prog = StencilProgram(ndim=ndim, radius=radius, boundary=boundary,
                              boundary_value=0.25)
        coeffs = prog.default_coeffs(seed=7)
        plan = BlockPlan(spec=prog, block_shape=block, par_time=2)
        names = tuple(f"d{i}" for i in range(ndim))
        mesh = compat.make_mesh(shards, names)
        decomp = Decomposition(tuple((names[i],) if shards[i] > 1 else ()
                                     for i in range(ndim)))
        ds = DistributedStencil(prog, coeffs, plan, mesh, decomp, grid)
        g = ref.random_grid(prog, grid, seed=11)
        np.save(os.path.join(out, name + "_in.npy"), np.asarray(g))
        got = ds.run(g, 5)
        np.save(os.path.join(out, name + "_out.npy"), np.asarray(got))
''')


def test_mesh_equals_the_jax_mesh(tmp_path, mesh4):
    """2D clamp r2 on (2, 2), 3D periodic r1 on (2, 2, 1), 5 steps: the
    reference's ``DistributedStencil`` on 4 fake CPU devices (a
    subprocess) and the port's mesh on 4 CPU mesh devices."""
    script = tmp_path / "jax_mesh.py"
    script.write_text(_JAX_MESH)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, str(script), str(tmp_path)], check=True,
                   env=env, timeout=300)
    for name, ndim, radius, boundary, shards in (
            ("2d", 2, 2, "clamp", (2, 2)),
            ("3d", 3, 1, "periodic", (2, 2, 1))):
        rp, _, tp, tplan = _both(ndim, radius, boundary)
        _, tc = _coeffs(rp, 7)
        g = torch.from_numpy(np.load(tmp_path / f"{name}_in.npy"))
        want = np.load(tmp_path / f"{name}_out.npy")
        cs = repro_torch.stencil(tp, tc).compile(
            tuple(g.shape), steps=5, devices=shards, plan=tplan,
            device="cpu")
        np.testing.assert_allclose(cs.run(g).numpy(), want, **SHARDED)


# ---- the schedule and its proof ---------------------------------------------


SCHEDULES = [(2, "clamp", (4, 2), "plain"), (2, "periodic", (2, 1), "plain"),
             (2, "periodic", (2, 2), "pipelined"),
             (3, "periodic", (4, 2, 1), "plain"),
             (3, "constant", (1, 2, 1), "pipelined")]


@pytest.mark.parametrize("ndim,boundary,shards,variant", SCHEDULES)
@pytest.mark.parametrize("steps", [4, 5])
def test_ring_schedule_with_decomp_matches_reference(ndim, boundary, shards,
                                                     variant, steps):
    rp, rplan, tp, tplan = _both(ndim, 2, boundary)
    G = GRIDS[ndim]
    want = ref_common.ring_schedule(rp, rplan, G, steps, variant=variant,
                                    decomp=shards)
    got = common.ring_schedule(tp, tplan, G, steps, variant=variant,
                               decomp=shards)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.sharded_axes == tuple(d for d in range(ndim)
                                     if shards[d] > 1)
    mesh_decomp = space.MeshDecomposition(shards)
    assert verify_dataflow(tp, tplan, G, steps=steps, variant=variant,
                           decomp=mesh_decomp) == []
    assert ref_verify_dataflow(rp, rplan, G, steps=steps, variant=variant,
                               decomp=shards) == []


def _shallow_exchange(exchange_copies):
    """A seeded fault: every exchange strip one cell shallower."""
    def patched(axis, h, H, nloc):
        lo, hi = exchange_copies(axis, h, H, nloc)
        return (dataclasses.replace(lo, src=(lo.src[0] + 1, lo.src[1]),
                                    dst=(lo.dst[0] + 1, lo.dst[1])),
                dataclasses.replace(hi, src=(hi.src[0], hi.src[1] - 1),
                                    dst=(hi.dst[0], hi.dst[1] - 1)))
    return patched


@pytest.mark.parametrize("boundary", ["clamp", "periodic"])
def test_proof_finds_a_broken_exchange_like_the_reference(monkeypatch,
                                                          boundary):
    rp, rplan, tp, tplan = _both(2, 2, boundary)
    G, shards = GRIDS[2], (4, 2)
    monkeypatch.setattr(common, "exchange_copies",
                        _shallow_exchange(common.exchange_copies))
    monkeypatch.setattr(ref_common, "exchange_copies",
                        _shallow_exchange(ref_common.exchange_copies))
    got = verify_dataflow(tp, tplan, G, steps=STEPS, decomp=shards)
    want = ref_verify_dataflow(rp, rplan, G, steps=STEPS, decomp=shards)
    assert [d.code for d in got] == [d.code for d in want]
    assert {d.code for d in got} == {"RP401"}
    assert [d.message for d in got] == [d.message.replace(
        "the cell was never initialized by pad, prior write, ring copy, "
        "or boundary_fixup at this time", "no copy into the carry, prior "
        "write, ring copy or boundary_fixup initialised the cell at this "
        "time") for d in want]


# ---- executables, batches, variants, superstep ------------------------------


def _dist(tp, tplan, G, shards, variant=None, coeffs=None):
    mesh = distributed.make_mesh(shards, [torch.device("cpu")] * 8)
    decomp = distributed.Decomposition(tuple(
        (mesh.axis_names[d],) if s > 1 else ()
        for d, s in enumerate(shards)))
    return distributed.DistributedStencil(tp, coeffs, tplan, mesh, decomp,
                                          G, variant=variant, _warn=False)


def test_one_executable_per_remainder_and_batch_rank():
    _, _, tp, tplan = _both(2, 1, "clamp")
    G = (128, 512)
    ds = _dist(tp, tplan, G, (4, 2))
    g = torch.rand(G)
    for steps in (5, 7, 9):                 # remainder 1 each
        ds.run(g, steps)
    assert set(ds._exes) == {(1, 0)}
    ds.run(g, 4)
    ds.run(torch.rand((2,) + G), 3)
    assert set(ds._exes) == {(1, 0), (0, 0), (1, 1)}
    exe = ds.run_fn(1, 0)
    assert ds.run_fn(1, 0) is exe


@pytest.mark.parametrize("boundary", ["clamp", "periodic", "constant"])
def test_batched_pipelined_and_superstep_on_the_mesh(boundary):
    """A batch of 2 on (4, 2): the pipelined variant equals the plain one,
    each grid of the batch its own unbatched run, and ``superstep`` the
    single device's pre-padded superstep, all at 0."""
    _, _, tp, tplan = _both(2, 2, boundary)
    G = GRIDS[2]
    gen = torch.Generator().manual_seed(3)
    g = torch.rand((2,) + G, generator=gen) * 2 - 1
    plain = _dist(tp, tplan, G, (4, 2))
    piped = _dist(tp, tplan, G, (4, 2), variant="pipelined")
    assert piped.variant == "pipelined"
    got = plain.run(g, STEPS)
    torch.testing.assert_close(piped.run(g, STEPS), got, rtol=0, atol=0)
    torch.testing.assert_close(got[1], plain.run(g[1], STEPS), rtol=0,
                               atol=0)
    c = plain.coeffs
    torch.testing.assert_close(
        plain.superstep(g), common.pad_superstep(g, c.center, c.taps,
                                                 program=tp, plan=tplan),
        rtol=0, atol=0)
    assert torch.equal(plain.run(g, 0), g)


def test_direct_construction_warns_and_refuses_like_the_reference():
    _, _, tp, tplan = _both(2, 1, "clamp")
    mesh = distributed.make_mesh((2, 1), [torch.device("cpu")] * 2)
    decomp = distributed.Decomposition((("d0",), ()))
    with pytest.warns(DeprecationWarning, match="compile"):
        distributed.DistributedStencil(tp, None, tplan, mesh, decomp,
                                       GRIDS[2])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for kw, what in ((dict(variant="temporal"), "RP110"),
                         (dict(backend="torch-reference"), "RP110")):
            with pytest.raises(ValueError, match=what):
                distributed.DistributedStencil(tp, None, tplan, mesh,
                                               decomp, GRIDS[2], **kw)
        with pytest.raises(ValueError, match="not divisible"):
            distributed.DistributedStencil(tp, None, tplan, mesh, decomp,
                                           (63, 256))


def test_visible_devices(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    assert distributed.visible_devices("cpu") == (torch.device("cpu"),)
    monkeypatch.setenv(ENV, "3")
    assert distributed.visible_devices("cpu") == (torch.device("cpu"),) * 3
    monkeypatch.setenv(ENV, "zero")
    with pytest.raises(ValueError, match=ENV):
        distributed.visible_devices("cpu")


# ---- refusals ---------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(variant="temporal"),
                                dict(backend="torch-reference")])
def test_mesh_refuses_the_temporal_chunk_and_the_oracle(mesh8, kw):
    rp, rplan, tp, tplan = _both(2, 1, "clamp")
    with pytest.raises(DiagnosticError) as info:
        repro_torch.stencil(tp).compile(GRIDS[2], steps=5, devices=(4, 2),
                                        plan=tplan, device="cpu", **kw)
    assert [d.code for d in info.value.diagnostics] == ["RP110"]
    ref_kw = dict(kw)
    if "backend" in ref_kw:
        ref_kw["backend"] = "xla-reference"
    with pytest.raises(repro.lint.diagnostics.DiagnosticError) as rinfo:
        repro.stencil(rp).compile(GRIDS[2], steps=5, devices=(4, 2),
                                  plan=rplan, **ref_kw)
    assert [d.code for d in rinfo.value.diagnostics] == ["RP110"]


def test_too_few_devices_is_rp110_naming_the_variable(monkeypatch):
    _, _, tp, tplan = _both(2, 4, "clamp")
    monkeypatch.delenv(ENV, raising=False)
    for devices in ((2, 2), 4):
        with pytest.raises(DiagnosticError) as info:
            repro_torch.stencil(tp).compile(GRIDS[2], steps=5,
                                            devices=devices, plan=tplan,
                                            device="cpu")
        (d,) = info.value.diagnostics
        assert d.code == "RP110" and f"{ENV}=4" in d.hint
    monkeypatch.setenv(ENV, "4")
    cs = repro_torch.stencil(tp).compile(GRIDS[2], steps=5, devices=(2, 2),
                                         plan=tplan, device="cpu")
    g = torch.rand(GRIDS[2])
    one = repro_torch.stencil(tp).compile(GRIDS[2], steps=5, plan=tplan,
                                          device="cpu")
    torch.testing.assert_close(cs.run(g), one.run(g), rtol=0, atol=0)


@pytest.mark.parametrize("shards,block", [((3, 1), (16, 128)),
                                          ((4, 2), (32, 128)),
                                          ((1, 8), (16, 32)),
                                          ((3, 2, 1), None)])
def test_rp107_like_the_reference(mesh8, shards, block):
    """Splits that do not divide the grid, a block that does not tile the
    shard, a halo deeper than the shard, a split of the wrong rank: RP107
    from both verifiers, with the reference's message; the front door
    refuses the pinned split with it."""
    rp, rplan, tp, tplan = _both(2, 4, "clamp", block=block or (16, 128),
                                 par_time=2 if shards != (1, 8) else 9)
    G = GRIDS[2]
    got = [d for d in verify(tp, tplan, G, None, decomp=shards)
           if d.is_error]
    want = [d for d in ref_verify(rp, rplan, G, decomp=shards)
            if d.severity.value == "error"]
    assert [d.code for d in got] == [d.code for d in want] and got
    assert {d.code for d in got} == {"RP107"}
    assert [d.message for d in got] == [d.message for d in want]
    if len(shards) == 2 and np.prod(shards) <= 8:
        with pytest.raises(DiagnosticError, match="RP107"):
            repro_torch.stencil(tp).compile(G, steps=5, devices=shards,
                                            plan=tplan, device="cpu")


def test_no_split_fits_a_pinned_plan_is_rp107(mesh4):
    _, _, tp, _ = _both(2, 1, "clamp")
    plan = repro_torch.BlockPlan(spec=tp, block_shape=(33, 127), par_time=1)
    with pytest.raises(DiagnosticError) as info:
        repro_torch.stencil(tp).compile((33, 127), steps=2, devices=4,
                                        plan=plan, device="cpu")
    assert [d.code for d in info.value.diagnostics] == ["RP107"]


# ---- the tuner's decomposition axis and the planned mesh --------------------

PAPER = {2: (16384, 16384), 3: (512, 1024, 704)}


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_decompositions_and_violations_equal_the_reference(ndim, n):
    G = PAPER[ndim]
    got = {d.axis_shards for d in space.enumerate_decompositions(ndim, n, G)}
    want = {d.axis_shards
            for d in ref_space.enumerate_decompositions(ndim, n, G)}
    assert got == want
    assert {d.axis_shards for d in space.enumerate_decompositions(ndim, n)} \
        == {d.axis_shards for d in ref_space.enumerate_decompositions(ndim,
                                                                      n)}
    rp = RefProgram(ndim=ndim, radius=4)
    tp = convert.program_from_fields(**dataclasses.asdict(rp))
    blocks = ((1024, 1024), (3000, 4096)) if ndim == 2 else \
        ((32, 64, 704), (64, 100, 704))
    for block in blocks:
        for pt in (1, 2, 40):
            rplan = RefPlan(spec=rp, block_shape=block, par_time=pt)
            tplan = convert.plan_from_fields(**dataclasses.asdict(rplan))
            for shards in ref_space._factorizations(n, ndim):
                assert space.shard_violations(
                    tplan, space.MeshDecomposition(shards), G) == \
                    ref_space.shard_violations(
                        rplan, ref_space.MeshDecomposition(shards), G)


def test_mesh_space_prunes_per_shard():
    tp = repro_torch.StencilProgram(ndim=2, radius=4)
    G = PAPER[2]
    cands = space.enumerate_space(tp, grid_shape=G, n_devices=4,
                                  max_par_time=4)
    assert cands and {c.decomp.axis_shards for c in cands} == {
        (1, 4), (2, 2), (4, 1)}
    assert all(space.fits_shard(c.plan, c.decomp, G) for c in cands)
    assert "temporal" not in {c.variant for c in cands}
    with pytest.raises(ValueError, match="grid_shape"):
        space.enumerate_space(tp, n_devices=4)


@pytest.mark.parametrize("plan", ["model", "auto"])
@pytest.mark.parametrize("ndim", [2, 3])
def test_planned_mesh_compile_runs_like_one_device(mesh4, tmp_path, plan,
                                                   ndim):
    _, _, tp, _ = _both(ndim, 2, "clamp")
    G = GRIDS[ndim]
    cs = repro_torch.stencil(tp).compile(
        G, steps=STEPS, devices=4, plan=plan, device="cpu",
        cache_path=str(tmp_path / "plans.json"))
    assert cs.decomp is not None and int(np.prod(cs.decomp)) == 4
    assert space.fits_shard(cs.plan, space.MeshDecomposition(cs.decomp), G)
    g = torch.rand(G)
    one = repro_torch.stencil(tp).compile(G, steps=STEPS, plan=cs.plan,
                                          variant=cs.variant, device="cpu")
    torch.testing.assert_close(cs.run(g), one.run(g), rtol=0, atol=0)
    if plan == "auto":
        again = repro_torch.stencil(tp).compile(
            G, steps=STEPS, devices=4, plan=plan, device="cpu",
            cache_path=str(tmp_path / "plans.json"))
        assert again.from_plan_cache and again.decomp == cs.decomp


def test_mesh_tuning_is_model_only():
    tp = repro_torch.StencilProgram(ndim=2, radius=2)
    from repro_torch.tuning import autotune
    with pytest.raises(ValueError, match="model-only"):
        autotune(tp, grid_shape=GRIDS[2], n_devices=4, device="cpu")
    tuned = autotune(tp, grid_shape=GRIDS[2], decomposition=(2, 2),
                     measure=False, cache=False, device="cpu")
    assert tuned.decomp == (2, 2)


# ---- the serving front and the recorder -------------------------------------


def test_served_mesh_equals_unbatched_runs(mesh4):
    tp = repro_torch.StencilProgram(ndim=2, radius=2, boundary="periodic")
    server = StencilServer(mesh_devices=4, device="cpu", max_batch=2)
    gen = torch.Generator().manual_seed(5)
    grids = [torch.rand(GRIDS[2], generator=gen) for _ in range(3)]
    odd = torch.rand((31, 127), generator=gen)
    rids = [server.submit(tp, g, STEPS) for g in grids]
    rid_odd = server.submit(tp, odd, 3)
    out = server.flush()
    assert server.failed == {}
    assert list(server.mesh_fallbacks) and \
        list(server.mesh_fallbacks)[0][1] == (31, 127)
    assert server.stats.sharded_batches == 2
    mesh = list(server._mesh_compiled.values())
    assert sorted(cs.batch for cs in mesh) == [1, 2]
    assert len({(cs.plan, cs.decomp) for cs in mesh}) == 1
    mesh_cs = mesh[0]
    assert mesh_cs.decomp is not None
    for rid, g in zip(rids, grids):
        one = repro_torch.stencil(tp).compile(
            GRIDS[2], steps=STEPS, plan=mesh_cs.plan,
            variant=mesh_cs.variant, device="cpu").run(g)
        torch.testing.assert_close(out[rid], one, rtol=0, atol=0)
    assert out[rid_odd].shape == (31, 127)


def test_mesh_run_records_its_exchange(mesh4):
    _, _, tp, tplan = _both(2, 2, "constant")
    cs = repro_torch.stencil(tp).compile(GRIDS[2], steps=STEPS,
                                         devices=(2, 2), plan=tplan,
                                         device="cpu")
    with obs.profile() as rec:
        cs.run(torch.rand(GRIDS[2]))
    (ev,) = [e for e in rec.events if e.get("name") == "exchange"]
    assert ev["depth"] == tplan.halo and ev["rem_depth"] == 2
    assert ev["supersteps"] == 2 and ev["rem"] == 1
    assert ev["decomp"] == [2, 2] and ev["boundary"] == "constant"
    (run,) = rec.spans("run")
    assert run["decomp"] == [2, 2] and run["devices"] == 4
