"""The public names the port added last, on the CPU against the JAX
package on the same inputs (made from a seed with numpy).

* the oracles of ``kernels/ref``: the float64 numpy ones bit for bit over
  2D/3D x clamp/periodic/constant x star/box, ``program_nsteps_unrolled``
  and ``core/codegen.multi_step_interior`` at the repo's ULP;
* ``kernels/common.trace_count``/``reset_trace_counts``: the warm-run
  assertions of ``tests/test_executor.py`` on the port, and a reset that
  clears no cache;
* ``tuning.measure_candidates``: those of ``tests/test_tuning.py``;
* the paper's data (Tables II, IV, V) and the roofline-ratio checks of
  ``tests/test_perf_model.py``, on the port's ``perf_model`` and ``hw``;
* ``launch/dryrun.HBM_LIMIT`` and the class members the port lacked
  (``coeffs_from_shells``, ``ProgramCoeffs.astype``, ``PlanCache.get``/
  ``put``, ``StencilWorkload.compile``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.analysis import hw as ref_hw
from repro.core import codegen as ref_codegen
from repro.core import perf_model as ref_pm
from repro.kernels import ref as ref_ref
from repro.tuning import cache as ref_cache

import repro_torch
from repro_torch import convert, tuning
from repro_torch.analysis import hw
from repro_torch.analysis.hw import H100_SXM, PAPER_DEVICES
from repro_torch.backends import register_backend
from repro_torch.configs import stencil2d
from repro_torch.core import codegen
from repro_torch.core import perf_model as pm
from repro_torch.core.blocking import BlockPlan
from repro_torch.kernels import build, common, cuda
from repro_torch.kernels import ref
from repro_torch.kernels import streamed
from repro_torch.launch import dryrun
from repro_torch.tuning import cache as tcache
from repro_torch.tuning import space as tspace

ULP = dict(atol=1e-6, rtol=1e-5)
TOL = 5e-4
GRIDS = {2: (19, 37), 3: (7, 9, 21)}


def _programs(ndim, boundary, shape, radius=2):
    kw = dict(ndim=ndim, radius=radius, shape=shape, boundary=boundary)
    if boundary == "constant":
        kw["boundary_value"] = 0.25
    return repro.StencilProgram(**kw), repro_torch.StencilProgram(**kw)


def _grid(shape, seed=0, batch=()):
    return np.random.RandomState(seed).uniform(
        -1, 1, batch + shape).astype(np.float32)


CASES = [(nd, b, s) for nd in (2, 3)
         for b in ("clamp", "periodic", "constant") for s in ("star", "box")]


# ---- the oracles ------------------------------------------------------------

def test_ref_exports_the_references_nine_names_in_order():
    assert ref.__all__ == ref_ref.__all__
    assert len(ref.__all__) == 9
    assert all(callable(getattr(ref, n)) for n in ref.__all__)


@pytest.mark.parametrize("ndim,boundary,shape", CASES)
def test_numpy_oracle_is_the_references_bit_for_bit(ndim, boundary, shape):
    rp, tp = _programs(ndim, boundary, shape)
    rc, tc = rp.default_coeffs(seed=3), tp.default_coeffs(seed=3)
    g = _grid(GRIDS[ndim], seed=ndim)
    want = ref_ref.numpy_program_step(rp, rc, g)
    for grid in (g, torch.from_numpy(g)):        # an array or a tensor
        got = ref.numpy_program_step(tp, tc, grid)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    got = ref.numpy_program_nsteps(tp, tc, torch.from_numpy(g), 3)
    np.testing.assert_array_equal(got, ref_ref.numpy_program_nsteps(
        rp, rc, g, 3))
    # and the torch oracle agrees with it
    np.testing.assert_allclose(
        ref.program_nsteps(tp, tc, torch.from_numpy(g), 3).numpy(), got,
        atol=TOL)


def test_numpy_oracle_takes_legacy_specs_and_16_bit_tensors():
    from repro.core.spec import StencilSpec as RefSpec
    from repro_torch.core.spec import StencilSpec
    g = _grid(GRIDS[2], seed=5)
    got = ref.numpy_program_nsteps(StencilSpec(2, 2),
                                   StencilSpec(2, 2).default_coeffs(), g, 2)
    np.testing.assert_array_equal(got, ref_ref.numpy_program_nsteps(
        RefSpec(2, 2), RefSpec(2, 2).default_coeffs(), g, 2))
    _, tp = _programs(2, "clamp", "star")
    half = torch.from_numpy(g).to(torch.bfloat16)
    np.testing.assert_array_equal(
        ref.numpy_program_step(tp, tp.default_coeffs(), half),
        ref.numpy_program_step(tp, tp.default_coeffs(),
                               half.to(torch.float64).numpy()))


@pytest.mark.parametrize("ndim,boundary,shape",
                         [(2, "clamp", "star"), (2, "periodic", "box"),
                          (3, "constant", "star"), (3, "clamp", "box")])
def test_program_nsteps_unrolled_matches_the_reference(ndim, boundary,
                                                       shape):
    rp, tp = _programs(ndim, boundary, shape)
    rc, tc = rp.default_coeffs(seed=1), tp.default_coeffs(seed=1)
    g = _grid(GRIDS[ndim], seed=11, batch=(2,))
    want = np.stack([np.asarray(ref_ref.program_nsteps_unrolled(
        rp, rc, jnp.asarray(x), 4)) for x in g])
    got = ref.program_nsteps_unrolled(tp, tc, torch.from_numpy(g), 4)
    np.testing.assert_allclose(got.numpy(), want, **ULP)


@pytest.mark.parametrize("ndim,shape,steps", [(2, "star", 1), (2, "box", 3),
                                              (3, "star", 2),
                                              (3, "diamond", 2)])
def test_multi_step_interior_matches_the_reference(ndim, shape, steps):
    rp, tp = _programs(ndim, "clamp", shape)
    rc, tc = rp.default_coeffs(seed=2), tp.default_coeffs(seed=2)
    h = steps * tp.halo_radius
    block = tuple(n + 2 * h for n in GRIDS[ndim])
    a = _grid(block, seed=7)
    want = ref_codegen.multi_step_interior(rp, rc, jnp.asarray(a), steps)
    got = codegen.multi_step_interior(tp, tc, torch.from_numpy(a), steps)
    assert tuple(got.shape) == GRIDS[ndim] == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ULP)
    # the shrinking region is the full-grid step's interior
    full = torch.from_numpy(a)
    for _ in range(steps):
        full = ref.program_step(tp, tc, full)
    inner = tuple(slice(h, h + n) for n in GRIDS[ndim])
    np.testing.assert_allclose(got.numpy(), full[inner].numpy(), **ULP)


def test_multi_step_interior_takes_the_legacy_pair_and_refuses_a_thin_block():
    from repro_torch.core.spec import StencilSpec
    spec = StencilSpec(2, 1)
    a = torch.from_numpy(_grid((10, 12), seed=4))
    prog = spec.to_program()
    got = codegen.multi_step_interior(spec, spec.default_coeffs(), a, 2)
    want = codegen.multi_step_interior(
        prog, prog.coeffs_from_legacy(spec.default_coeffs()), a, 2)
    assert torch.equal(got, want) and got.shape == (6, 8)
    with pytest.raises(ValueError, match="too small"):
        codegen.multi_step_interior(spec, spec.default_coeffs(), a, 5)


# ---- trace counters ---------------------------------------------------------

#: the counters that answer the reference's ``trace_count("run_call")``
#: (``kernels/common.trace_count``), and the builds and loads
RUN_WORK = ("queued_geometry", "streamed_geometry", "wrap_geometry",
            "library_builds", "library_loads")


def _run_work() -> int:
    return sum(common.trace_count(n) for n in RUN_WORK)


def test_oracle_dispatch_resolves_no_geometry():
    """``tests/test_executor.py``'s oracle dispatch: the reference builds no
    Pallas executable, the port resolves no launch geometry and launches
    nothing."""
    prog = repro_torch.StencilProgram(ndim=2, radius=2)
    plan = BlockPlan(spec=prog, block_shape=(16, 128), par_time=2)
    g = ref.random_grid(prog, (23, 37), seed=7)
    common.reset_trace_counts()
    launches = dict(cuda.launches())
    cs = repro_torch.stencil(prog).compile(
        (23, 37), steps=5, plan=plan, backend="torch-reference",
        device="cpu")
    out = cs.run(g)
    assert _run_work() == 0 and cuda.launches() == launches
    assert common.trace_count("plan_resolutions") == 1
    np.testing.assert_allclose(out.numpy(), ref.numpy_program_nsteps(
        prog, cs.coeffs, g, 5), atol=TOL)


def test_repeated_runs_and_remainders_resolve_nothing_new():
    """``tests/test_executor.py``: repeated runs and step counts of the same
    remainder share one executable there; here no run resolves anything
    (the plain versions have no geometry), and a new remainder neither."""
    prog = repro_torch.StencilProgram(ndim=2, radius=1)
    plan = BlockPlan(spec=prog, block_shape=(8, 128), par_time=3)
    g = ref.random_grid(prog, (22, 141), seed=2)
    cs = repro_torch.stencil(prog).compile((22, 141), steps=3 * 3 + 2,
                                           plan=plan, device="cpu")
    common.reset_trace_counts()
    assert common.trace_counts() == dict.fromkeys(common.trace_counts(), 0)
    cs.run(g)
    cs.run(g)
    cs.run(g, steps=5 * 3 + 2)
    cs.run(g, steps=2)
    assert _run_work() == 0
    cs.run(g, steps=6)
    assert _run_work() == 0
    assert common.trace_count("plan_resolutions") == 0
    assert common.trace_count("no such counter") == 0


def test_batch_rank_adds_no_resolution_to_warm_runs():
    prog = repro_torch.StencilProgram(ndim=2, radius=1)
    plan = BlockPlan(spec=prog, block_shape=(8, 128), par_time=2)
    G = (19, 143)
    g = ref.random_grid(prog, G, seed=3)
    gb = torch.stack([g, g, g])
    sten = repro_torch.stencil(prog)
    cs = sten.compile(G, steps=4, plan=plan, device="cpu")
    cs_b = sten.compile(G, steps=4, plan=plan, batch=3, device="cpu")
    common.reset_trace_counts()
    for _ in range(2):
        cs.run(g)
        cs_b.run(gb)
    assert _run_work() == 0 and common.trace_count("plan_resolutions") == 0
    sten.compile(G, steps=4, plan=plan, device="cpu")
    assert common.trace_count("plan_resolutions") == 1


def test_reset_keeps_a_baseline_and_clears_no_cache(monkeypatch):
    """A launch geometry resolved once counts once; a reset zeroes the
    count but keeps the cached geometry (a warm call adds nothing after
    it), and a build counted after a reset counts from 0."""
    prog = repro_torch.StencilProgram(ndim=2, radius=3, shape="box")
    plan = BlockPlan(spec=prog, block_shape=(16, 128), par_time=2)
    lay = common.ring_schedule(prog, plan, (29, 203), 2).layout
    common.reset_trace_counts()

    def geometry():
        return streamed.carry_geometry(prog, 2, lay, batch=5,
                                       smem_limit=H100_SXM.smem_optin)

    first = geometry()
    assert common.trace_count("streamed_geometry") == 1
    assert geometry() is first
    assert common.trace_count("streamed_geometry") == 1
    size = streamed.carry_geometry.cache_info().currsize
    common.reset_trace_counts()
    assert common.trace_count("streamed_geometry") == 0
    assert streamed.carry_geometry.cache_info().currsize == size
    assert geometry() is first
    assert common.trace_count("streamed_geometry") == 0
    monkeypatch.setitem(build.COUNTS, "builds", build.COUNTS["builds"] + 1)
    assert common.trace_count("library_builds") == 1
    common.reset_trace_counts()
    assert common.trace_count("library_builds") == 0
    before = common.trace_counts()
    geometry()
    assert common.trace_delta(before) == {}


# ---- measure_candidates -----------------------------------------------------

try:
    @register_backend("surface-test-fail", version=1)
    def _fail(program, plan, coeffs):
        raise RuntimeError("deliberate compile failure")
except ValueError:
    pass  # already registered in this process


def _space(prog, backends, bsizes, max_par_time=1, grid=None):
    return tspace.enumerate_space(prog, H100_SXM, backends=backends,
                                  bsizes=bsizes, max_par_time=max_par_time,
                                  grid_shape=grid)


def test_measure_candidates_keeps_a_failing_candidate():
    """``tests/test_tuning.py``: one measurement per candidate, in order; a
    candidate that fails to compile is kept with ``ok=False`` and its
    error; ``best_measurement`` picks the one that ran."""
    prog = repro_torch.StencilProgram(ndim=2, radius=1)
    cands = _space(prog, ("surface-test-fail", "torch-reference"),
                   [(16, 128)])
    assert {c.backend for c in cands} == {"surface-test-fail",
                                         "torch-reference"}
    ms = tuning.measure_candidates(prog, cands, (16, 128), reps=1,
                                   device="cpu")
    assert [m.candidate for m in ms] == cands
    by_backend = {m.candidate.backend: m for m in ms}
    bad = by_backend["surface-test-fail"]
    assert not bad.ok and "deliberate compile failure" in bad.error
    assert bad.stage == "lower"
    good = by_backend["torch-reference"]
    assert good.ok and good.achieved_gcells > 0 and good.device == "cpu"
    assert tuning.best_measurement(ms) is good


def test_measure_candidates_picks_the_fastest_that_ran():
    prog = repro_torch.StencilProgram(ndim=2, radius=4)
    grid = (32, 256)
    bsizes = [(16, 256), (32, 128), (32, 256)]
    space = _space(prog, ("cuda",), bsizes, max_par_time=3, grid=grid)
    assert len(space) >= 4
    sweep = tuning.measure_candidates(prog, space, grid, reps=1,
                                      device="cpu")
    assert len(sweep) == len(space) and all(m.ok for m in sweep)
    assert [m.candidate for m in sweep] == space
    # one step count for every candidate: two of the deepest supersteps
    assert {m.steps for m in sweep} == {2 * max(c.par_time for c in space)}
    best = tuning.best_measurement(sweep)
    assert best.achieved_gcells == max(m.achieved_gcells for m in sweep)
    assert tuning.best_measurement([dataclasses.replace(m, ok=False)
                                    for m in sweep]) is None


def test_measure_candidates_reports_table3_style_metrics():
    prog = repro_torch.StencilProgram(ndim=2, radius=1)
    cands = _space(prog, ("torch-reference",), [(32, 256)], grid=(32, 256))
    (m,) = tuning.measure_candidates(prog, cands, (32, 256), reps=1,
                                     device="cpu")
    assert m.ok
    assert m.achieved_gbps == pytest.approx(
        m.achieved_gcells * prog.bytes_per_cell)
    assert m.achieved_gflops == pytest.approx(
        m.achieved_gcells * prog.flops_per_cell)
    assert m.model_accuracy == pytest.approx(m.predicted_ms / m.measured_ms)
    assert m.ranked == tuning.predict(prog, cands[0], H100_SXM, (32, 256))


def test_measure_candidates_is_exported_and_runs_on_the_card_by_default():
    assert "measure_candidates" in tuning.__all__
    prog = repro_torch.StencilProgram(ndim=2, radius=1)
    cands = _space(prog, ("cuda",), [(16, 128)])
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default would measure there")
    # no fall back to the CPU: without a card the call raises
    with pytest.raises((AssertionError, RuntimeError)):
        tuning.measure_candidates(prog, cands, (16, 128), reps=1)


# ---- the paper's data -------------------------------------------------------

def test_paper_tables_are_the_references():
    assert pm.PAPER_TABLE4_2D == ref_pm.PAPER_TABLE4_2D
    assert pm.PAPER_TABLE5_3D == ref_pm.PAPER_TABLE5_3D
    assert {k: dataclasses.astuple(v) for k, v in PAPER_DEVICES.items()} \
        == {k: dataclasses.astuple(v)
            for k, v in ref_hw.PAPER_DEVICES.items()}
    assert hw.ARRIA10_DSPS == ref_hw.ARRIA10_DSPS == pm.ARRIA10_DSPS
    assert hw.ARRIA10_MEM_CTRL_MHZ == ref_hw.ARRIA10_MEM_CTRL_MHZ
    assert [dataclasses.astuple(r) for r in pm.PAPER_TABLE3] \
        == [dataclasses.astuple(r) for r in ref_pm.PAPER_TABLE3]


def test_roofline_ratio_reproduction():
    """Paper Tables IV/V roofline-ratio arithmetic for the FPGA rows
    (``tests/test_perf_model.py``)."""
    bw = PAPER_DEVICES["arria10"].mem_bw_gbps
    for rad, (gflops, gcells, _, ratio) in pm.PAPER_TABLE4_2D[
            "arria10"].items():
        eff_gbps = gcells * pm.bytes_per_cell()
        assert abs(pm.roofline_ratio(eff_gbps, bw) - ratio) < 0.03, rad
    for rad, (gflops, gcells, _, ratio) in pm.PAPER_TABLE5_3D[
            "arria10"].items():
        eff_gbps = gcells * pm.bytes_per_cell()
        assert abs(pm.roofline_ratio(eff_gbps, bw) - ratio) < 0.03, rad


def test_temporal_blocking_needed_above_ratio_one():
    """Paper claim: a roofline ratio above 1 needs temporal blocking; the
    CPU and GPU rows are all below 1, the FPGA's above
    (``tests/test_perf_model.py``)."""
    for dev, rows in {**pm.PAPER_TABLE4_2D, **pm.PAPER_TABLE5_3D}.items():
        for rad, (_, _, _, ratio) in rows.items():
            if dev == "arria10":
                assert ratio > 1.0
            else:
                assert ratio < 1.0


def test_paper_gflops_follow_from_gcells():
    """Each row's GFLOP/s is its GCell/s times Table I's FLOP per cell,
    on the port's arithmetic."""
    for ndim, table in ((2, pm.PAPER_TABLE4_2D), (3, pm.PAPER_TABLE5_3D)):
        for rows in table.values():
            for rad, (gflops, gcells, _, _) in rows.items():
                assert pm.gcells_to_gflops(gcells, ndim, rad) \
                    == pytest.approx(gflops, rel=5e-3)


def test_hbm_limit_is_one_h100():
    assert dryrun.HBM_LIMIT == H100_SXM.hbm_bytes == 80_000_000_000


# ---- class members ----------------------------------------------------------

def test_coeffs_from_shells_and_astype_match_the_reference():
    rp = repro.StencilProgram(ndim=3, radius=4, coeff_sharing="distance")
    tp = repro_torch.StencilProgram(ndim=3, radius=4,
                                    coeff_sharing="distance")
    shells = np.random.RandomState(9).uniform(0.2, 1, 4).astype(np.float32)
    want = rp.coeffs_from_shells(jnp.float32(0.5), jnp.asarray(shells))
    got = tp.coeffs_from_shells(torch.tensor(np.float32(0.5)),
                                torch.from_numpy(shells))
    np.testing.assert_array_equal(got.taps.numpy(), np.asarray(want.taps))
    assert float(got.center) == float(want.center)
    for name in ("bfloat16", "float16"):
        a, b = got.astype(name), want.astype(getattr(jnp, name))
        assert a.taps.dtype == getattr(torch, name)
        np.testing.assert_array_equal(a.taps.float().numpy(),
                                      np.asarray(b.taps, np.float32))
    assert got.astype(torch.float16).center.dtype == torch.float16


def test_plan_cache_get_and_put_as_the_reference(tmp_path):
    for store in (tcache.PlanCache(str(tmp_path / "port.json")),
                  ref_cache.PlanCache(str(tmp_path / "ref.json"))):
        assert store.get("k") is None
        store.add("k", {"search": 1, "par_time": 1})
        store.add("k", {"search": 2, "par_time": 2})
        assert store.get("k") == {"search": 2, "par_time": 2}
        store.put("k", {"par_time": 3})
        assert store.get("k") == {"par_time": 3}
        assert store.get_all("k") == [{"par_time": 3}] and len(store) == 1


def test_workload_compile_is_the_front_door():
    w = stencil2d.workloads(1)["2d_r1_paper"]
    small = dataclasses.replace(w, grid_shape=(40, 300),
                                block_shape=(16, 128), par_time=2)
    g = torch.from_numpy(_grid((40, 300), seed=8))
    got = small.compile(steps=5, device="cpu").run(g)
    want = repro_torch.stencil(small.spec).compile(
        (40, 300), steps=5, plan=small.plan(), device="cpu").run(g)
    assert torch.equal(got, want)
    cs = small.compile(steps=5, device="cpu", variant="pipelined")
    assert cs.plan == small.plan() and cs.variant == "pipelined"
    # the reference's workload carries across to the same plan
    from repro.configs import stencil2d as ref_stencil2d
    rw = ref_stencil2d.workloads(1)["2d_r1_paper"]
    assert convert.plan_from_fields(**dataclasses.asdict(rw.plan())) \
        == w.plan()
