"""The port's planner against the reference: the paper's FPGA model
(``core/perf_model.py``) number for number, the default front door and
``plan="model"`` against the JAX executor's ``plan="model"`` run, the
plans it returns fitting the card, the card's facts as rankings at the
paper shapes, and ROADMAP C1 (RP105 at ``run`` for a step count whose
kernels fit no CTA tile).  All on the CPU: planning is arithmetic."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import repro
from repro.core import perf_model as ref_pm
from repro.core import reference as ref
from repro.core.program import StencilProgram as RefProgram

import repro_torch
from repro_torch import convert
from repro_torch.analysis.hw import H100_SXM
from repro_torch.configs import stencil2d, stencil3d
from repro_torch.core import blocking, perf_model
from repro_torch.kernels import common
from repro_torch.lint.diagnostics import DiagnosticError
from repro_torch.lint.verify import smem_diagnostics
from repro_torch.tuning import autotune

TOL = dict(atol=5e-4, rtol=5e-4)
ULP = dict(atol=1e-6, rtol=1e-5)
WORKS = {**stencil2d.workloads(), **stencil3d.workloads()}


# ---- the paper's model, number for number ------------------------------------

SWEEP = [(nd, r, b, pt) for nd in (2, 3) for r in (1, 2, 3, 4)
         for b in (64, 256, 4096) for pt in (1, 3, 8, 22, 40)]


@pytest.mark.parametrize("name,call", [
    ("flops_per_cell", lambda m, nd, r, b, pt: m.flops_per_cell(nd, r)),
    ("bytes_per_cell", lambda m, nd, r, b, pt: m.bytes_per_cell()),
    ("csize", lambda m, nd, r, b, pt: m.csize(b, pt, r)),
    ("par_total_dsps", lambda m, nd, r, b, pt: m.par_total_dsps(nd, r)),
    ("constraint_eq5",
     lambda m, nd, r, b, pt: m.constraint_eq5(pt, b // 64, nd, r)),
    ("constraint_eq6", lambda m, nd, r, b, pt: m.constraint_eq6(pt, r)),
    ("gbps_from_cells_per_s",
     lambda m, nd, r, b, pt: m.gbps_from_cells_per_s(b * pt * 1e6, r)),
    ("paper_predicted_gbps",
     lambda m, nd, r, b, pt: m.paper_predicted_gbps(300.5, 8, pt, b, r)),
    ("gbps_to_gcells", lambda m, nd, r, b, pt: m.gbps_to_gcells(b / pt)),
    ("gcells_to_gflops",
     lambda m, nd, r, b, pt: m.gcells_to_gflops(b / pt, nd, r)),
    ("roofline_ratio", lambda m, nd, r, b, pt: m.roofline_ratio(b, pt)),
    ("fpga_config", lambda m, nd, r, b, pt: m.FpgaConfig(
        nd, r, (b,) * (nd - 1), 16, pt, 280.0).predicted_gbps()),
])
def test_paper_model_equals_reference(name, call):
    for point in SWEEP:
        assert call(perf_model, *point) == call(ref_pm, *point), (name, point)


@pytest.mark.parametrize("ndim,rad", [(2, 1), (2, 4), (3, 2), (3, 4)])
def test_paper_sweep_equals_reference(ndim, rad):
    bsizes = [(4096,), (2048,)] if ndim == 2 else [(256, 256), (256, 128)]
    mine = perf_model.enumerate_fpga_configs(ndim, rad, 301.2, bsizes, 48)
    theirs = ref_pm.enumerate_fpga_configs(ndim, rad, 301.2, bsizes, 48)
    assert mine and [dataclasses.astuple(c) for c in mine] == \
        [dataclasses.astuple(c) for c in theirs]
    assert [c.predicted_gbps() for c in mine] == \
        [c.predicted_gbps() for c in theirs]
    assert [dataclasses.astuple(r) for r in perf_model.PAPER_TABLE3] == \
        [dataclasses.astuple(r) for r in ref_pm.PAPER_TABLE3]


def test_predicted_gbps_is_the_planner_rate():
    work = WORKS["2d_r4_paper"]
    plan = work.plan()
    rate = blocking.plan_rate(plan, H100_SXM, "plain")
    assert perf_model.predicted_gbps(work.spec, plan, H100_SXM,
                                     "plain") == rate * 8 / 1e9
    est = blocking.estimate(plan, H100_SXM, "plain")
    assert est.body == "queue" and est.bound in ("compute", "memory")
    assert 0 < est.useful_fraction <= 1


# ---- the default front door against the reference's plan="model" -------------

CASES = [
    (dict(ndim=2, radius=2, shape="star", boundary="clamp"), (37, 150), 5),
    (dict(ndim=3, radius=1, shape="star", boundary="periodic"),
     (20, 18, 140), 4),
    (dict(ndim=2, radius=1, shape="box", boundary="constant",
          boundary_value=0.25), (37, 150), 5),
]


@pytest.mark.parametrize("plan", ["auto", "model"])
@pytest.mark.parametrize("fields,shape,steps", CASES)
def test_planned_front_door_matches_reference(fields, shape, steps, plan,
                                              tmp_path):
    rp = RefProgram(**fields)
    rc = rp.default_coeffs(seed=1)
    tp = convert.program_from_fields(**dataclasses.asdict(rp))
    tc = convert.coeffs_from_numpy(np.asarray(rc.center), np.asarray(rc.taps))
    g = np.random.RandomState(2).uniform(-1, 1, shape).astype(np.float32)
    kw = {} if plan == "auto" else {"plan": plan}
    cs = repro_torch.stencil(tp, tc).compile(
        shape, steps=steps, device="cpu",
        cache_path=str(tmp_path / "plans.json"), **kw)
    assert isinstance(cs.plan, repro_torch.BlockPlan)
    got = cs.run(torch.from_numpy(g)).numpy()
    want = repro.stencil(rp, rc).compile(shape, steps=steps,
                                         plan="model").run(g)
    np.testing.assert_allclose(got, np.asarray(want), **ULP)
    np.testing.assert_allclose(got, ref.numpy_program_nsteps(rp, rc, g,
                                                             steps), **TOL)


def test_lower_without_a_plan_matches_reference():
    rp = RefProgram(ndim=2, radius=2)
    tp = convert.program_from_fields(**dataclasses.asdict(rp))
    g = np.random.RandomState(3).uniform(-1, 1, (37, 150)).astype(np.float32)
    low = repro_torch.backends.lower(tp)
    got = low.run(torch.from_numpy(g), 6).numpy()
    want = repro.backends.lower(rp).run(g, 6)
    np.testing.assert_allclose(got, np.asarray(want), **ULP)


# ---- every plan fits, and the planner is deterministic ----------------------

FIT_PROGRAMS = [(nd, shape, r, bnd) for nd in (2, 3)
                for shape, r in (("star", 1), ("star", 4), ("box", 1),
                                 ("box", 2), ("diamond", 2))
                for bnd in ("clamp", "periodic")]


@pytest.mark.parametrize("ndim,shape,radius,boundary", FIT_PROGRAMS)
def test_planned_plans_fit_every_step_count(ndim, shape, radius, boundary):
    """Every plan the planner returns fits a CTA tile on H100_SXM for any
    step count (``steps=None``) and for its compiled steps, and for every
    remainder of two periods; the same call gives the same plan."""
    prog = repro_torch.StencilProgram(ndim=ndim, radius=radius, shape=shape,
                                      boundary=boundary)
    grid = (300, 1000) if ndim == 2 else (64, 96, 160)
    for variant in blocking.VARIANTS:
        try:
            est = blocking.plan_blocking(prog, H100_SXM, grid_shape=grid,
                                         max_par_time=16, variant=variant,
                                         steps=9)
        except ValueError:
            # only a temporal chunk may fit no tile, or waste too much
            assert variant == "temporal"
            one = blocking.BlockPlan(spec=prog, block_shape=grid, par_time=1)
            assert smem_diagnostics(one, variant) or blocking.launch_work(
                one, "temporal_superstep")[3] <= blocking.MIN_USEFUL_FRACTION
            continue
        plan = est.plan
        assert blocking.plan_blocking(prog, H100_SXM, grid_shape=grid,
                                      max_par_time=16, variant=variant,
                                      steps=9) == est
        assert smem_diagnostics(plan, variant, H100_SXM) == []
        period = plan.par_time * (blocking.TEMPORAL_CHUNK
                                  if variant == "temporal" else 1)
        for steps in range(1, 2 * period + 1):
            assert smem_diagnostics(plan, variant, H100_SXM,
                                    grid_shape=grid, steps=steps) == [], \
                (plan, variant, steps)


def test_planner_is_the_same_in_a_fresh_process():
    import subprocess
    import sys
    code = ("from repro_torch.core import blocking; "
            "from repro_torch.configs import stencil3d; "
            "w = stencil3d.workloads()['3d_r2_paper']; "
            "p = blocking.plan_blocking(w.spec, grid_shape=w.grid_shape, "
            "max_par_time=32, variant='plain').plan; "
            "print(p.block_shape, p.par_time)")
    outs = {subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, check=True).stdout for _ in range(2)}
    work = WORKS["3d_r2_paper"]
    plan = blocking.plan_blocking(work.spec, grid_shape=work.grid_shape,
                                  max_par_time=32, variant="plain").plan
    assert outs == {f"{plan.block_shape} {plan.par_time}\n"}


# ---- the card's facts, as rankings at the paper shapes ----------------------

def test_3d_r2_temporal_par_time_1_ranks_above_2():
    work = WORKS["3d_r2_paper"]
    pt1 = dataclasses.replace(work.plan(), par_time=1)
    pt2 = work.plan()
    assert pt2.par_time == 2
    grid = work.grid_shape
    assert blocking.plan_rate(pt1, H100_SXM, "temporal", grid) > \
        blocking.plan_rate(pt2, H100_SXM, "temporal", grid)
    # the 8-step chunk takes the column tile (2, 32): it is not a candidate
    assert blocking.launch_work(pt2, "temporal_superstep")[0] == (2, 32)
    chosen = blocking.plan_blocking(work.spec, grid_shape=grid,
                                    max_par_time=32, variant="temporal")
    assert chosen.plan.par_time == 1
    # the 9-step run the planner picks is predicted at most the par_time-1
    # temporal run's
    auto = autotune(work.spec, grid_shape=grid, variant="auto",
                    measure=False, cache=False, device="cpu")
    assert blocking.run_seconds(auto.plan, grid, 9, H100_SXM, auto.variant) \
        <= blocking.run_seconds(pt1, grid, 9, H100_SXM, "temporal")


def test_2d_r4_plain_ranks_above_temporal():
    work = WORKS["2d_r4_paper"]
    grid = work.grid_shape
    best = {v: blocking.plan_blocking(work.spec, grid_shape=grid,
                                      max_par_time=32, variant=v).plan
            for v in blocking.VARIANTS}
    rate = {v: blocking.plan_rate(p, H100_SXM, v, grid)
            for v, p in best.items()}
    assert rate["plain"] > rate["temporal"]
    assert (best["plain"].par_time, best["plain"].body(
        "padded_superstep")) == (2, "queue")
    auto = autotune(work.spec, grid_shape=grid, variant="auto",
                    measure=False, cache=False, device="cpu")
    assert auto.variant != "temporal"


@pytest.mark.parametrize("name,variant", [
    ("2d_r4_paper", "plain"), ("3d_r4_paper", "plain"),
    ("2d_box_periodic_pod", "plain")])
def test_planner_keeps_the_configs_par_time(name, variant):
    """Where the configuration's own par_time is the fastest measured, the
    planner's plan has it (the block only rounds the layout)."""
    work = WORKS[name]
    grid = (16384, 16384) if name == "2d_box_periodic_pod" \
        else work.grid_shape
    plan = blocking.plan_blocking(work.spec, grid_shape=grid,
                                  max_par_time=32, variant=variant).plan
    assert plan.par_time == work.par_time
    assert blocking.grid_useful_fraction(grid, plan.block_shape) == 1.0


def test_candidates_pay_only_their_round_up_waste():
    """A block only rounds the padded layout: the carry kernels compute
    the true cells whatever it is, so a wasteful block costs the fills of
    a larger padded pair, and loses the tie."""
    prog = repro_torch.StencilProgram(ndim=2, radius=2)
    grid = (1000, 3000)
    blocks = blocking.candidate_blocks(2, grid)
    # the extents, halves and quarters all round the grid alike: one stays
    assert set(blocks) == {(1000, 3000), (1024, 1024)}
    chosen = blocking.plan_blocking(prog, grid_shape=grid).plan
    assert chosen.block_shape == (1000, 3000)
    waste = dataclasses.replace(chosen, block_shape=(1024, 1024))
    assert blocking.grid_useful_fraction(grid, waste.block_shape) < 1
    assert blocking.plan_rate(waste, H100_SXM, "plain", grid) == \
        blocking.plan_rate(chosen, H100_SXM, "plain", grid)
    assert blocking.run_seconds(waste, grid, 9) > \
        blocking.run_seconds(chosen, grid, 9)


# ---- ROADMAP C1: RP105 for every step count ---------------------------------

def _c1(tmp_path=None):
    """3D diamond r4, clamp, block (32, 64, 704), par_time 8: a 4-step run
    fits; a run of 5 or 9 steps launches kernels no CTA tile fits.  The
    grid is small: what fits depends on the plan and the steps."""
    prog = repro_torch.StencilProgram(ndim=3, radius=4, shape="diamond")
    plan = repro_torch.BlockPlan(spec=prog, block_shape=(32, 64, 704),
                                 par_time=8)
    return prog, plan, (6, 8, 40)


def test_c1_config_needs_the_recheck():
    prog, plan, _ = _c1()
    full = (512, 1024, 704)
    assert smem_diagnostics(plan, "plain", H100_SXM, grid_shape=full,
                            steps=4) == []
    for steps in (5, 9):
        found = smem_diagnostics(plan, "plain", H100_SXM, grid_shape=full,
                                 steps=steps)
        assert [d.code for d in found] == ["RP105"]


def test_run_rechecks_rp105_before_any_kernel(monkeypatch):
    prog, plan, shape = _c1()
    cs = repro_torch.stencil(prog).compile(shape, steps=4, plan=plan,
                                           device="cpu", chip=H100_SXM)
    calls = []
    real = common.run_call
    monkeypatch.setattr(common, "run_call",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    grid = torch.zeros(shape)
    for steps in (5, 9):
        with pytest.raises(DiagnosticError, match="RP105"):
            cs.run(grid, steps=steps)
    assert calls == []
    checked = dict(cs._fits)
    cs.run(grid, steps=4)
    assert calls == [1]
    # the result is kept per (a full superstep runs, remainder)
    assert cs._fits == checked and set(checked) == {(False, 4), (False, 5),
                                                    (True, 1)}
    # a compile that checks nothing (the CPU, no chip given) runs any count
    free = repro_torch.stencil(prog).compile(shape, steps=4, plan=plan,
                                             device="cpu")
    assert free._chip is None


def test_compile_refuses_a_planned_variant_that_fits_nothing():
    prog = repro_torch.StencilProgram(ndim=3, radius=4)
    with pytest.raises(DiagnosticError, match="RP105"):
        repro_torch.stencil(prog).compile((16, 16, 64), steps=2,
                                          plan="model", variant="temporal",
                                          device="cpu")
