"""The port's RP4xx pair — the ring-schedule proof (``repro_torch.lint.
dataflow``) and the NaN canary (``repro_torch.lint.sanitize``) — against
the reference's, on the CPU.

The reference runs its Pallas kernels in interpret mode, as
``tests/test_dataflow.py`` runs them; the port runs its kernels' plain
versions (``device="cpu"``).  The canary on the card's kernels is in
``tests/test_torch_cuda.py``.

* proof parity: over a sample of the H100 planner's candidates, both
  proofs accept every point;
* the mutation gate: each seeded schedule bug, patched into both
  packages' ``wrap_copies``/``ping_pong_aliases``, gives the same RP4xx
  code from all four halves (port proof, port canary, reference proof,
  reference canary);
* the clean canary matrix: boundary x variant x remainder, with the
  reference's superstep counts, its advanced interior equal to the port's
  front door at 0 and to the JAX run at ULP.
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

import repro
from repro.core.blocking import BlockPlan as RefPlan
from repro.core.program import StencilProgram as RefProgram
from repro.kernels import common as ref_common
from repro.lint.dataflow import verify_dataflow as ref_verify_dataflow
from repro.lint.sanitize import sanitize_run as ref_sanitize_run

import repro_torch
from repro_torch import convert
from repro_torch.analysis.hw import H100_SXM
from repro_torch.core.blocking import (TEMPORAL_CHUNK, VARIANTS,
                                       candidate_plans)
from repro_torch.kernels import common
from repro_torch.lint import check_dataflow, sanitize_run, verify_dataflow
from repro_torch.lint.__main__ import main as lint_main
from repro_torch.lint.diagnostics import DiagnosticError
from repro_torch.lint.sanitize import SENTINEL, canary_grid

ULP = dict(atol=1e-6, rtol=1e-5)
GRID = (16, 128)
BLOCK = (8, 128)


def _both(boundary="periodic", radius=1, par_time=2, ndim=2, block=BLOCK):
    rp = RefProgram(ndim=ndim, radius=radius, boundary=boundary)
    rplan = RefPlan(spec=rp, block_shape=block, par_time=par_time)
    tp = convert.program_from_fields(**dataclasses.asdict(rp))
    tplan = convert.plan_from_fields(**dataclasses.asdict(rplan))
    return rp, rplan, tp, tplan


def _errors(diags):
    return [d.code for d in diags if d.is_error]


def _steps_for(plan, variant):
    period = plan.par_time * (TEMPORAL_CHUNK if variant == "temporal" else 1)
    return 2 * period + (1 if period > 1 else 0)


# ---- proof parity over the planner's candidates -----------------------------


@pytest.mark.parametrize("ndim,grid", [(2, (64, 256)), (3, (16, 32, 256))])
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
def test_proof_accepts_the_planners_candidates_like_the_reference(
        ndim, grid, radius):
    checked = 0
    for boundary in ("periodic", "clamp"):
        tp = repro_torch.StencilProgram(ndim=ndim, radius=radius,
                                        boundary=boundary)
        rp = RefProgram(ndim=ndim, radius=radius, boundary=boundary)
        for v in VARIANTS:
            plans = candidate_plans(tp, H100_SXM, max_par_time=6, variant=v,
                                    grid_shape=grid)
            for plan in plans[::max(1, len(plans) // 4)]:
                rplan = RefPlan(spec=rp, block_shape=plan.block_shape,
                                par_time=plan.par_time)
                steps = _steps_for(plan, v)
                got = verify_dataflow(tp, plan, grid, steps=steps, variant=v)
                want = ref_verify_dataflow(rp, rplan, grid, steps=steps,
                                           variant=v)
                assert _errors(got) == _errors(want) == [], (
                    f"{boundary} {v} {plan.block_shape} x{plan.par_time}: "
                    f"{[d.describe() for d in got]}")
                checked += 1
    assert checked >= 12


# ---- the mutation gate: four halves, one code -------------------------------


def _shallow_lo_copies(module):
    """Off-by-one: the lo ring refresh starts one cell short."""
    def copies(layout):
        H, P = layout.halo, layout.padded_shape
        out = []
        for d in layout.wrap_axes:
            n = layout.local_shape[d]
            W = P[d] - H - n
            out.append(module.RingCopy("wrap", d, (n + 1, n + H), (1, H)))
            out.append(module.RingCopy("wrap", d, (H, H + W),
                                       (H + n, H + n + W)))
        return tuple(out)
    return copies


def _plain_depth_copies(module):
    """Temporal over-read: the ring refreshed only to plain depth."""
    def copies(layout):
        H = layout.halo
        hp = H // TEMPORAL_CHUNK
        out = []
        for d in layout.wrap_axes:
            n = layout.local_shape[d]
            out.append(module.RingCopy("wrap", d, (n, n + hp), (H - hp, H)))
            out.append(module.RingCopy("wrap", d, (H, H + hp),
                                       (H + n, H + n + hp)))
        return tuple(out)
    return copies


def _mutate(monkeypatch, module, mutation):
    if mutation == "off_by_one":
        monkeypatch.setattr(module, "wrap_copies", _shallow_lo_copies(module))
    elif mutation == "skipped_wrap":
        monkeypatch.setattr(module, "wrap_copies", lambda layout: ())
    elif mutation == "swapped_alias":
        monkeypatch.setattr(module, "ping_pong_aliases",
                            lambda wrap: {3: 1, 4: 0} if wrap else {4: 0})
    else:
        monkeypatch.setattr(module, "wrap_copies",
                            _plain_depth_copies(module))


def _four_halves(rp, rplan, tp, tplan, variant, steps):
    return {
        "port proof": _errors(verify_dataflow(tp, tplan, GRID, steps=steps,
                                              variant=variant)),
        "port canary": _errors(sanitize_run(
            tp, tplan, GRID, steps=steps, variant=variant,
            device="cpu").diagnostics),
        "reference proof": _errors(ref_verify_dataflow(
            rp, rplan, GRID, steps=steps, variant=variant)),
        "reference canary": _errors(ref_sanitize_run(
            rp, rplan, GRID, steps=steps, variant=variant).diagnostics),
    }


@pytest.mark.parametrize("mutation,variant,expect", [
    ("off_by_one", "plain", "RP401"),
    ("skipped_wrap", "plain", "RP405"),
    ("swapped_alias", "plain", "RP404"),
    ("temporal_shallow", "temporal", "RP401"),
])
def test_mutation_gives_one_code_from_four_halves(monkeypatch, mutation,
                                                  variant, expect):
    rp, rplan, tp, tplan = _both("periodic")
    steps = _steps_for(tplan, variant)
    clean = _four_halves(rp, rplan, tp, tplan, variant, steps)
    assert all(codes == [] for codes in clean.values()), clean

    _mutate(monkeypatch, common, mutation)
    _mutate(monkeypatch, ref_common, mutation)
    found = _four_halves(rp, rplan, tp, tplan, variant, steps)
    for half, codes in found.items():
        assert expect in codes, f"{half} missed {mutation}: {codes}"
    # the port's codes are the reference's, half for half
    assert found["port proof"] == found["reference proof"]
    assert found["port canary"] == found["reference canary"]


def _with(sched, **fields):
    """``sched`` with ``fields`` replaced on every superstep."""
    return dataclasses.replace(sched, supersteps=tuple(
        dataclasses.replace(ss, **fields) for ss in sched.supersteps))


def test_deferred_ring_is_rp405():
    """A schedule whose ring copies land after the reads."""
    rp, rplan, tp, tplan = _both("periodic")
    late = _with(common.ring_schedule(tp, tplan, GRID, 5),
                 ring_deferred=True)
    assert "RP405" in _errors(verify_dataflow(tp, tplan, GRID, steps=5,
                                              schedule=late))
    rlate = _with(ref_common.ring_schedule(rp, rplan, GRID, 5),
                  ring_deferred=True)
    assert "RP405" in _errors(ref_verify_dataflow(rp, rplan, GRID, steps=5,
                                                  schedule=rlate))


@pytest.mark.parametrize("field,value,expect", [
    ("write_tile", (BLOCK[0] - 2, BLOCK[1]), "RP402"),
    ("write_stride", (BLOCK[0] - 2, BLOCK[1]), "RP403"),
    ("write_stride", (BLOCK[0] + 2, BLOCK[1]), "RP403"),
])
def test_write_coverage_mutations(field, value, expect):
    """Schedule-level write bugs: RP402 for a hole, RP403 for an overlap
    or a tile outside the interior; the same codes as the reference."""
    rp, rplan, tp, tplan = _both("clamp")
    bad = _with(common.ring_schedule(tp, tplan, GRID, 5), **{field: value})
    got = verify_dataflow(tp, tplan, GRID, steps=5, schedule=bad)
    want = ref_verify_dataflow(
        rp, rplan, GRID, steps=5,
        schedule=_with(ref_common.ring_schedule(rp, rplan, GRID, 5),
                       **{field: value}))
    assert expect in _errors(got)
    assert _errors(got) == _errors(want)
    with pytest.raises(DiagnosticError, match=expect):
        check_dataflow(tp, tplan, GRID, steps=5, schedule=bad)


# ---- the clean canary matrix ------------------------------------------------


@pytest.mark.parametrize("boundary", ["periodic", "clamp", "constant"])
@pytest.mark.parametrize("variant", ["plain", "pipelined", "temporal"])
@pytest.mark.parametrize("remainder", [False, True])
def test_canary_matrix_is_clean_and_equals_the_runs(boundary, variant,
                                                    remainder):
    rp, rplan, tp, tplan = _both(boundary)
    period = tplan.par_time * (TEMPORAL_CHUNK
                               if variant == "temporal" else 1)
    steps = 2 * period + (1 if remainder else 0)
    report = sanitize_run(tp, tplan, GRID, steps=steps, variant=variant,
                          device="cpu")
    # the reference's canary executes every superstep of its schedule
    want = ref_common.ring_schedule(rp, rplan, GRID, steps, variant=variant)
    assert not report.fallback and report.ok, report.describe()
    assert report.supersteps == len(want.supersteps) == 2 + int(remainder)
    assert report.to_json()["ok"] is True

    grid = canary_grid(GRID)
    coeffs = tp.default_coeffs(0)
    cs = repro_torch.stencil(tp, coeffs).compile(
        GRID, steps=steps, plan=tplan, variant=variant, device="cpu")
    np.testing.assert_array_equal(report.interior.numpy(),
                                  cs.run(torch.from_numpy(grid)).numpy())
    jax_out = repro.stencil(rp, rp.default_coeffs(0)).compile(
        GRID, steps=steps, plan=rplan, variant=variant,
        interpret=True).run(grid)
    np.testing.assert_allclose(report.interior.numpy(), np.asarray(jax_out),
                               **ULP)


def test_canary_poisons_the_slack_of_a_block_that_does_not_divide():
    """Grid (37, 150) under block (16, 128): slack cells on both axes hold
    NaN before every superstep, and the run is still clean."""
    for boundary in ("clamp", "periodic", "constant"):
        prog = repro_torch.StencilProgram(ndim=2, radius=2,
                                          boundary=boundary,
                                          boundary_value=0.25)
        plan = repro_torch.BlockPlan(spec=prog, block_shape=(16, 128),
                                     par_time=2)
        report = sanitize_run(prog, plan, (37, 150), steps=5, device="cpu")
        assert report.ok and report.supersteps == 3, report.describe()
        assert not torch.isnan(report.interior).any()
        assert not (report.interior == SENTINEL).any()


def test_fallback_is_reported_not_failed():
    """Halo 17 > the 16-cell axis: no ring schedule, the run re-pads."""
    rp, rplan, tp, tplan = _both("periodic", par_time=17, block=(16, 128))
    report = sanitize_run(tp, tplan, GRID, steps=17, device="cpu")
    want = ref_sanitize_run(rp, rplan, GRID, steps=17)
    assert report.fallback and report.ok and report.supersteps == 0
    assert report.to_json() == want.to_json()
    assert report.interior is None
    assert "re-pad fallback" in report.describe()
    assert verify_dataflow(tp, tplan, GRID, steps=17) == []


def test_compile_runs_the_proof_and_the_canary():
    _, _, tp, tplan = _both("periodic")
    cs = repro_torch.stencil(tp).compile(GRID, steps=5, plan=tplan,
                                         device="cpu", sanitize=True)
    assert cs.sanitize_report is not None and cs.sanitize_report.ok
    assert cs.sanitize_report.supersteps == 3
    assert all(not d.is_error for d in cs.preflight)
    out = cs.run(torch.from_numpy(canary_grid(GRID)))
    assert out.shape == GRID and torch.isfinite(out).all()
    assert repro_torch.stencil(tp).compile(
        GRID, steps=5, plan=tplan, device="cpu").sanitize_report is None


def test_compile_refuses_a_schedule_the_proof_rejects(monkeypatch):
    _, _, tp, tplan = _both("periodic")
    monkeypatch.setattr(common, "wrap_copies", lambda layout: ())
    with pytest.raises(DiagnosticError, match="RP405"):
        repro_torch.stencil(tp).compile(GRID, steps=5, plan=tplan,
                                        device="cpu")


def test_canary_without_a_card_is_rp110():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: sanitize_run() runs it")
    _, _, tp, tplan = _both("periodic")
    with pytest.raises(DiagnosticError, match="RP110"):
        sanitize_run(tp, tplan, GRID, steps=5)


def test_proof_best_of_20_under_2ms():
    _, _, tp, tplan = _both("periodic")
    best = float("inf")
    for _ in range(20):
        t0 = time.perf_counter()
        verify_dataflow(tp, tplan, GRID, steps=5)
        best = min(best, time.perf_counter() - t0)
    assert best < 2e-3, f"the proof took {best * 1e3:.3f} ms"


# ---- the CLI ----------------------------------------------------------------


def test_cli_dataflow_and_sanitize_write_json(tmp_path, capsys):
    common_args = ["--ndim", "2", "--radius", "1", "--boundary", "periodic",
                   "--grid", "16,128", "--block", "8,128", "--par-time", "2",
                   "--steps", "5"]
    out = tmp_path / "dataflow.json"
    assert lint_main(["dataflow", *common_args, "--json", str(out)]) == 0
    assert json.loads(out.read_text()) == []
    out = tmp_path / "sanitize.json"
    assert lint_main(["sanitize", *common_args, "--device", "cpu",
                      "--json", str(out)]) == 0
    assert json.loads(out.read_text()) == []
    text = capsys.readouterr().out
    assert "3 superstep(s) executed — clean" in text
    assert "dataflow of 2D r=1 periodic plain" in text


def test_cli_reports_a_seeded_fault(monkeypatch, tmp_path):
    monkeypatch.setattr(common, "wrap_copies", lambda layout: ())
    args = ["--grid", "16,128", "--block", "8,128", "--par-time", "2",
            "--steps", "5", "--json"]
    for command in (["dataflow"], ["sanitize", "--device", "cpu"]):
        out = tmp_path / f"{command[0]}.json"
        assert lint_main([*command, *args, str(out)]) == 1
        codes = {d["code"] for d in json.loads(out.read_text())}
        assert codes == {"RP405"}


def test_cli_refuses_a_mesh_and_the_codebase_rules(capsys, tmp_path):
    """The canary runs one device's schedule: ``sanitize --devices`` is
    refused (the mesh's proof is ``dataflow --devices``).  Paths are no
    longer refused: they run the port's codebase rules (RP3xx), exit 1 on
    a finding and 0 on a clean file."""
    assert lint_main(["sanitize", "--device", "cpu", "--devices", "2,1"]) \
        == 2
    err = capsys.readouterr().err
    assert "RP110" in err and "dataflow --devices 2,1" in err
    bad = tmp_path / "bad.py"
    bad.write_text("f(grid, pipelined=True)\n")
    assert lint_main([str(bad)]) == 1
    assert "RP305" in capsys.readouterr().out
    good = tmp_path / "good.py"
    good.write_text("f(grid, variant='pipelined')\n")
    assert lint_main([str(good)]) == 0
