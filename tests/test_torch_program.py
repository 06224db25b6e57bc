"""The port's IR, oracle, plan geometry and tables against the reference.

Inputs are made with numpy from a seed and handed to both packages through
``repro_torch.convert``; tolerances are the reference's own
(``tests/test_padded_carry.py``): ``ULP`` against the jnp oracle, ``TOL``
against the float64 numpy oracle.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.analysis import hw as ref_hw
from repro.configs import stencil2d as ref_s2d
from repro.configs import stencil3d as ref_s3d
from repro.core import reference as ref
from repro.core.blocking import BlockPlan as RefPlan
from repro.core.codegen import boundary_pad as ref_boundary_pad
from repro.core.program import StencilProgram as RefProgram
from repro.lint import diagnostics as ref_diag

from repro_torch import convert
from repro_torch.analysis import hw
from repro_torch.configs import stencil2d, stencil3d
from repro_torch.core import blocking
from repro_torch.core.codegen import boundary_pad
from repro_torch.core.reference import program_nsteps
from repro_torch.lint import diagnostics

TOL = dict(atol=5e-4, rtol=5e-4)
ULP = dict(atol=1e-6, rtol=1e-5)


def _pair(**fields):
    """(reference program, port program) from one set of fields."""
    rp = RefProgram(**fields)
    return rp, convert.program_from_fields(**dataclasses.asdict(rp))


def _coeffs(rp, seed):
    rc = rp.default_coeffs(seed=seed)
    return rc, convert.coeffs_from_numpy(np.asarray(rc.center),
                                         np.asarray(rc.taps))


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("shape", ["star", "box", "diamond"])
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
def test_taps_and_default_coeffs_match_reference(ndim, shape, radius):
    for sharing in ("pertap", "distance"):
        rp, tp = _pair(ndim=ndim, radius=radius, shape=shape,
                       coeff_sharing=sharing)
        assert tp.neighbor_taps == rp.neighbor_taps
        assert tp.tap_groups == rp.tap_groups
        assert (tp.halo_radius, tp.num_taps, tp.num_shells) == \
            (rp.halo_radius, rp.num_taps, rp.num_shells)
        assert (tp.flops_per_cell, tp.bytes_per_cell) == \
            (rp.flops_per_cell, rp.bytes_per_cell)
        for seed in (0, 7):
            rc = rp.default_coeffs(seed=seed)
            pc = tp.default_coeffs(seed=seed)
            assert pc.center.dtype == pc.taps.dtype == torch.float32
            np.testing.assert_array_equal(pc.center.numpy(),
                                          np.asarray(rc.center))
            np.testing.assert_array_equal(pc.taps.numpy(),
                                          np.asarray(rc.taps))


@pytest.mark.parametrize("ndim,grid", [(2, (23, 41)), (3, (9, 11, 20))])
@pytest.mark.parametrize("boundary", ["clamp", "periodic", "constant"])
@pytest.mark.parametrize("shape", ["star", "box"])
def test_program_nsteps_matches_reference_oracles(ndim, grid, boundary,
                                                  shape):
    rp, tp = _pair(ndim=ndim, radius=2, shape=shape, boundary=boundary,
                   boundary_value=0.25)
    rc, tc = _coeffs(rp, seed=ndim)
    g = np.random.RandomState(1).uniform(-1, 1, grid).astype(np.float32)
    got = program_nsteps(tp, tc, torch.from_numpy(g), 3).numpy()
    want = np.asarray(ref.program_nsteps(rp, rc, jnp.asarray(g), 3))
    np.testing.assert_allclose(got, want, **ULP)
    np.testing.assert_allclose(got, ref.numpy_program_nsteps(rp, rc, g, 3),
                               **TOL)


@pytest.mark.parametrize("boundary", ["clamp", "periodic", "constant"])
def test_boundary_pad_wider_than_axis_matches_jnp_pad(boundary):
    """Pads wider than the axis: several wrap laps, long edge runs."""
    rp, tp = _pair(ndim=2, radius=1, boundary=boundary, boundary_value=-2.0)
    g = np.random.RandomState(2).uniform(-1, 1, (2, 3, 5)).astype(np.float32)
    pads = [(0, 0), (7, 4), (2, 11)]
    got = boundary_pad(tp, torch.from_numpy(g), pads).numpy()
    want = np.asarray(ref_boundary_pad(rp, jnp.asarray(g), pads))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ndim,block,grid", [
    (2, (16, 128), (37, 150)), (3, (8, 16, 128), (9, 18, 140))])
@pytest.mark.parametrize("par_time", [1, 3])
def test_block_plan_geometry_matches_reference(ndim, block, grid, par_time):
    rp, tp = _pair(ndim=ndim, radius=2, shape="box")
    rplan = RefPlan(spec=rp, block_shape=block, par_time=par_time)
    tplan = convert.plan_from_fields(**dataclasses.asdict(rplan))
    assert tplan.program == tp
    assert (tplan.halo, tplan.padded_shape) == \
        (rplan.halo, rplan.padded_shape)
    assert tplan.flops_per_block() == rplan.flops_per_block()
    assert tplan.hbm_bytes_per_block() == rplan.hbm_bytes_per_block()
    for v in ("plain", "temporal"):
        assert tplan.run_bytes_per_superstep(grid, variant=v) == \
            rplan.run_bytes_per_superstep(grid, variant=v)


def test_normalize_variant_takes_names_only():
    assert blocking.VARIANTS == ("plain", "pipelined", "temporal")
    assert blocking.TEMPORAL_CHUNK == 4
    assert blocking.normalize_variant(None) == "plain"
    assert blocking.normalize_variant("temporal") == "temporal"
    # the deprecated bool maps as in the reference
    assert blocking.normalize_variant(True) == "pipelined"
    assert blocking.normalize_variant(None, True) == "pipelined"
    for bad in ("fast", "auto"):
        with pytest.raises(ValueError, match="unknown kernel variant"):
            blocking.normalize_variant(bad)
    assert blocking.round_up(37, 16) == 48


def test_gpu_chip_datasheets():
    assert hw.datasheet("NVIDIA H100 80GB HBM3") is hw.H100_SXM
    assert hw.datasheet("NVIDIA H100 PCIe, 350.00 W") is hw.H100_PCIE
    assert hw.H100_SXM.smem_optin == 232448
    assert (hw.H100_SXM.sm_count, hw.H100_SXM.hbm_bytes_per_s,
            hw.H100_SXM.peak_fp32_flops) == (132, 3.35e12, 67e12)
    # the port's chip is its own: no TPU figure carried over
    assert not hasattr(hw.H100_SXM, "vmem_budget_bytes")
    assert ref_hw.V5E.hbm_bytes_per_s != hw.H100_SXM.hbm_bytes_per_s


def test_diagnostic_codes_keep_the_reference_wording():
    """Same wording as the reference, except RP105, whose budget on the
    card is shared memory per CTA, not VMEM, and RP200, the launch audit's
    own code (an audit that saw no launch), which the reference lacks."""
    for code, summary in diagnostics.CODES.items():
        if code == "RP105":
            assert "shared memory" in summary and "VMEM" not in summary
            assert code in ref_diag.CODES
            continue
        if code == "RP200":
            assert "no kernel launch" in summary
            assert code not in ref_diag.CODES
            continue
        assert summary == ref_diag.CODES[code], code
    err = diagnostics.DiagnosticError([diagnostics.error(
        "RP102", "steps must be an int >= 1", hint="run a step")])
    assert isinstance(err, ValueError)
    assert str(err) == "RP102: steps must be an int >= 1 (fix: run a step)"
    with pytest.raises(ValueError, match="unknown diagnostic code"):
        diagnostics.error("RP999", "no such code")


def test_workload_tables_match_reference():
    for port, refmod in ((stencil2d, ref_s2d), (stencil3d, ref_s3d)):
        got, want = port.workloads(), refmod.workloads()
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            t = got[name]
            assert dataclasses.asdict(t.spec) == dataclasses.asdict(w.spec)
            assert (t.grid_shape, t.block_shape, t.par_time) == \
                (w.grid_shape, w.block_shape, w.par_time)
            assert dataclasses.asdict(t.plan()) == \
                dataclasses.asdict(w.plan())


def test_coeffs_from_numpy_places_float32_on_device():
    c = convert.coeffs_from_numpy(0.5, np.arange(4, dtype=np.float64), "cpu")
    assert c.center.dtype == c.taps.dtype == torch.float32
    assert c.center.shape == () and c.taps.shape == (4,)
    np.testing.assert_array_equal(c.taps.numpy(), [0, 1, 2, 3])
