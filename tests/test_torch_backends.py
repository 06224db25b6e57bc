"""The port's backend registry (``repro_torch.backends``), mirroring
``tests/test_backends.py`` and the variant mapping of
``tests/test_variant_api.py``: registry mechanics, variant resolution, the
torch-reference oracle, and each cuda backend's ``lower(...)`` on CPU
tensors against ``repro.backends.lower(..., backend="pallas-interpret…")``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.backends import lower as ref_lower
from repro.core import reference as ref
from repro.core.blocking import BlockPlan as RefPlan
from repro.core.program import StencilProgram as RefProgram

import repro_torch
from repro_torch import convert
from repro_torch.backends import (available_backends, backend_traits,
                                  default_backend_name, get_backend, lower,
                                  register_backend, resolve_backend,
                                  variant_of)
from repro_torch.backends.registry import LoweredStencil
from repro_torch.core.blocking import plan_blocking
from repro_torch.lint.verify import smem_diagnostics
from repro_torch.lint.diagnostics import DiagnosticError

TOL = dict(atol=5e-4, rtol=5e-4)
ULP = dict(atol=1e-6, rtol=1e-5)

CUDA_NAMES = ("cuda", "cuda-pipelined", "cuda-temporal")


def _both(ndim=2, boundary="periodic", shape="box", par_time=2):
    rp = RefProgram(ndim=ndim, radius=2, shape=shape, boundary=boundary,
                    boundary_value=0.3)
    block = (16, 128) if ndim == 2 else (8, 16, 128)
    rplan = RefPlan(spec=rp, block_shape=block, par_time=par_time)
    rc = rp.default_coeffs(seed=ndim)
    tp = convert.program_from_fields(**dataclasses.asdict(rp))
    tplan = convert.plan_from_fields(**dataclasses.asdict(rplan))
    tc = convert.coeffs_from_numpy(np.asarray(rc.center), np.asarray(rc.taps))
    return rp, rplan, rc, tp, tplan, tc


def _grid(shape, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


# ---- registry mechanics ----------------------------------------------------

def test_builtin_backends_registered():
    avail = available_backends()
    for name in CUDA_NAMES + ("torch-reference",):
        assert avail.get(name) == (1,), avail
    assert default_backend_name() == "cuda"
    assert backend_traits("cuda").fused_run
    assert backend_traits("cuda").local_kernel
    assert backend_traits("cuda-pipelined").variant == "pipelined"
    temporal = backend_traits("cuda-temporal")
    assert (temporal.variant, temporal.fused_run,
            temporal.local_kernel) == ("temporal", True, False)
    oracle = backend_traits("torch-reference")
    assert not oracle.fused_run and not oracle.local_kernel
    assert not hasattr(oracle, "pipelined")


def test_unknown_backend_raises():
    with pytest.raises(KeyError):
        get_backend("fpga-aoc")
    with pytest.raises(KeyError):
        get_backend("cuda", version=99)


@pytest.fixture
def registry_sandbox():
    """Snapshot/restore the process-global backend registry."""
    from repro_torch.backends import registry
    snap = {k: dict(v) for k, v in registry._REGISTRY.items()}
    traits = dict(registry._TRAITS)
    yield
    registry._REGISTRY.clear()
    registry._REGISTRY.update(snap)
    registry._TRAITS.clear()
    registry._TRAITS.update(traits)


def test_versioned_resolution_highest_wins(registry_sandbox):
    @register_backend("test-dummy", version=1)
    def v1(program, plan, coeffs):
        return LoweredStencil(program, plan, coeffs,
                              lambda g, c: ("v1", g),
                              lambda g, c, s: ("v1", g))

    @register_backend("test-dummy", version=2)
    def v2(program, plan, coeffs):
        return LoweredStencil(program, plan, coeffs,
                              lambda g, c: ("v2", g),
                              lambda g, c, s: ("v2", g))

    assert get_backend("test-dummy")[1] == 2
    assert get_backend("test-dummy", version=1)[1] == 1
    with pytest.raises(ValueError):
        register_backend("test-dummy", version=2)(v2)
    prog = repro_torch.StencilProgram(ndim=2, radius=1)
    plan = repro_torch.BlockPlan(spec=prog, block_shape=(8, 128), par_time=1)
    low = lower(prog, plan, backend="test-dummy")
    assert (low.backend_name, low.backend_version) == ("test-dummy", 2)
    assert low.run(torch.zeros(4, 4), 3)[0] == "v2"
    assert lower(prog, plan, backend="test-dummy",
                 version=1).backend_version == 1
    assert backend_traits("test-dummy") == backend_traits("torch-reference")


def test_variant_of_maps_between_siblings():
    assert variant_of("cuda", "temporal") == "cuda-temporal"
    assert variant_of("cuda-temporal", "plain") == "cuda"
    assert variant_of("cuda-pipelined", "temporal") == "cuda-temporal"
    assert variant_of("torch-reference", "temporal") is None


def test_resolve_backend_never_runs_another_kernel():
    assert resolve_backend()[:2] == ("cuda", 1)
    assert resolve_backend(variant="pipelined")[0] == "cuda-pipelined"
    assert resolve_backend("cuda-temporal")[2].variant == "temporal"
    assert resolve_backend("cuda-temporal", variant="plain")[0] == "cuda"
    assert resolve_backend("torch-reference",
                           variant="plain")[0] == "torch-reference"
    for v in ("pipelined", "temporal"):
        with pytest.raises(ValueError, match=f"no {v} lowering"):
            resolve_backend("torch-reference", variant=v)
    with pytest.raises(ValueError, match="unknown kernel variant"):
        resolve_backend("cuda", variant="fast")
    _, _, _, tp, tplan, _ = _both()
    with pytest.raises(ValueError, match="no temporal lowering"):
        repro_torch.stencil(tp).compile((37, 150), steps=2, plan=tplan,
                                        backend="torch-reference",
                                        variant="temporal", device="cpu")


def test_lower_without_a_plan_is_rp112():
    """``lower`` without a plan takes the planner's pick for the backend's
    variant (a plan every kernel of the run fits); anything but a
    ``BlockPlan`` or None is RP112; the oracle takes no plan."""
    prog = repro_torch.StencilProgram(ndim=2, radius=1)
    for name in CUDA_NAMES:
        low = lower(prog, backend=name, grid_shape=(37, 150))
        v = backend_traits(name).variant
        assert low.plan == plan_blocking(prog, grid_shape=(37, 150),
                                         variant=v).plan
        assert smem_diagnostics(low.plan, v) == []
        assert isinstance(lower(prog, backend=name).plan,
                          repro_torch.BlockPlan)
        with pytest.raises(DiagnosticError, match="RP112"):
            lower(prog, (16, 128), backend=name)
    assert lower(prog, backend="torch-reference").plan is None


# ---- lowered semantics -----------------------------------------------------

@pytest.mark.parametrize("batch", [None, 2])
def test_torch_reference_matches_numpy(batch):
    rp, _, rc, tp, tplan, tc = _both(shape="box", boundary="periodic")
    low = lower(tp, tplan, coeffs=tc, backend="torch-reference")
    lead = () if batch is None else (batch,)
    g = _grid(lead + (24, 40), seed=1)
    got = low.run(torch.from_numpy(g), 4).numpy()
    step = low.superstep(torch.from_numpy(g)).numpy()
    for i in range(batch or 1):
        one = g if batch is None else g[i]
        mine = got if batch is None else got[i]
        np.testing.assert_allclose(
            mine, ref.numpy_program_nsteps(rp, rc, one, 4), **TOL)
        np.testing.assert_allclose(
            step if batch is None else step[i],
            ref.numpy_program_nsteps(rp, rc, one, tplan.par_time), **TOL)


@pytest.mark.parametrize("name", CUDA_NAMES)
@pytest.mark.parametrize("ndim", [2, 3])
def test_lowered_cuda_backend_matches_pallas(name, ndim):
    """``run`` over supersteps + remainder and ``superstep`` on CPU
    tensors (the plain versions) against the Pallas sibling in interpret
    mode."""
    rp, rplan, rc, tp, tplan, tc = _both(ndim, par_time=2 if ndim == 2
                                         else 1)
    shape = (37, 150) if ndim == 2 else (20, 32, 140)
    pallas = "pallas-interpret" + name[len("cuda"):]
    want = ref_lower(rp, rplan, coeffs=rc, backend=pallas)
    got = lower(tp, tplan, coeffs=tc, backend=name)
    assert (got.backend_name, got.backend_version) == (name, 1)
    g = _grid(shape, seed=ndim)
    steps = 4 * tplan.par_time + 1
    np.testing.assert_allclose(got.run(torch.from_numpy(g), steps).numpy(),
                               np.asarray(want.run(g, steps)), **ULP)
    np.testing.assert_allclose(got.superstep(torch.from_numpy(g)).numpy(),
                               np.asarray(want.superstep(g)), **ULP)


def test_front_door_runs_torch_reference_through_lower():
    rp, rplan, rc, tp, tplan, tc = _both(boundary="constant")
    cs = repro_torch.stencil(tp, tc).compile(
        (37, 150), steps=5, plan=tplan, backend="torch-reference",
        device="cpu")
    assert (cs.backend, cs.backend_version, cs.variant) == \
        ("torch-reference", 1, "plain")
    g = _grid((37, 150), seed=9)
    got = cs.run(torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, ref.numpy_program_nsteps(rp, rc, g, 5),
                               **TOL)
    kernels = repro_torch.stencil(tp, tc).compile(
        (37, 150), steps=5, plan=tplan, device="cpu")
    assert kernels.backend == "cuda"
    np.testing.assert_allclose(kernels.run(torch.from_numpy(g)).numpy(),
                               got, **ULP)
