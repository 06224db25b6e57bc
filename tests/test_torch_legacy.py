"""The legacy stencil surface of the port against the reference's:
``StencilSpec``/``StencilCoeffs``, the (spec, coeffs) pair in codegen,
the oracle, the planner, the model and the pre-padded supersteps,
``StencilEngine``, ``ops.stencil_run``, ``stencil_superstep(pipelined=)``
and the ``pipelined=`` bool with its RP114 at ``compile``, the server and
``resolve_backend``.

The port runs on the CPU (``device="cpu"``: the kernels' plain versions)
with a pinned plan on both sides; the reference runs its Pallas kernels in
interpret mode, as its own tests run them.  Results are held to the
reference at the repo's ULP and to the port's own front door at 0.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.backends import pipelined_variant as ref_pipelined_variant
from repro.backends import resolve_backend as ref_resolve_backend
from repro.core import codegen as ref_codegen
from repro.core import reference as ref_reference
from repro.core import spec as ref_spec
from repro.core.blocking import BlockPlan as RefPlan
from repro.core.blocking import normalize_variant as ref_normalize_variant
from repro.core.temporal import StencilEngine as RefEngine
from repro.kernels import ops as ref_ops
from repro.launch.stencil_serve import StencilServer as RefServer
from repro.lint.diagnostics import DiagnosticError as RefDiagnosticError

import repro_torch
import repro_torch.core
from repro_torch import convert
from repro_torch.analysis.hw import H100_SXM
from repro_torch.backends import lower, pipelined_variant, resolve_backend
from repro_torch.core import codegen, reference, spec as port_spec
from repro_torch.core.blocking import (BlockPlan, estimate,
                                       normalize_variant, plan_blocking)
from repro_torch.core.perf_model import predicted_gbps
from repro_torch.core.temporal import StencilEngine
from repro_torch.kernels import common, ops
from repro_torch.kernels.stencil2d import stencil2d_superstep
from repro_torch.kernels.stencil3d import stencil3d_superstep
from repro_torch.launch.stencil_serve import StencilServer
from repro_torch.lint.diagnostics import DiagnosticError

ULP = dict(atol=1e-6, rtol=1e-5)
EXACT = dict(atol=0.0, rtol=0.0)
BLOCKS = {2: (16, 128), 3: (8, 16, 128)}
#: 2D not divisible by the block; 3D one block
GRIDS = {2: (18, 131), 3: (8, 16, 128)}
PAR_TIME = {2: 2, 3: 1}


@pytest.fixture(autouse=True)
def one_thread():
    """Intra-op threads: one.  These CPU tensors are small, and the test
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*args, **kwargs)


def _deprecations(fn):
    """``fn()`` and the DeprecationWarnings it raised."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    return out, [w for w in caught
                 if issubclass(w.category, DeprecationWarning)]


def _both(ndim, radius=2, boundary="clamp", seed=0):
    """The same legacy spec, coefficients, plan and grid on both sides."""
    rs = _quiet(ref_spec.StencilSpec, ndim=ndim, radius=radius,
                boundary=boundary)
    ts = _quiet(port_spec.StencilSpec, **dataclasses.asdict(rs))
    rc = rs.default_coeffs(seed=seed)
    tc = convert.spec_coeffs_from_numpy(np.asarray(rc.center),
                                        np.asarray(rc.neighbors))
    rplan = RefPlan(spec=rs, block_shape=BLOCKS[ndim],
                    par_time=PAR_TIME[ndim])
    tplan = BlockPlan(spec=ts, block_shape=BLOCKS[ndim],
                      par_time=PAR_TIME[ndim])
    g = np.random.RandomState(seed).uniform(
        -1, 1, GRIDS[ndim]).astype(np.float32)
    return rs, ts, rc, tc, rplan, tplan, g


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


# ---- StencilSpec and StencilCoeffs -----------------------------------------------

@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
def test_spec_properties_and_coeffs_equal_the_reference(ndim, radius):
    rs = _quiet(ref_spec.StencilSpec, ndim=ndim, radius=radius)
    ts = _quiet(port_spec.StencilSpec, ndim=ndim, radius=radius)
    for name in ("num_directions", "halo_radius", "flops_per_cell",
                 "flops_per_cell_shared", "muls_per_cell", "adds_per_cell",
                 "bytes_per_cell", "flop_per_byte"):
        assert getattr(ts, name) == getattr(rs, name), name
    assert dataclasses.asdict(ts.to_program()) \
        == dataclasses.asdict(rs.to_program())
    for draw in ("default_coeffs", "shared_coeffs"):
        for seed in (0, 5):
            want = getattr(rs, draw)(seed)
            got = getattr(ts, draw)(seed)
            assert got.neighbors.shape == (2 * ndim, radius)
            _close(got.center, want.center, EXACT)
            _close(got.neighbors, want.neighbors, EXACT)
            assert str(got.neighbors.dtype).endswith(
                str(np.asarray(want.neighbors).dtype))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_16bit_spec_coeffs_equal_the_reference(dtype):
    rs = _quiet(ref_spec.StencilSpec, ndim=2, radius=4, dtype=dtype)
    ts = _quiet(port_spec.StencilSpec, ndim=2, radius=4, dtype=dtype)
    for draw in ("default_coeffs", "shared_coeffs"):
        want, got = getattr(rs, draw)(3), getattr(ts, draw)(3)
        assert str(got.neighbors.dtype) == f"torch.{dtype}"
        for g, w in ((got.center, want.center),
                     (got.neighbors, want.neighbors)):
            np.testing.assert_array_equal(
                g.float().numpy(), np.asarray(w).astype(np.float32))


def test_spec_warns_once_and_validates_like_the_reference():
    _, caught = _deprecations(lambda: port_spec.StencilSpec(2, 1))
    assert len(caught) == 1 and caught[0].filename == __file__
    assert "repro_torch.stencil(program" in str(caught[0].message)
    for bad in (dict(ndim=4, radius=1), dict(ndim=2, radius=0),
                dict(ndim=2, radius=1, boundary="mirror")):
        with pytest.raises(ValueError):
            _quiet(ref_spec.StencilSpec, **bad)
        with pytest.raises(ValueError):
            _quiet(port_spec.StencilSpec, **bad)


@pytest.mark.parametrize("ndim", [2, 3])
def test_coeff_helpers_and_directions(ndim):
    ts = _quiet(port_spec.StencilSpec, ndim=ndim, radius=2)
    c = ts.default_coeffs()
    assert c.as_tuple() == (c.center, c.neighbors)
    assert c.astype("float16").neighbors.dtype == torch.float16
    assert c.astype(torch.float64).center.dtype == torch.float64
    for d in range(6 if ndim == 3 else 4):
        assert port_spec.axis_for_direction(ndim, d) \
            == ref_spec.axis_for_direction(ndim, d)
    with pytest.raises(ValueError):
        port_spec.axis_for_direction(2, port_spec.BELOW)
    assert (port_spec.WEST, port_spec.ABOVE) == (ref_spec.WEST,
                                                 ref_spec.ABOVE)
    prog = ts.to_program()
    pc = prog.coeffs_from_legacy(c)
    assert torch.equal(pc.taps, prog.default_coeffs().taps)
    assert torch.equal(pc.center, prog.default_coeffs().center)


def test_core_exports_match_the_reference():
    import repro.core
    assert sorted(repro_torch.core.__all__) == sorted(repro.core.__all__)
    assert "pipelined_variant" in repro_torch.__all__
    assert repro_torch.pipelined_variant is pipelined_variant


# ---- the (spec, coeffs) pair in codegen, the oracle and the supersteps ----------

@pytest.mark.parametrize("ndim,boundary", [(2, "clamp"), (2, "periodic"),
                                           (3, "clamp")])
def test_legacy_pair_in_codegen_and_the_oracle(ndim, boundary):
    rs, ts, rc, tc, _, _, g = _both(ndim, boundary=boundary)
    tg = torch.from_numpy(g)
    _close(codegen.clamped_update(ts, tc, tg),
           ref_codegen.clamped_update(rs, rc, jnp.asarray(g)), ULP)
    h = 2
    sub = tg[(slice(None),) * (ndim - 1) + (slice(0, 64),)]
    _close(codegen.interior_update(ts, tc, sub),
           ref_codegen.interior_update(rs, rc, jnp.asarray(sub.numpy())),
           ULP)
    assert codegen.interior_update(ts, tc, sub).shape[-1] == 64 - 2 * h
    _close(reference.stencil_step(ts, tc, tg),
           ref_reference.stencil_step(rs, rc, jnp.asarray(g)), ULP)
    _close(reference.stencil_nsteps(ts, tc, tg, 3),
           ref_reference.stencil_nsteps(rs, rc, jnp.asarray(g), 3), ULP)
    _close(reference.stencil_nsteps_unrolled(ts, tc, tg, 3),
           ref_reference.stencil_nsteps_unrolled(rs, rc, jnp.asarray(g), 3),
           ULP)
    # the legacy pair is the program pair, bit for bit
    prog = ts.to_program()
    _close(reference.stencil_nsteps(ts, tc, tg, 3),
           reference.program_nsteps(
               prog, prog.coeffs_from_legacy(tc), tg, 3).numpy(), EXACT)


def test_random_grid_is_seeded():
    ts = _quiet(port_spec.StencilSpec, ndim=2, radius=1)
    a = reference.random_grid(ts, (8, 16), seed=3)
    b = reference.random_grid(ts, (8, 16), seed=3)
    assert a.dtype == torch.float32 and a.shape == (8, 16)
    assert torch.equal(a, b) and not torch.equal(
        a, reference.random_grid(ts, (8, 16), seed=4))
    assert float(a.min()) >= -1.0 and float(a.max()) < 1.0


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("pipelined", [False, True])
def test_legacy_pair_in_the_prepadded_supersteps(ndim, pipelined):
    rs, ts, rc, tc, rplan, tplan, g = _both(ndim, seed=1)
    tg = torch.from_numpy(g)
    ref_step = ref_ops.stencil2d_superstep if ndim == 2 \
        else ref_ops.stencil3d_superstep
    step = stencil2d_superstep if ndim == 2 else stencil3d_superstep
    want = ref_step(jnp.asarray(g), rs, rc, rplan,
                    pipelined=pipelined)  # legacy-ok
    got = step(tg, ts, tc, tplan, pipelined=pipelined)  # legacy-ok
    _close(got, want, ULP)
    prog = ts.to_program()
    low = lower(prog, tplan, coeffs=prog.coeffs_from_legacy(tc),
                backend="cuda-pipelined" if pipelined else "cuda")
    _close(got, low.superstep(tg).numpy(), EXACT)
    # stencil_superstep: the same kernel, and no warning (as the reference)
    out, caught = _deprecations(lambda: ops.stencil_superstep(
        tg, ts, tc, tplan, pipelined=pipelined))  # legacy-ok
    assert caught == []
    _close(out, got.numpy(), EXACT)


@pytest.mark.parametrize("variant,pipelined", [
    (None, False), (None, True), (True, False), (False, True),
    ("plain", False), ("pipelined", False), ("temporal", True)])
def test_normalize_variant_matches_the_reference(variant, pipelined):
    assert normalize_variant(variant, pipelined) \
        == ref_normalize_variant(variant, pipelined)


def test_normalize_variant_refuses_like_the_reference():
    with pytest.raises(ValueError, match="variant"):
        ref_normalize_variant("vectorized")
    with pytest.raises(ValueError, match="variant"):
        normalize_variant("vectorized")


def test_legacy_pair_in_the_planner_and_the_model():
    ts = _quiet(port_spec.StencilSpec, ndim=3, radius=2)
    prog = ts.to_program()
    assert BlockPlan(spec=ts, block_shape=(8, 16, 128), par_time=2) \
        == BlockPlan(spec=prog, block_shape=(8, 16, 128), par_time=2)
    grid = (64, 128, 256)
    for pipelined in (False, True):
        a = plan_blocking(ts, grid_shape=grid, max_par_time=4,
                          pipelined=pipelined)  # legacy-ok
        b = plan_blocking(prog, grid_shape=grid, max_par_time=4,
                          variant="pipelined" if pipelined else "plain")
        assert a == b
    plan = b.plan
    assert estimate(plan) == estimate(BlockPlan(spec=ts,
                                                block_shape=plan.block_shape,
                                                par_time=plan.par_time))
    assert predicted_gbps(ts, plan) == predicted_gbps(prog, plan)


# ---- the shims: StencilEngine, ops.stencil_run ------------------------------------

@pytest.mark.parametrize("ndim,boundary", [(2, "clamp"), (2, "periodic"),
                                           (3, "constant")])
def test_engine_equals_the_reference_and_the_front_door(ndim, boundary):
    rs, ts, rc, tc, rplan, tplan, g = _both(ndim, boundary=boundary)
    steps = 2 * PAR_TIME[ndim] + 1
    tg = torch.from_numpy(g)
    ref_eng = _quiet(RefEngine, spec=rs, coeffs=rc, plan=rplan)
    eng, caught = _deprecations(lambda: StencilEngine(
        spec=ts, coeffs=tc, plan=tplan, device="cpu"))
    assert len(caught) == 1 and caught[0].filename == __file__
    assert "repro_torch.stencil(program" in str(caught[0].message)
    got, caught = _deprecations(lambda: eng.run(tg, steps))
    assert caught == []
    _close(got, _quiet(ref_eng.run, jnp.asarray(g), steps), ULP)
    cs = repro_torch.stencil(ts, tc).compile(GRIDS[ndim], steps=steps,
                                             plan=tplan, device="cpu")
    _close(got, cs.run(tg).numpy(), EXACT)
    assert eng.run(tg, 0) is tg
    sup = eng.superstep(tg)
    _close(sup, ref_eng.superstep(jnp.asarray(g)), ULP)
    _close(sup, ops.stencil_superstep(tg, ts, tc, tplan).numpy(), EXACT)


def test_engine_create_memo_and_device():
    ts = _quiet(port_spec.StencilSpec, ndim=2, radius=2)
    plan = BlockPlan(spec=ts, block_shape=(16, 128), par_time=2)
    eng = _quiet(StencilEngine.create, ts, GRIDS[2], plan=plan,
                 device="cpu")
    assert eng.chip is H100_SXM
    tg = torch.from_numpy(_both(2)[-1])
    first = eng.run(tg, 5)
    before = common.trace_counts()
    again = eng.run(tg, 5)
    assert common.trace_delta(before) == {}          # the memo's hit
    assert torch.equal(first, again)
    eng.coeffs.neighbors.mul_(0.5)                   # in place: a miss
    before = common.trace_counts()
    changed = eng.run(tg, 5)
    assert common.trace_delta(before) == {"plan_resolutions": 1}
    assert not torch.equal(first, changed)
    assert eng.estimate().variant == "plain"
    with pytest.raises(DiagnosticError, match="RP110"):
        _quiet(StencilEngine, spec=ts, coeffs=eng.coeffs, plan=plan,
               device="meta").superstep(tg)
    planned = _quiet(StencilEngine.create, ts, (64, 256), device="cpu",
                     max_par_time=4)
    assert planned.plan == plan_blocking(ts, grid_shape=(64, 256),
                                         max_par_time=4).plan


@pytest.mark.parametrize("backend", [None, "cuda"])
def test_engine_pipelined_reaches_the_pipelined_kernels(backend):
    """``StencilEngine(pipelined=True)``: the pipelined sibling when a
    backend is pinned (the reference's ``lowered``), the pipelined variant
    of the run and of the superstep otherwise."""
    rs, ts, rc, tc, rplan, tplan, g = _both(2, seed=2)
    tg = torch.from_numpy(g)
    eng = _quiet(StencilEngine, spec=ts, coeffs=tc, plan=tplan,
                 device="cpu", backend=backend,
                 pipelined=True)  # legacy-ok
    ref_eng = _quiet(RefEngine, spec=rs, coeffs=rc, plan=rplan,
                     backend=None if backend is None
                     else "pallas-interpret",
                     pipelined=True)  # legacy-ok
    if backend is not None:
        assert eng.lowered().backend_name == "cuda-pipelined"
        assert ref_eng.lowered().backend_name \
            == "pallas-interpret-pipelined"
    _close(eng.superstep(tg), ref_eng.superstep(jnp.asarray(g)), ULP)
    got = eng.run(tg, 5)
    _close(got, _quiet(ref_eng.run, jnp.asarray(g), 5), ULP)
    cs = repro_torch.stencil(ts, tc).compile(
        GRIDS[2], steps=5, plan=tplan, variant="pipelined", device="cpu")
    _close(got, cs.run(tg).numpy(), EXACT)
    assert eng.estimate().variant == "pipelined"


@pytest.mark.parametrize("variant", ["plain", "pipelined", "temporal"])
@pytest.mark.parametrize("fused", [True, False])
def test_stencil_run_equals_the_reference_and_the_front_door(variant, fused):
    rs, ts, rc, tc, rplan, tplan, g = _both(2, seed=3)
    steps = 4 * 2 + 2 + 1        # a chunk, a superstep and a remainder
    tg = torch.from_numpy(g)
    got, caught = _deprecations(lambda: ops.stencil_run(
        tg, ts, tc, tplan, steps, variant=variant, fused=fused))
    assert len(caught) == 1 and caught[0].filename == __file__
    assert "stencil_run is deprecated" in str(caught[0].message)
    want = _quiet(ref_ops.stencil_run, jnp.asarray(g), rs, rc, rplan,
                  steps, variant=variant, fused=fused)
    _close(got, want, ULP)
    cs = repro_torch.stencil(ts, tc).compile(
        GRIDS[2], steps=steps, plan=tplan, variant=variant, device="cpu")
    _close(got, cs.run(tg).numpy(), EXACT)


def test_stencil_run_pipelined_bool_and_3d():
    rs, ts, rc, tc, rplan, tplan, g = _both(3, boundary="periodic", seed=4)
    tg = torch.from_numpy(g)
    got, caught = _deprecations(lambda: ops.stencil_run(
        tg, ts, tc, tplan, 3, pipelined=True))  # legacy-ok
    assert len(caught) == 1
    want = _quiet(ref_ops.stencil_run, jnp.asarray(g), rs, rc, rplan, 3,
                  pipelined=True)  # legacy-ok
    _close(got, want, ULP)
    cs = repro_torch.stencil(ts, tc).compile(
        GRIDS[3], steps=3, plan=tplan, variant="pipelined", device="cpu")
    _close(got, cs.run(tg).numpy(), EXACT)
    assert _quiet(ops.stencil_run, tg, ts, tc, tplan, 0) is tg


# ---- the pipelined= bool: compile, the server, the registry ----------------------

@pytest.mark.parametrize("pipelined,want", [(True, "pipelined"),
                                            (False, "plain")])
def test_compile_pipelined_warns_and_maps(pipelined, want):
    prog = repro_torch.StencilProgram(ndim=2, radius=2)
    plan = BlockPlan(spec=prog, block_shape=(16, 128), par_time=2)
    cs, caught = _deprecations(lambda: repro_torch.stencil(prog).compile(
        GRIDS[2], steps=3, plan=plan, device="cpu",
        pipelined=pipelined))  # legacy-ok
    assert len(caught) == 1 and caught[0].filename == __file__
    ref_cs, ref_caught = _deprecations(lambda: repro.stencil(
        repro.StencilProgram(ndim=2, radius=2)).compile(
        GRIDS[2], steps=3, plan=RefPlan(spec=repro.StencilProgram(
            ndim=2, radius=2), block_shape=(16, 128), par_time=2),
        pipelined=pipelined))  # legacy-ok
    assert str(caught[0].message) == str(ref_caught[0].message)
    assert cs.variant == want
    assert ref_cs.backend.endswith("-pipelined") == (want == "pipelined")
    g = torch.from_numpy(_both(2)[-1])
    ref = repro_torch.stencil(prog).compile(GRIDS[2], steps=3, plan=plan,
                                            variant=want, device="cpu")
    _close(cs.run(g), ref.run(g).numpy(), EXACT)


def test_rp114_matches_the_reference():
    prog = repro_torch.StencilProgram(ndim=2, radius=2)
    with pytest.raises(DiagnosticError, match="RP114") as got:
        repro_torch.stencil(prog).compile(
            GRIDS[2], steps=3, device="cpu", variant="temporal",
            pipelined=True)  # legacy-ok
    with pytest.raises(RefDiagnosticError, match="RP114") as want:
        repro.stencil(repro.StencilProgram(ndim=2, radius=2)).compile(
            GRIDS[2], steps=3, variant="temporal",
            pipelined=True)  # legacy-ok
    assert str(got.value) == str(want.value)
    with pytest.raises(DiagnosticError, match="RP114") as got:
        StencilServer(device="cpu", variant="temporal",
                      pipelined=True)  # legacy-ok
    with pytest.raises(RefDiagnosticError, match="RP114") as want:
        RefServer(variant="temporal", pipelined=True)  # legacy-ok
    assert str(got.value) == str(want.value)


def test_server_pipelined_warns_and_maps():
    server, caught = _deprecations(lambda: StencilServer(
        device="cpu", pipelined=True))  # legacy-ok
    ref_server, ref_caught = _deprecations(lambda: RefServer(
        pipelined=True))  # legacy-ok
    assert len(caught) == len(ref_caught) == 1
    assert caught[0].filename == __file__
    assert (server.variant, server.pipelined) \
        == (ref_server.variant, ref_server.pipelined) == ("pipelined", True)
    quiet, caught = _deprecations(lambda: StencilServer(device="cpu"))
    assert caught == [] and (quiet.variant, quiet.pipelined) == (None, False)


@pytest.mark.parametrize("ref_name,port_name", [
    ("pallas-interpret", "cuda"),
    ("pallas-interpret-pipelined", "cuda-pipelined"),
    ("pallas-interpret-temporal", "cuda-temporal"),
    ("xla-reference", "torch-reference"),
])
def test_pipelined_variant_maps_the_port_names(ref_name, port_name):
    want = ref_pipelined_variant(ref_name)
    got = pipelined_variant(port_name)
    assert (got is None) == (want is None)
    if got is not None:
        assert got == "cuda-pipelined" and want.endswith("-pipelined")


def test_resolve_backend_pipelined():
    assert resolve_backend(
        "cuda", pipelined=True)[0] == "cuda-pipelined"  # legacy-ok
    assert resolve_backend(
        pipelined=True)[0] == "cuda-pipelined"  # legacy-ok
    assert resolve_backend(
        "cuda", pipelined=False)[0] == "cuda"  # legacy-ok
    assert ref_resolve_backend(
        "pallas-interpret",
        pipelined=True)[0].endswith("-pipelined")  # legacy-ok
    # the variant wins over the bool, as in the reference
    assert resolve_backend("cuda", variant="temporal",
                           pipelined=True)[0] == "cuda-temporal"  # legacy-ok
    with pytest.raises(ValueError, match="no pipelined lowering"):
        resolve_backend("torch-reference", pipelined=True)  # legacy-ok
    with pytest.raises(ValueError, match="no pipelined lowering"):
        ref_resolve_backend("xla-reference", pipelined=True)  # legacy-ok


def test_convert_carries_the_legacy_coefficients():
    rs = _quiet(ref_spec.StencilSpec, ndim=3, radius=3)
    ts = _quiet(port_spec.StencilSpec, ndim=3, radius=3)
    rc = rs.default_coeffs(seed=7)
    tc = convert.spec_coeffs_from_numpy(np.asarray(rc.center),
                                        np.asarray(rc.neighbors))
    want = ts.default_coeffs(seed=7)
    assert torch.equal(tc.center, want.center)
    assert torch.equal(tc.neighbors, want.neighbors)
    assert tc.neighbors.shape == (6, 3)
