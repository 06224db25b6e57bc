"""16-bit grids (bfloat16, float16) in the port against the reference.

The same inputs, drawn with numpy from a seed, go through the JAX package
(its Pallas kernels in interpret mode) and the port on the CPU (the
kernels' plain versions), through the front door under every variant and
through ``lower(...).superstep``.  In bfloat16 the two agree at 0: torch's
eager operations and XLA's CPU code both round to bfloat16 after every
multiply and every add.  In float16 XLA's CPU code keeps some sums in
float32, so the two differ by about one float16 ulp near 1 (measured at
most 7.3e-4); the tolerance is 2e-3.  Both are held to the float64 oracle
at the reference's own bfloat16 tolerance, 3e-2
(``tests/test_kernels_2d.py:test_dtype_sweep``).

Also here: the coefficients (values and dtypes) against the reference's,
fault C3 (a bfloat16 program compiles and runs; float64 is RP109 and never
a ``TypeError``), the verifier's 16-bit sizes, the served and mesh runs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.backends import lower as ref_lower
from repro.core.blocking import BlockPlan as RefPlan
from repro.core.program import StencilProgram as RefProgram

import repro_torch
from repro_torch import convert
from repro_torch.analysis.hw import H100_SXM
from repro_torch.backends import lower
from repro_torch.core.blocking import TEMPORAL_CHUNK
from repro_torch.core.program import DTYPES, ProgramCoeffs, dtype_bytes
from repro_torch.core.reference import program_nsteps
from repro_torch.kernels import common
from repro_torch.lint.diagnostics import DiagnosticError
from repro_torch.lint.verify import smem_diagnostics, verify

#: port against the JAX package, by dtype (module docstring)
TOL = {"bfloat16": dict(atol=0.0, rtol=0.0),
       "float16": dict(atol=2e-3, rtol=2e-3)}
#: either against the float64 oracle (the reference's bfloat16 tolerance)
ORACLE_TOL = dict(atol=3e-2, rtol=3e-2)

#: (name, program fields, grid, block, par_time, steps): the configurations
#: of the CPU measurement that set the tolerances, on smaller 2D grids; a
#: temporal run takes a chunk and a remainder (:func:`_steps`)
CONFIGS = [
    ("2d-star-r2-clamp", dict(ndim=2, radius=2), (16, 256), (16, 128), 2, 4),
    ("2d-box-r1-periodic", dict(ndim=2, radius=1, shape="box",
                                boundary="periodic"),
     (16, 256), (16, 128), 2, 5),
    ("3d-star-r1-periodic", dict(ndim=3, radius=1, boundary="periodic"),
     (8, 16, 128), (8, 16, 128), 1, 3),
    ("3d-diamond-r2-constant", dict(ndim=3, radius=2, shape="diamond",
                                    boundary="constant",
                                    boundary_value=0.3),
     (8, 16, 128), (8, 16, 128), 1, 2),
]


def _steps(variant, par_time, steps):
    """A temporal run launches one chunk of ``TEMPORAL_CHUNK * par_time``
    steps and a remainder; the others run ``steps``."""
    return TEMPORAL_CHUNK * par_time + 1 if variant == "temporal" else steps


def _both(fields, block, par_time, dtype, seed=1):
    rp = RefProgram(dtype=dtype, **fields)
    rplan = RefPlan(spec=rp, block_shape=block, par_time=par_time)
    rc = rp.default_coeffs(seed)
    tp = convert.program_from_fields(**dataclasses.asdict(rp))
    tplan = convert.plan_from_fields(**dataclasses.asdict(rplan))
    tc = convert.coeffs_from_numpy(np.asarray(rc.center), np.asarray(rc.taps))
    return rp, rplan, rc, tp, tplan, tc


def _grid(shape, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _oracle(tp, tc, g, steps):
    """The float64 oracle on the 16-bit input and the coefficients rounded
    to the grid's dtype (what both packages compute with)."""
    dt = DTYPES[tp.dtype]
    c64 = ProgramCoeffs(tc.center.to(dt).double(), tc.taps.to(dt).double())
    return program_nsteps(tp, c64, torch.from_numpy(g).to(dt).double(),
                          steps)


def _check(got, want, oracle, dtype):
    got = got.double()
    want = torch.from_numpy(np.asarray(want, np.float64))
    torch.testing.assert_close(got, want, **TOL[dtype])
    torch.testing.assert_close(got, oracle, **ORACLE_TOL)
    torch.testing.assert_close(want, oracle, **ORACLE_TOL)


# ---- coefficients ----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("shape,ndim,radius", [
    ("star", 2, 4), ("star", 3, 2), ("box", 2, 2), ("box", 3, 1),
    ("diamond", 2, 3), ("diamond", 3, 2)])
@pytest.mark.parametrize("sharing", ["pertap", "distance"])
def test_default_coeffs_equal_the_reference(dtype, shape, ndim, radius,
                                            sharing):
    """Values and dtypes, at several seeds: the center in the grid's
    dtype, the taps too but float32 for bfloat16 (numpy's promotion in the
    reference)."""
    kw = dict(ndim=ndim, radius=radius, shape=shape, coeff_sharing=sharing,
              dtype=dtype)
    for seed in (0, 1, 7, 42):
        rc = RefProgram(**kw).default_coeffs(seed)
        tc = repro_torch.StencilProgram(**kw).default_coeffs(seed)
        for r, t in ((rc.center, tc.center), (rc.taps, tc.taps)):
            r = np.asarray(r)
            assert str(t.dtype) == f"torch.{r.dtype.name}"
            np.testing.assert_array_equal(t.double().numpy(),
                                          r.astype(np.float64))
    assert tc.taps.dtype == (torch.float32 if dtype == "bfloat16"
                             else torch.float16)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_coeffs_from_numpy_carries_the_reference_dtypes(dtype):
    """The reference's arrays (``ml_dtypes`` bfloat16 included) cross with
    their dtypes and values."""
    rc = RefProgram(ndim=2, radius=3, dtype=dtype).default_coeffs(3)
    tc = convert.coeffs_from_numpy(np.asarray(rc.center),
                                   np.asarray(rc.taps))
    for r, t in ((rc.center, tc.center), (rc.taps, tc.taps)):
        r = np.asarray(r)
        assert str(t.dtype) == f"torch.{r.dtype.name}"
        assert t.shape == r.reshape(t.shape).shape
        np.testing.assert_array_equal(t.double().numpy(),
                                      r.astype(np.float64))


def test_dtype_table():
    assert {n: dtype_bytes(n) for n in DTYPES} == \
        {"float32": 4, "bfloat16": 2, "float16": 2}
    for dtype in DTYPES:
        p = repro_torch.StencilProgram(ndim=2, radius=1, dtype=dtype)
        assert p.bytes_per_cell == RefProgram(
            ndim=2, radius=1, dtype=dtype).bytes_per_cell


# ---- port against the JAX package ------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("config", CONFIGS, ids=[c[0] for c in CONFIGS])
@pytest.mark.parametrize("variant", ["plain", "temporal", "pipelined"])
def test_front_door_equals_the_reference(dtype, config, variant):
    """The same 16-bit grid through both front doors, the result in the
    grid's dtype; temporal at par_time 1, a chunk of 4 steps and one
    more."""
    _, fields, grid, block, par_time, steps = config
    if variant == "temporal":
        par_time = 1
    steps = _steps(variant, par_time, steps)
    rp, rplan, rc, tp, tplan, tc = _both(fields, block, par_time, dtype)
    g = _grid(grid)
    want = repro.stencil(rp, rc).compile(
        grid, steps=steps, plan=rplan, variant=variant,
        interpret=True).run(jnp.asarray(g).astype(dtype))
    cs = repro_torch.stencil(tp, tc).compile(grid, steps=steps, plan=tplan,
                                             variant=variant, device="cpu")
    got = cs.run(torch.from_numpy(g).to(DTYPES[dtype]))
    assert got.dtype == DTYPES[dtype] and str(want.dtype) == dtype
    _check(got, np.asarray(want, np.float32), _oracle(tp, tc, g, steps),
           dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("config", CONFIGS[:2] + CONFIGS[3:],
                         ids=[c[0] for c in CONFIGS[:2] + CONFIGS[3:]])
@pytest.mark.parametrize("backend", ["cuda", "cuda-pipelined"])
def test_lowered_superstep_equals_the_reference(dtype, config, backend):
    """``lower(...).superstep`` (B5, B6's plain version) against the
    reference's interpret-mode Pallas superstep (plain, pipelined)."""
    _, fields, grid, block, par_time, _ = config
    rp, rplan, rc, tp, tplan, tc = _both(fields, block, par_time, dtype)
    g = _grid(grid, seed=2)
    ref_backend = "pallas-interpret" if backend == "cuda" \
        else "pallas-interpret-pipelined"
    want = ref_lower(rp, rplan, coeffs=rc, backend=ref_backend).superstep(
        jnp.asarray(g).astype(dtype))
    got = lower(tp, tplan, coeffs=tc, backend=backend).superstep(
        torch.from_numpy(g).to(DTYPES[dtype]))
    assert got.dtype == DTYPES[dtype]
    _check(got, np.asarray(want, np.float32), _oracle(tp, tc, g, par_time),
           dtype)


# ---- fault C3 ----------------------------------------------------------------

def test_c3_bfloat16_program_compiles_and_runs():
    """ROADMAP C3's configuration: 2D star r2 clamp in bfloat16, grid
    (32, 256), block (16, 128), par_time 2, 4 steps on the CPU, each
    package's default coefficients; equal to the reference at 0."""
    rp, rplan, rc, tp, tplan, tc = _both(dict(ndim=2, radius=2), (16, 128),
                                         2, "bfloat16")
    cs = repro_torch.stencil(tp).compile((32, 256), steps=4, plan=tplan,
                                         device="cpu")
    g = _grid((32, 256), seed=5)
    got = cs.run(torch.from_numpy(g).to(torch.bfloat16))
    want = repro.stencil(rp).compile((32, 256), steps=4, plan=rplan,
                                     interpret=True).run(
        jnp.asarray(g).astype("bfloat16"))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    with pytest.raises(DiagnosticError, match="RP109"):
        cs.run(torch.from_numpy(g))             # a float32 grid


@pytest.mark.parametrize("plan", ["auto", "model", "pinned"])
def test_float64_is_rp109_and_never_a_type_error(plan):
    p64 = repro_torch.StencilProgram(ndim=2, radius=2, dtype="float64")
    assert p64.bytes_per_cell == 16
    pinned = repro_torch.BlockPlan(spec=p64, block_shape=(16, 128),
                                   par_time=2)
    with pytest.raises(DiagnosticError, match="RP109") as info:
        repro_torch.stencil(p64).compile(
            (32, 256), steps=4, device="cpu",
            plan=pinned if plan == "pinned" else plan)
    assert [d.code for d in info.value.diagnostics] == ["RP109"]
    assert "bfloat16" in info.value.diagnostics[0].hint
    codes = [d.code for d in verify(p64, pinned, (32, 256), H100_SXM,
                                    steps=4)]
    assert codes == ["RP109"]


# ---- the verifier's 16-bit sizes ------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("variant", ["plain", "pipelined", "temporal"])
def test_byte_model_equals_the_reference(dtype, variant):
    """Bytes per cell and the HBM bytes of a block and of a superstep, the
    quantities the two packages count alike, at 2 bytes a cell."""
    rp, rplan, _, tp, tplan, _ = _both(dict(ndim=3, radius=2), (8, 16, 128),
                                       2, dtype)
    assert tp.bytes_per_cell == rp.bytes_per_cell == 4
    assert tplan.itemsize == 2
    assert tplan.hbm_bytes_per_block() == rplan.hbm_bytes_per_block()
    assert tplan.run_bytes_per_superstep((20, 40, 300), variant) == \
        rplan.run_bytes_per_superstep((20, 40, 300), variant)


@pytest.mark.parametrize("shape,ndim,radius,par_time,variant", [
    ("star", 2, 4, 2, "plain"), ("star", 3, 4, 1, "plain"),
    ("box", 3, 2, 2, "temporal"), ("star", 3, 2, 3, "pipelined"),
    ("diamond", 3, 3, 4, "temporal")])
def test_rp105_sizes_shared_memory_by_the_cell(shape, ndim, radius,
                                               par_time, variant):
    """Each kernel's smallest-tile shared memory in 16 bits is below its
    float32 count, its planes 2 bytes a cell; RP105 fires exactly where
    the count passes the card's limit, for each dtype."""
    from repro_torch.kernels import cuda
    for dtype in ("float32", "bfloat16"):
        prog = repro_torch.StencilProgram(ndim=ndim, radius=radius,
                                          shape=shape, dtype=dtype)
        plan = repro_torch.BlockPlan(spec=prog, block_shape=(8, 16, 128)[
            3 - ndim:], par_time=par_time)
        over = False
        for kernel, kplan in common.run_kernels(prog, plan, None, None,
                                                variant):
            need = kplan.smem_bytes_for(cuda.smallest_tile(kplan, kernel),
                                        kernel)
            f32 = dataclasses.replace(
                kplan, spec=dataclasses.replace(prog, dtype="float32"))
            if dtype == "bfloat16":
                assert need < f32.smem_bytes_for(
                    cuda.smallest_tile(f32, kernel), kernel)
            over |= need > H100_SXM.smem_optin
        assert bool(smem_diagnostics(plan, variant, H100_SXM)) == over


@pytest.mark.parametrize("ndim,radius,steps,f32,f16", [
    (2, 4, 1, "queue", "queue"), (2, 4, 2, "queue", "queue"),
    (2, 3, 2, "queue", "queue"), (2, 3, 1, "queue", "queue"),
    (3, 4, 1, "queue", "queue"), (3, 3, 2, "queue", "queue"),
    (3, 1, 4, "queue", "queue"), (3, 4, 2, "streamed", "streamed")])
def test_16_bit_stars_take_the_queues_that_fit(ndim, radius, steps, f32,
                                               f16):
    """A 16-bit grid has float32's register queues (``QUEUE_STEPS``, one
    table): its packed pairs take half the queue registers, so radius 4
    and radius 3 at 2 steps no longer spill; past the table (3D radius 4
    at 2 steps) every dtype runs the streamed body."""
    from repro_torch.core.blocking import kernel_body
    for dtype, want in (("float32", f32), ("bfloat16", f16),
                        ("float16", f16)):
        prog = repro_torch.StencilProgram(ndim=ndim, radius=radius,
                                          dtype=dtype)
        for kernel in ("padded_superstep", "superstep",
                       "pipelined_superstep"):
            assert kernel_body(prog, kernel, steps) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape,ndim,radius", [("star", 2, 4),
                                               ("star", 3, 4),
                                               ("box", 2, 2)])
def test_coefficient_bank_layout(dtype, shape, ndim, radius):
    """The coefficients as the kernels read them
    (``cuda.coefficient_bank``): ``common.grid_coeffs`` in canonical
    order, float32 for a float32 grid; for a 16-bit grid each coefficient
    twice, so that 32-bit entry k holds (c_k, c_k) with c_k in its low
    half as a lane's first cell (``csrc/elem.cuh``), bit for bit the
    reference's cast of the same values to the grid's dtype."""
    from repro_torch.kernels import cuda
    prog = repro_torch.StencilProgram(ndim=ndim, radius=radius, shape=shape,
                                      dtype=dtype)
    coeffs = prog.default_coeffs(seed=3)
    grid = torch.zeros((4,) * ndim, dtype=DTYPES[dtype])
    center, taps = common.grid_coeffs(coeffs.center, coeffs.taps, grid)
    want = torch.cat([center.reshape(1), taps.reshape(-1)])
    bank = cuda.coefficient_bank(coeffs.center, coeffs.taps, grid)
    assert bank.dtype == grid.dtype and bank.is_contiguous()
    ref = np.asarray(jnp.asarray(
        np.concatenate([np.asarray(coeffs.center.float()).reshape(1),
                        np.asarray(coeffs.taps.float()).reshape(-1)]),
        dtype=getattr(jnp, dtype)).astype(np.float32))
    np.testing.assert_array_equal(want.float().numpy(), ref)
    if dtype == "float32":
        assert torch.equal(bank, want)
        return
    assert bank.numel() == 2 * prog.num_taps
    assert torch.equal(bank[0::2], want) and torch.equal(bank[1::2], want)
    words = bank.view(torch.int32).long() & 0xFFFFFFFF
    bits = want.view(torch.int16).long() & 0xFFFF
    assert torch.equal(words & 0xFFFF, bits)
    assert torch.equal(words >> 16, bits)


def test_queued_planes_at_two_bytes():
    """A 16-byte copy is 8 cells: the x shift is 8..15, the pitch the
    stage-0 extent rounded to 8 plus 24, planes of 2-byte cells."""
    from repro_torch.core.blocking import QueuedPlanes
    from repro_torch.kernels import queued
    q = QueuedPlanes(ndim=3, radius=4, steps=2, tile=(16, 32), itemsize=2)
    assert q.extent == (32, 48) and q.pitch == 48 + 24
    assert q.bytes() == 2 * (q.plane * q.planes + 16) + 8 * q.groups
    assert list(q.pads) == list(range(8, 16))
    assert [queued.x_shift(o, 8, 2) for o in range(8, 24)] == \
        list(range(8, 16)) * 2
    rows, nx, first = q.strips(15)
    assert 4 * first - 4 >= 0 and 4 * (first + nx) + 4 <= q.pitch + 3 * 8


# ---- the rest of the path ---------------------------------------------------

def test_served_bfloat16_request_comes_back_in_bfloat16():
    """A float32 request of a bfloat16 program is cast to bfloat16 (the
    reference casts it), served in bfloat16, equal to a direct run under
    the server's plan at 0; a numpy bfloat16 array is taken too."""
    import ml_dtypes
    from repro_torch.launch.stencil_serve import StencilServer
    from repro_torch.tuning.cache import program_fingerprint
    prog = repro_torch.StencilProgram(ndim=2, radius=2, dtype="bfloat16")
    g = _grid((32, 256), seed=6)
    server = StencilServer(max_batch=2, device="cpu")
    rids = [server.submit(prog, g, 3),
            server.submit(prog, g.astype(ml_dtypes.bfloat16), 3)]
    out = server.flush()
    assert not server.failed
    plan, backend = server._resolved[(program_fingerprint(prog), (32, 256))]
    want = repro_torch.stencil(prog).compile(
        (32, 256), steps=3, plan=plan, backend=backend, device="cpu").run(
        torch.from_numpy(g).to(torch.bfloat16))
    for rid in rids:
        assert out[rid].dtype == torch.bfloat16
        torch.testing.assert_close(out[rid], want, rtol=0, atol=0)


@pytest.mark.parametrize("variant", ["plain", "pipelined"])
def test_bfloat16_mesh_equals_the_single_device(monkeypatch, variant):
    """Four CPU mesh devices on a bfloat16 grid: equal to one device at 0,
    in bfloat16."""
    monkeypatch.setenv("REPRO_TORCH_FORCE_DEVICE_COUNT", "4")
    prog = repro_torch.StencilProgram(ndim=2, radius=2, boundary="clamp",
                                      dtype="bfloat16")
    plan = repro_torch.BlockPlan(spec=prog, block_shape=(16, 64),
                                 par_time=2)
    g = torch.from_numpy(_grid((64, 256), seed=7)).to(torch.bfloat16)
    mesh = repro_torch.stencil(prog).compile(
        (64, 256), steps=5, plan=plan, devices=(2, 2), variant=variant,
        device="cpu")
    one = repro_torch.stencil(prog).compile(
        (64, 256), steps=5, plan=plan, variant=variant, device="cpu")
    got = mesh.run(g)
    assert mesh.describe() == "mesh 2x2" and got.dtype == torch.bfloat16
    torch.testing.assert_close(got, one.run(g), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_canary_in_16_bits_is_clean(dtype):
    """The NaN canary builds its carry in the program's dtype: clean, and
    equal to the front door's run at 0."""
    from repro_torch.lint import sanitize_run
    from repro_torch.lint.sanitize import SENTINEL, canary_grid
    assert torch.tensor(SENTINEL, dtype=DTYPES[dtype]).item() == SENTINEL
    prog = repro_torch.StencilProgram(ndim=2, radius=2, boundary="periodic",
                                      dtype=dtype)
    plan = repro_torch.BlockPlan(spec=prog, block_shape=(16, 128),
                                 par_time=2)
    report = sanitize_run(prog, plan, (37, 150), steps=5, device="cpu")
    assert report.ok and report.interior.dtype == DTYPES[dtype]
    cs = repro_torch.stencil(prog, prog.default_coeffs(0)).compile(
        (37, 150), steps=5, plan=plan, device="cpu")
    g = torch.from_numpy(canary_grid((37, 150))).to(DTYPES[dtype])
    torch.testing.assert_close(report.interior, cs.run(g), rtol=0, atol=0)


@pytest.mark.parametrize("plan", ["model", "auto"])
def test_planned_bfloat16_run_equals_the_pinned_run(tmp_path, plan):
    """The planner prices 2-byte cells on its own calibration rows; the
    planned run equals a pinned run at 0 (bfloat16 rounds every step the
    same way whatever the blocking)."""
    prog = repro_torch.StencilProgram(ndim=2, radius=4, dtype="bfloat16")
    cs = repro_torch.stencil(prog).compile(
        (64, 512), steps=5, plan=plan, device="cpu",
        cache_path=str(tmp_path / "plans.json"))
    assert cs.plan.itemsize == 2
    pinned = repro_torch.stencil(prog).compile(
        (64, 512), steps=5, device="cpu", plan=repro_torch.BlockPlan(
            spec=prog, block_shape=(64, 512), par_time=1))
    g = torch.from_numpy(_grid((64, 512), seed=8)).to(torch.bfloat16)
    torch.testing.assert_close(cs.run(g), pinned.run(g), rtol=0, atol=0)
