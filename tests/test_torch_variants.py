"""The kernel-variant and pre-padded superstep surfaces of the port against
the reference: ``compile(variant=...)`` runs, ``ops.stencil_superstep``,
``common.superstep_call`` with shard offsets, the eager chain, and the
shared-memory pre-flight (RP105).

The port runs on the CPU (``device="cpu"``: the kernels' plain versions);
the reference runs its Pallas kernels in interpret mode.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core import reference as ref
from repro.core.blocking import BlockPlan as RefPlan
from repro.core.codegen import boundary_pad as ref_boundary_pad
from repro.core.program import StencilProgram as RefProgram
from repro.kernels import common as ref_common
from repro.kernels import ops as ref_ops

import repro_torch
from repro_torch import convert
from repro_torch.analysis.hw import H100_SXM
from repro_torch.configs import stencil3d
from repro_torch.core.blocking import TEMPORAL_CHUNK
from repro_torch.core.codegen import boundary_pad
from repro_torch.kernels import common, cuda, ops, streamed
from repro_torch.lint.verify import smem_diagnostics

TOL = dict(atol=5e-4, rtol=5e-4)
ULP = dict(atol=1e-6, rtol=1e-5)

BLOCKS = {2: (16, 128), 3: (8, 16, 128)}
#: non-divisible by the blocks; the 3D grid keeps the temporal ring one-lap,
#: so periodic runs the carry path
GRIDS = {2: (37, 150), 3: (20, 32, 140)}
#: par_time 1 in 3D keeps the interpret-mode reference quick
PAR_TIME = {2: 2, 3: 1}


def steps_of(ndim):
    """A chunk, a full superstep and a short remainder under temporal;
    full supersteps and a remainder otherwise."""
    return TEMPORAL_CHUNK * PAR_TIME[ndim] + PAR_TIME[ndim] + 1


def _both(ndim, boundary, radius=2, shape="box", par_time=None, seed=0):
    rp = RefProgram(ndim=ndim, radius=radius, shape=shape, boundary=boundary,
                    boundary_value=0.25)
    rplan = RefPlan(spec=rp, block_shape=BLOCKS[ndim],
                    par_time=par_time or PAR_TIME[ndim])
    rc = rp.default_coeffs(seed=seed)
    tp = convert.program_from_fields(**dataclasses.asdict(rp))
    tplan = convert.plan_from_fields(**dataclasses.asdict(rplan))
    tc = convert.coeffs_from_numpy(np.asarray(rc.center), np.asarray(rc.taps))
    return rp, rplan, rc, tp, tplan, tc


def _grid(shape, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("boundary", ["clamp", "periodic", "constant"])
@pytest.mark.parametrize("variant", ["pipelined", "temporal"])
def test_front_door_variant_matches_reference(ndim, boundary, variant):
    rp, rplan, rc, tp, tplan, tc = _both(ndim, boundary, seed=ndim)
    shape = GRIDS[ndim]
    steps = steps_of(ndim)
    assert not common.ring_schedule(tp, tplan, shape, steps,
                                    variant=variant).fallback
    g = _grid(shape, seed=ndim)
    want = repro.stencil(rp, rc).compile(
        shape, steps=steps, plan=rplan, variant=variant).run(g)
    cs = repro_torch.stencil(tp, tc).compile(
        shape, steps=steps, plan=tplan, variant=variant, device="cpu")
    assert (cs.variant, cs.backend, cs.backend_version) == \
        (variant, f"cuda-{variant}", 1)
    got = cs.run(torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **ULP)
    np.testing.assert_allclose(got, ref.numpy_program_nsteps(rp, rc, g,
                                                             steps), **TOL)


@pytest.mark.parametrize("variant", ["plain", "pipelined", "temporal"])
def test_batched_variant_matches_reference(variant):
    rp, rplan, rc, tp, tplan, tc = _both(2, "periodic", shape="star")
    g = _grid((2,) + GRIDS[2], seed=5)
    want = repro.stencil(rp, rc).compile(
        GRIDS[2], steps=steps_of(2), batch=2, plan=rplan,
        variant=variant).run(g)
    got = repro_torch.stencil(tp, tc).compile(
        GRIDS[2], steps=steps_of(2), batch=2, plan=tplan, variant=variant,
        device="cpu").run(torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ULP)


@pytest.mark.parametrize("variant", ["plain", "pipelined", "temporal"])
def test_wrap_degenerate_variant_matches_reference(variant):
    """A periodic axis smaller than the round-up slack re-pads every
    superstep: B5 (B6 for pipelined; temporal as the chunk-deep plan on
    the plain kernel).  Ring depth 4 (plain, pipelined) or 8 (temporal at
    par_time 1) against axis 0's 9 cells rounded to 16."""
    rp, rplan, rc, tp, tplan, tc = _both(
        3, "periodic", par_time=1 if variant == "temporal" else 2)
    shape = (9, 18, 140)
    assert common.ring_schedule(tp, tplan, shape, 6,
                                variant=variant).fallback
    g = _grid(shape, seed=3)
    want = repro.stencil(rp, rc).compile(shape, steps=6, plan=rplan,
                                         variant=variant).run(g)
    got = repro_torch.stencil(tp, tc).compile(
        shape, steps=6, plan=tplan, variant=variant,
        device="cpu").run(torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ULP)
    np.testing.assert_allclose(got.numpy(),
                               ref.numpy_program_nsteps(rp, rc, g, 6), **TOL)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("variant", ["plain", "pipelined", "temporal"])
def test_stencil_superstep_matches_reference(ndim, variant):
    """One pre-padded superstep per variant, batch 2 in 2D; temporal
    demotes to the plain kernel bit for bit on both sides."""
    rp, rplan, rc, tp, tplan, tc = _both(ndim, "clamp", seed=ndim)
    lead = (2,) if ndim == 2 else ()
    g = _grid(lead + GRIDS[ndim], seed=ndim)
    want = ref_ops.stencil_superstep(g, rp, rc, rplan, interpret=True,
                                     variant=variant)
    got = ops.stencil_superstep(torch.from_numpy(g), tp, tc, tplan,
                                variant=variant)
    assert got.shape == g.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ULP)
    if variant == "temporal":
        plain = ops.stencil_superstep(torch.from_numpy(g), tp, tc, tplan,
                                      variant="plain")
        assert torch.equal(got, plain)
    one = g if ndim == 3 else g[1]
    np.testing.assert_allclose(got.numpy() if ndim == 3 else got.numpy()[1],
                               ref.numpy_program_nsteps(rp, rc, one,
                                                        PAR_TIME[ndim]),
                               **TOL)


@pytest.mark.parametrize("boundary", ["clamp", "constant", "periodic"])
@pytest.mark.parametrize("variant", ["plain", "pipelined"])
def test_superstep_call_with_offsets_matches_reference(boundary, variant):
    """A shard's pre-padded window of a global grid (origin (16, 128)):
    the rounded output equals the reference's, cell for cell, and its
    cells equal the whole-grid oracle's."""
    rp, rplan, rc, tp, tplan, tc = _both(2, boundary, seed=7)
    G = (40, 300)
    offs = (16, 128)
    local = BLOCKS[2]
    h = tplan.halo
    g = _grid(G, seed=7)
    full = np.asarray(ref_boundary_pad(rp, jnp.asarray(g), h))
    window = np.ascontiguousarray(
        full[offs[0]:offs[0] + local[0] + 2 * h,
             offs[1]:offs[1] + local[1] + 2 * h])
    want = ref_common.superstep_call(
        jnp.asarray(window), rc.center, rc.taps, rp, rplan, G, True,
        jnp.asarray(offs, jnp.int32), variant=variant)
    got = common.superstep_call(torch.from_numpy(window), tc.center,
                                tc.taps, program=tp, plan=tplan,
                                true_shape=G, offsets=offs, variant=variant)
    assert tuple(got.shape) == local
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ULP)
    oracle = ref.numpy_program_nsteps(rp, rc, g, PAR_TIME[2])
    np.testing.assert_allclose(
        got.numpy(), oracle[offs[0]:offs[0] + local[0],
                            offs[1]:offs[1] + local[1]], **TOL)
    temporal = common.superstep_call(
        torch.from_numpy(window), tc.center, tc.taps, program=tp,
        plan=tplan, true_shape=G, offsets=offs, variant="temporal")
    if variant == "plain":
        assert torch.equal(temporal, got)


def test_superstep_call_rounds_up_like_reference():
    """Single device: the rounded grid (slack included) equals the
    reference's, and the port's own pad matches ``jnp.pad`` semantics."""
    rp, rplan, rc, tp, tplan, tc = _both(3, "clamp", seed=2)
    shape = (9, 18, 140)
    h = tplan.halo
    rounded = tuple(ref_common.round_up(s, b)
                    for s, b in zip(shape, BLOCKS[3]))
    pad = [(h, r - s + h) for s, r in zip(shape, rounded)]
    g = _grid(shape, seed=2)
    padded = boundary_pad(tp, torch.from_numpy(g), pad)
    rpadded = ref_boundary_pad(rp, jnp.asarray(g), pad)
    np.testing.assert_array_equal(padded.numpy(), np.asarray(rpadded))
    want = ref_common.superstep_call(rpadded, rc.center, rc.taps, rp, rplan,
                                     shape, True)
    got = common.superstep_call(padded, tc.center, tc.taps, program=tp,
                                plan=tplan, true_shape=shape)
    assert tuple(got.shape) == rounded
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ULP)


@pytest.mark.parametrize("variant", ["plain", "pipelined", "temporal"])
def test_eager_chain_matches_reference(variant):
    """``fused=False``: one pre-padded superstep per launch (temporal: the
    chunk-deep plan on the plain kernel), against the reference's chain
    and the port's fused run."""
    rp, rplan, rc, tp, tplan, tc = _both(2, "constant", seed=4)
    g = _grid(GRIDS[2], seed=4)
    steps = steps_of(2)
    want = ref_ops._stencil_run(g, rp, rc, rplan, steps, interpret=True,
                                variant=variant, fused=False)
    got = ops._stencil_run(torch.from_numpy(g), tp, tc, tplan, steps,
                           variant=variant, fused=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ULP)
    fused = ops._stencil_run(torch.from_numpy(g), tp, tc, tplan, steps,
                             variant=variant)
    np.testing.assert_allclose(got.numpy(), fused.numpy(), **ULP)


def test_run_call_padfallback_refuses_temporal():
    _, _, _, tp, tplan, tc = _both(3, "periodic")
    g = torch.zeros((9, 18, 140))
    with pytest.raises(ValueError, match="chunk-deep plan"):
        common.run_call_padfallback(g, tc.center, tc.taps, 1, program=tp,
                                    plan=tplan, rem=0, variant="temporal")


def test_smem_check_refuses_what_no_tile_fits():
    """RP105 with the H100 default, per kernel the run launches.  The
    paper's 3D temporal plans fit B3 (its plane rings shrink with the
    stages): 3D star r4 at 4 fused steps and r2 at 8 both at the column
    tile (2, 32).  B1 streams planes too, so its long remainders fit: a
    temporal 3d_r4_paper run of 3 steps (a B1 remainder of 3 steps of
    radius 4, on the streamed kernel: the whole window needed 313,800
    bytes even at (1, 4, 32)) and one of unknown steps now compile.  A 3D
    box of radius 2 at 8 fused steps still fits no column tile (its
    offset tables)."""
    work = stencil3d.workloads()["3d_r4_paper"]
    plan = work.plan()
    for steps in (None, 3, 9):
        assert smem_diagnostics(plan, "temporal", H100_SXM,
                                grid_shape=work.grid_shape,
                                steps=steps) == []
    assert smem_diagnostics(plan, "plain", H100_SXM) == []
    assert smem_diagnostics(plan, "pipelined", H100_SXM) == []
    r2 = stencil3d.workloads()["3d_r2_paper"].plan()
    assert r2.par_time == 2
    assert smem_diagnostics(r2, "temporal", H100_SXM,
                            grid_shape=(512, 1024, 704), steps=9) == []
    # unknown steps: the longest remainder, 7 steps of radius 2 in B1
    assert smem_diagnostics(r2, "temporal") == []
    r2_one = dataclasses.replace(r2, par_time=1)
    assert smem_diagnostics(r2_one, "temporal") == []
    # the kernels' own tile picks agree with the pre-flight
    for p in (plan, r2):
        tile = cuda.pick_tile(p, "temporal_superstep", H100_SXM.smem_optin)
        assert tile == (2, 32)
        assert p.smem_bytes_for(tile, "temporal_superstep") <= \
            H100_SXM.smem_optin
    three = dataclasses.replace(plan, par_time=3)
    tile = cuda.pick_tile(three, "padded_superstep", H100_SXM.smem_optin)
    assert tile == streamed.pick_streamed_tile(three.program, 3,
                                               H100_SXM.smem_optin)
    assert three.smem_bytes_for(tile, "padded_superstep") <= \
        H100_SXM.smem_optin
    box = dataclasses.replace(r2, spec=dataclasses.replace(
        r2.spec, shape="box"))
    found = smem_diagnostics(box, "temporal", H100_SXM,
                             grid_shape=(512, 1024, 704), steps=9)
    assert [d.code for d in found] == ["RP105"]
    assert "temporal_superstep (8 fused steps" in found[0].message
    assert "240924 bytes" in found[0].message
    assert "padded_superstep" not in found[0].message
    with pytest.raises(ValueError, match="no CTA tile fits"):
        cuda.pick_tile(box, "temporal_superstep", H100_SXM.smem_optin)


def test_smem_bytes_for_counts_windows_by_variant():
    """Every kernel counts the body it runs (``BlockPlan.body``): B3 and
    B4 the plane rings of the streamed kernel (``blocking.streamed_rings``),
    and so do B1, B5 and B6 for a box; for a star within ``QUEUE_STEPS``
    B1, B5 and B6 count the planes of ``csrc/queued_superstep.cu``
    (``blocking.QueuedPlanes``)."""
    _, _, _, _, tplan, _ = _both(2, "clamp", radius=4)
    assert tplan.program.shape == "box"
    ntaps = tplan.program.num_taps
    # B3: 8 stages, ring s of 2r + 4 rows of 32 + 2*32 - 2*4*s cells (the
    # loaded ring 4 rows more: the next group's copy in flight), and a
    # tap-offset table row per ring row
    def rings(steps):
        rows = [2 * 4 + 4 + (4 if s == 0 else 0) for s in range(steps)]
        cells = sum(n * (32 + 2 * 4 * steps - 2 * 4 * s)
                    for s, n in enumerate(rows))
        return 4 * cells + 4 * ntaps * (sum(rows) + 1)

    assert tplan.smem_bytes_for((32,), "temporal_superstep") == rings(8)
    for kernel in ("padded_pipelined", "padded_superstep", "superstep",
                   "pipelined_superstep"):
        assert tplan.body(kernel) == "streamed"
        assert tplan.smem_bytes_for((32,), kernel) == rings(2)
    one = dataclasses.replace(tplan, par_time=1)
    assert one.smem_bytes_for((32,), "superstep") == rings(1)
    # a star of radius 4 at 2 steps takes the register queues: groups of 4
    # rows of 32 + 16 cells, pitch 48 + 12; its 2 x 12 queue values per
    # cell leave stage 0 in the ring (2 groups behind the current one, 8
    # in flight: 11 groups), and stage 1 has two groups of centre rows; a
    # guard of 16 floats and an mbarrier per loaded group
    star = dataclasses.replace(tplan, spec=dataclasses.replace(
        tplan.spec, shape="star"))
    pitch = 60
    for kernel in ("padded_superstep", "superstep", "pipelined_superstep"):
        assert star.body(kernel) == "queue"
        assert star.smem_bytes_for((32,), kernel) == \
            4 * (pitch * (11 * 4 + 2 * 4) + 16) + 8 * 11
    with pytest.raises(ValueError, match="unknown superstep kernel"):
        tplan.smem_bytes_for((32,), "temporal")
