"""The superstep and wrap-refresh kernels: plain versions against the
reference's Pallas kernels (interpret mode), the ring schedule against the
reference's, and what the CUDA wrappers refuse.

The kernels themselves run only on a card: ``tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.analysis.hw import V5E
from repro.core.blocking import BlockPlan as RefPlan
from repro.core.program import StencilProgram as RefProgram
from repro.kernels import common as ref_common
from repro.lint.dataflow import verify_dataflow
from repro.tuning.space import enumerate_space

from repro_torch import convert
from repro_torch.core.blocking import KERNELS
from repro_torch.kernels import build, common, cuda

ULP = dict(atol=1e-6, rtol=1e-5)

BLOCKS = {2: (16, 128), 3: (8, 16, 128)}
GRIDS = {2: (37, 150), 3: (20, 18, 140)}     # non-divisible by the blocks


def _config(ndim, boundary, radius=2, par_time=2, shape="star"):
    rp = RefProgram(ndim=ndim, radius=radius, shape=shape, boundary=boundary,
                    boundary_value=0.25)
    rplan = RefPlan(spec=rp, block_shape=BLOCKS[ndim], par_time=par_time)
    tplan = convert.plan_from_fields(**dataclasses.asdict(rplan))
    rc = rp.default_coeffs(seed=radius)
    tc = convert.coeffs_from_numpy(np.asarray(rc.center), np.asarray(rc.taps))
    return rp, rplan, rc, tplan, tc


def _layouts(rplan, grid):
    """(reference layout, port layout) of a run's padded carry."""
    ndim = len(grid)
    rounded = tuple(ref_common.round_up(g, b)
                    for g, b in zip(grid, rplan.block_shape))
    wrap = tuple(range(ndim)) if rplan.spec.boundary == "periodic" else ()
    fields = dict(halo=rplan.halo, local_shape=tuple(grid), rounded=rounded,
                  wrap_axes=wrap)
    return ref_common.PaddedLayout(**fields), common.PaddedLayout(**fields)


def _interior(layout, n):
    return (Ellipsis,) + tuple(slice(layout.halo, layout.halo + s)
                               for s in n)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("boundary", ["clamp", "periodic", "constant"])
@pytest.mark.parametrize("phase", ["full", "remainder"])
def test_plain_superstep_matches_pallas_kernel(ndim, boundary, phase):
    """Identical padded src/dst, with random values in the ring and the
    slack: the port's wrap refresh + plain superstep equal the reference
    kernel (interpret mode) on the true interior, and the refreshed source
    buffers are identical.  The remainder superstep (par_time 1 inside the
    depth-2 ring) reads at ring offset H - h."""
    rp, rplan, rc, tplan, tc = _config(ndim, boundary)
    grid = GRIDS[ndim]
    rlay, tlay = _layouts(rplan, grid)
    if phase == "remainder":
        rplan = dataclasses.replace(rplan, par_time=1)
        tplan = dataclasses.replace(tplan, par_time=1)
    batch = (2,) if ndim == 2 else ()
    rng = np.random.RandomState(ndim)
    src = rng.uniform(-1, 1, batch + tlay.padded_shape).astype(np.float32)
    dst = np.zeros_like(src)

    rsrc, rout = ref_common._padded_superstep_pallas(
        jnp.asarray(src), jnp.asarray(dst), rc.center, rc.taps, program=rp,
        plan=rplan, layout=rlay, global_shape=grid, interpret=True)
    tsrc, tdst = torch.from_numpy(src.copy()), torch.from_numpy(dst)
    if tlay.wrap_axes:
        common.refresh_wrap_halo(tsrc, tlay)
    common.padded_superstep(tsrc, tdst, tc.center, tc.taps,
                            program=convert.program_from_fields(
                                **dataclasses.asdict(rp)),
                            plan=tplan, layout=tlay)
    ix = _interior(tlay, grid)
    np.testing.assert_allclose(tdst.numpy()[ix], np.asarray(rout)[ix], **ULP)
    np.testing.assert_array_equal(tsrc.numpy(), np.asarray(rsrc))


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("boundary", ["clamp", "periodic", "constant"])
def test_plain_superstep_is_tile_independent(ndim, boundary):
    """Cutting the interior into CTA-like tiles (ragged at the edge) gives
    the same true cells, bit for bit, as one whole-grid tile."""
    _, rplan, _, tplan, tc = _config(ndim, boundary, shape="box")
    grid = GRIDS[ndim]
    _, tlay = _layouts(rplan, grid)
    src = torch.from_numpy(np.random.RandomState(5).uniform(
        -1, 1, tlay.padded_shape).astype(np.float32))
    if tlay.wrap_axes:
        common.refresh_wrap_halo_plain(src, tlay)
    prog = tplan.program
    whole = common.padded_superstep_plain(
        src, torch.zeros_like(src), tc.center, tc.taps, program=prog,
        plan=tplan, layout=tlay)
    tile = (8, 32) if ndim == 2 else (4, 8, 32)
    tiled = common.padded_superstep_plain(
        src, torch.zeros_like(src), tc.center, tc.taps, program=prog,
        plan=tplan, layout=tlay, tile=tile)
    ix = _interior(tlay, grid)
    np.testing.assert_array_equal(tiled.numpy()[ix], whole.numpy()[ix])


@pytest.mark.parametrize("ndim,grid", [(2, (64, 256)), (3, (16, 32, 256))])
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
def test_ring_schedule_matches_reference(ndim, grid, radius):
    """Field by field (``dataclasses.asdict`` of both records) on a sample
    of the reference tuner's design space, every variant; the reference's
    RP4xx verifier accepts the port's schedule."""
    checked, total = 0, 0
    for boundary in ("periodic", "clamp"):
        rp = RefProgram(ndim=ndim, radius=radius, boundary=boundary)
        tp = convert.program_from_fields(**dataclasses.asdict(rp))
        cands = enumerate_space(rp, V5E, grid_shape=grid, max_par_time=6)
        total += len(cands)
        for c in cands[::max(1, len(cands) // 12)]:
            tplan = convert.plan_from_fields(**dataclasses.asdict(c.plan))
            period = c.plan.par_time * (4 if c.variant == "temporal" else 1)
            steps = 2 * period + (1 if period > 1 else 0)
            want = ref_common.ring_schedule(rp, c.plan, grid, steps,
                                            variant=c.variant)
            got = common.ring_schedule(tp, tplan, grid, steps,
                                       variant=c.variant)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert verify_dataflow(rp, c.plan, grid, steps=steps,
                                   variant=c.variant, schedule=got) == []
            checked += 1
    assert checked >= min(total, 16)


def test_wrap_degenerate_layout_matches_reference():
    rp, rplan, _, tplan, _ = _config(3, "periodic")
    grid = (9, 18, 140)     # axis 0: 16 - 9 + 4 = 11 > 9
    rlay, tlay = _layouts(rplan, grid)
    assert tlay.wrap_degenerate() and rlay.wrap_degenerate()
    sched = common.ring_schedule(tplan.program, tplan, grid, 3)
    assert sched.fallback and sched.supersteps == ()
    assert common.wrap_copies(tlay) == tuple(
        common.RingCopy(**dataclasses.asdict(c))
        for c in ref_common.wrap_copies(rlay))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """On a CPU tensor the dispatchers take the plain version; the CUDA
    wrappers themselves refuse anything but a CUDA float32 tensor."""
    _, rplan, _, tplan, tc = _config(2, "periodic")
    _, tlay = _layouts(rplan, GRIDS[2])
    src = torch.zeros(tlay.padded_shape)
    before = cuda.launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda.padded_superstep(src, src.clone(), tc.center, tc.taps,
                              program=tplan.program, plan=tplan, layout=tlay)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda.refresh_wrap_halo(src, common.wrap_copies(tlay),
                               tlay.padded_shape)
    with pytest.raises(ValueError, match="neither a kernel"):
        common.padded_superstep(src.to("meta"), src.to("meta"), tc.center,
                                tc.taps, program=tplan.program, plan=tplan,
                                layout=tlay)
    assert cuda.launches() == before


@pytest.mark.parametrize("ndim,halo,steps,taps", [
    (2, 8, 2, 17), (3, 4, 1, 25), (3, 8, 2, 729)])
def test_pick_tile_fits_shared_memory(ndim, halo, steps, taps):
    """The plans of a 2D star r4, a 3D star r4 and a 3D box r4, for every
    kernel: B5's window tile per axis, every other kernel's in-plane
    column tile (halo and taps as named for B1); x a multiple of 32, or
    of 8 for the queued kernels (B1, B6) on their own source."""
    radius = halo // steps
    shape = "box" if taps == (2 * radius + 1) ** ndim else "star"
    prog = RefProgram(ndim=ndim, radius=radius, shape=shape)
    plan = convert.plan_from_fields(**dataclasses.asdict(RefPlan(
        spec=prog, block_shape=BLOCKS[ndim], par_time=steps)))
    assert (plan.halo, plan.program.num_taps) == (halo, taps)
    limit = 232448
    for kernel in KERNELS:
        small = cuda.smallest_tile(plan, kernel)
        if plan.smem_bytes_for(small, kernel) > limit:
            assert kernel == "temporal_superstep" and ndim == 3
            with pytest.raises(ValueError, match="no CTA tile fits"):
                cuda.pick_tile(plan, kernel, limit)
            continue
        tile = cuda.pick_tile(plan, kernel, limit)
        want = ndim if kernel == "superstep" else ndim - 1
        queued = plan.body(kernel) in ("queue", "ring")
        assert len(tile) == want and tile[-1] % (8 if queued else 32) == 0
        assert plan.smem_bytes_for(tile, kernel) <= limit
        with pytest.raises(ValueError, match="no CTA tile fits"):
            cuda.pick_tile(plan, kernel, 1024)


def test_kernel_build_key_covers_included_headers(tmp_path, monkeypatch):
    """An edited header changes the library path of every source that
    includes it, and only of those."""
    for src in build.SOURCES:
        for name in (src,) + build.includes(src):
            (tmp_path / name).write_bytes((build.CSRC / name).read_bytes())
    assert build.includes("padded_superstep.cu") == ("superstep_common.cuh",)
    assert build.includes("queued_superstep.cu") == ()
    assert build.includes("wrap_halo.cu") == ()
    assert build.includes("streamed_superstep.cu") == ()
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {s: build.library_path(s) for s in build.SOURCES}
    header = tmp_path / "superstep_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {s: build.library_path(s) for s in build.SOURCES}
    assert after["padded_superstep.cu"] != before["padded_superstep.cu"]
    assert after["queued_superstep.cu"] == before["queued_superstep.cu"]
    assert after["wrap_halo.cu"] == before["wrap_halo.cu"]
    assert after["streamed_superstep.cu"] == \
        before["streamed_superstep.cu"]


def test_kernel_build_keeps_each_compiler_log(tmp_path, monkeypatch):
    """A library counts as built only with its compiler log beside it, so
    the ``ptxas`` report can be read whichever process built it."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    src = "streamed_superstep.cu"
    lib, log = build.library_path(src), build.log_path(src)
    assert log == lib.with_suffix(".log") and log.parent == tmp_path
    lib.write_bytes(b"")
    log.write_text("ptxas info    : 0 bytes stack frame\n")
    assert build.build([src]) == {}      # both there: nothing to compile
    assert build.build_log(src).startswith("ptxas info")
    log.unlink()

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_log(src)             # a library without its log rebuilds


def test_kernel_build_is_keyed_by_source_hash():
    for src in build.SOURCES:
        path = build.library_path(src)
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(src.split(".")[0] + "-")
        assert path == build.library_path(src)
        assert (build.CSRC / src).exists()
    assert "arch=compute_90a,code=sm_90a" in build.FLAGS
