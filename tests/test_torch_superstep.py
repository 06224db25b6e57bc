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


#: (ndim, variant, batch, plan radius and par_time, grid): the layouts of
#: a run's periodic carry, all with round-up slack; the temporal ones have
#: the chunk-deep ring (H = 4 * par_time * radius).
WRAP_CASES = [
    (2, "plain", None, 2, 2, (37, 150)),
    (3, "plain", None, 2, 2, (20, 18, 140)),
    (2, "plain", 2, 1, 3, (37, 150)),
    (3, "plain", 2, 2, 1, (20, 18, 140)),
    (2, "temporal", None, 2, 2, (37, 150)),
    (3, "temporal", 2, 2, 1, (20, 32, 140)),
]


def _wrap_case(ndim, variant, batch, radius, par_time, grid):
    rp, rplan, _, tplan, _ = _config(ndim, "periodic", radius=radius,
                                     par_time=par_time)
    layout = common.ring_schedule(tplan.program, tplan, grid, par_time,
                                  variant=variant).layout
    assert not layout.wrap_degenerate()
    lead = () if batch is None else (batch,)
    src = torch.from_numpy(np.random.RandomState(ndim).uniform(
        -1, 1, lead + layout.padded_shape).astype(np.float32))
    return layout, src


def _shell(layout):
    """True on the cells a refresh rewrites: outside ``[H, H + n)`` on
    some wrap axis."""
    H = layout.halo
    mask = torch.zeros(layout.padded_shape, dtype=torch.bool)
    for d in layout.wrap_axes:
        pos = torch.arange(layout.padded_shape[d])
        ring = (pos < H) | (pos >= H + layout.local_shape[d])
        shape = [1] * len(layout.padded_shape)
        shape[d] = -1
        mask |= ring.reshape(shape)
    return mask


@pytest.mark.parametrize("case", WRAP_CASES)
def test_wrap_boxes_cover_the_shell_once_from_the_interior(case):
    """B2's single-launch map (``cuda.wrap_boxes``): the boxes of the
    slabs cover every shell cell exactly once and nothing else, each box
    reads cells interior on every wrap axis (so no cell is read after it
    is written, in any order), and applying the boxes equals the
    axis-ordered ``refresh_wrap_halo_plain`` on every cell, exactly."""
    layout, src = _wrap_case(*case)
    H, n = layout.halo, layout.local_shape
    boxes = cuda.wrap_boxes(layout)
    assert len(boxes) == (8 if len(n) == 2 else 26)
    cover = torch.zeros(layout.padded_shape, dtype=torch.int64)
    got = src.clone()
    for box in boxes:
        dst = tuple(slice(lo, lo + ext) for lo, ext, _ in box)
        frm = tuple(slice(lo + sh, lo + sh + ext) for lo, ext, sh in box)
        cover[dst] += 1
        for d, (lo, ext, sh) in enumerate(box):
            assert H <= lo + sh and lo + sh + ext <= H + n[d]
        got[(Ellipsis,) + dst] = src[(Ellipsis,) + frm]
    assert torch.equal(cover, _shell(layout).long())
    want = common.refresh_wrap_halo_plain(src.clone(), layout)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("case", WRAP_CASES)
@pytest.mark.parametrize("aligned", [True, False])
def test_wrap_kernel_replay_equals_plain_refresh(case, aligned):
    """A torch replay of ``csrc/wrap_halo.cu`` over the launch rows
    (``cuda.wrap_rows``): each CTA finds its box as the kernel does, its
    threads decompose their item indices into (batch, z, y, x) and copy
    one cell, or 4 where the box's rows are 16-byte aligned on both sides;
    the CTAs cover every item once and the result equals
    ``refresh_wrap_halo_plain`` exactly."""
    layout, src = _wrap_case(*case)
    batch = src.shape[0] if src.ndim > len(layout.padded_shape) else 1
    rows, blocks, (P0, P1, P2) = cuda.wrap_rows(layout, batch, aligned)
    per_cta = cuda.WRAP_THREADS * cuda.WRAP_PER_THREAD
    flat = src.clone().reshape(-1)
    base = flat.clone()
    # a CTA's box: one less than the rows whose first CTA is at or before
    # it (__syncthreads_count)
    owner = [sum(cta >= row[0] for row in rows) - 1 for cta in range(blocks)]
    for k, (first, count, l0, l1, l2, e0, e1, ex, delta, vec) in \
            enumerate(rows):
        # 16-byte rows: both ends of the destination row and the source's
        assert vec == int(aligned and all(
            v % 4 == 0 for v in (P2, l2, ex * (4 if vec else 1), delta)))
        assert owner.count(k) == -(-count // per_cta)
        i = torch.arange(count, dtype=torch.int64)
        x, t = i % ex, i // ex
        y, t = t % e1, t // e1
        z, b = t % e0, t // e0
        at = ((b * P0 + l0 + z) * P1 + l1 + y) * P2 + l2 + \
            (4 * x if vec else x)
        if vec:
            at = (at[:, None] + torch.arange(4)).reshape(-1)
        flat[at] = base[at + delta]
    want = common.refresh_wrap_halo_plain(src.clone(), layout)
    torch.testing.assert_close(flat.reshape(src.shape), want, rtol=0,
                               atol=0)


def test_wrap_boxes_refuse_a_wrap_degenerate_layout():
    """``run_call`` re-pads a wrap-degenerate layout instead; the
    single-launch map refuses one, since some source would lie in the
    shell."""
    _, rplan, _, _, _ = _config(3, "periodic")
    _, tlay = _layouts(rplan, (9, 18, 140))
    assert tlay.wrap_degenerate()
    with pytest.raises(ValueError, match="wrap-degenerate"):
        cuda.wrap_boxes(tlay)


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
        cuda.refresh_wrap_halo(src, tlay)
    with pytest.raises(ValueError, match="neither a kernel"):
        common.padded_superstep(src.to("meta"), src.to("meta"), tc.center,
                                tc.taps, program=tplan.program, plan=tplan,
                                layout=tlay)
    assert cuda.launches() == before


@pytest.mark.parametrize("ndim,halo,steps,taps", [
    (2, 8, 2, 17), (3, 4, 1, 25), (3, 8, 2, 729)])
def test_pick_tile_fits_shared_memory(ndim, halo, steps, taps):
    """The plans of a 2D star r4, a 3D star r4 and a 3D box r4, for every
    kernel: an in-plane column tile (halo and taps as named for B1); x a
    multiple of 32 on the streamed kernel, of 8 on the register queues
    (B1, B5, B6 with a star)."""
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
        queued = plan.body(kernel) == "queue"
        assert len(tile) == ndim - 1
        assert tile[-1] % (8 if queued else 32) == 0
        assert plan.smem_bytes_for(tile, kernel) <= limit
        with pytest.raises(ValueError, match="no CTA tile fits"):
            cuda.pick_tile(plan, kernel, 1024)


def test_kernel_build_key_covers_included_headers(tmp_path, monkeypatch):
    """An edited header changes the library path of every source that
    includes it, directly or through another header, and only of those.
    Every source includes ``elem.cuh`` (the element type); a copy of one
    source, in a directory without it, includes a header that includes a
    second."""
    for src in build.SOURCES:
        assert build.includes(src) == ("elem.cuh",)
        (tmp_path / src).write_bytes((build.CSRC / src).read_bytes())
    (tmp_path / "outer.cuh").write_text('#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("// inner\n")
    wrap = tmp_path / "wrap_halo.cu"
    wrap.write_text('#include "outer.cuh"\n' + wrap.read_text())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.includes("wrap_halo.cu") == ("outer.cuh", "inner.cuh")
    assert build.includes("queued_superstep.cu") == ()
    before = {s: build.library_path(s) for s in build.SOURCES}
    inner = tmp_path / "inner.cuh"
    inner.write_text(inner.read_text() + "// edited\n")
    after = {s: build.library_path(s) for s in build.SOURCES}
    assert after["wrap_halo.cu"] != before["wrap_halo.cu"]
    assert after["queued_superstep.cu"] == before["queued_superstep.cu"]
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
