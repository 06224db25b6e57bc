"""The CUDA kernels on a card, against their plain versions.

A CUDA kernel has no CPU mode, so every test here carries the ``gpu``
marker and the ``cuda_device`` fixture skips it where no card is visible.
This file imports only the port (no JAX), so it runs on a GPU host as is:

    python -m pytest -q -m gpu tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.blocking import (CARRY_KERNELS, QUEUE_STEPS,
                                      TEMPORAL_CHUNK)
from repro_torch.core.codegen import boundary_pad
from repro_torch.core.reference import program_nsteps
from repro_torch.kernels import common, cuda
from repro_torch.lint.diagnostics import DiagnosticError

pytestmark = pytest.mark.gpu

ULP = dict(atol=1e-6, rtol=1e-5)
BLOCKS = {2: (16, 128), 3: (8, 16, 128)}
GRIDS = {2: (37, 150), 3: (20, 18, 140)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _config(ndim, boundary, shape="box", par_time=2, variant="plain",
            grid=None):
    prog = repro_torch.StencilProgram(ndim=ndim, radius=2, shape=shape,
                                      boundary=boundary, boundary_value=0.25)
    plan = repro_torch.BlockPlan(spec=prog, block_shape=BLOCKS[ndim],
                                 par_time=par_time)
    layout = common.ring_schedule(prog, plan, grid or GRIDS[ndim], par_time,
                                  variant=variant).layout
    return prog, plan, layout


def _interior(layout):
    return (Ellipsis,) + tuple(slice(layout.halo, layout.halo + n)
                               for n in layout.local_shape)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("boundary", ["clamp", "periodic", "constant"])
@pytest.mark.parametrize("phase", ["full", "remainder"])
def test_kernels_match_plain_versions(cuda_device, ndim, boundary, phase):
    """Random values everywhere in the padded source, ring and slack
    included; batch 2.  The wrap refresh is exact; the superstep equals
    the plain version on the true interior (same mul-then-add order)."""
    prog, plan, layout = _config(ndim, boundary)
    if phase == "remainder":
        plan = dataclasses.replace(plan, par_time=1)
    gen = torch.Generator(device=cuda_device).manual_seed(ndim)
    src = torch.rand((2,) + layout.padded_shape, generator=gen,
                     device=cuda_device) * 2 - 1
    coeffs = prog.default_coeffs(seed=1).to(cuda_device)
    if layout.wrap_axes:
        got = src.clone()
        common.refresh_wrap_halo(got, layout)
        want = common.refresh_wrap_halo_plain(src.clone(), layout)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        src = want
    got, want = torch.zeros_like(src), torch.zeros_like(src)
    common.padded_superstep(src, got, coeffs.center, coeffs.taps,
                            program=prog, plan=plan, layout=layout)
    common.padded_superstep_plain(src, want, coeffs.center, coeffs.taps,
                                  program=prog, plan=plan, layout=layout)
    ix = _interior(layout)
    torch.testing.assert_close(got[ix], want[ix], **ULP)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("boundary", ["clamp", "periodic", "constant"])
def test_front_door_on_the_card_matches_cpu(cuda_device, ndim, boundary):
    prog, plan, _ = _config(ndim, boundary)
    coeffs = prog.default_coeffs(seed=2)
    g = torch.from_numpy(np.random.RandomState(ndim).uniform(
        -1, 1, (2,) + GRIDS[ndim]).astype(np.float32))
    on_cpu = repro_torch.stencil(prog, coeffs).compile(
        GRIDS[ndim], steps=3, batch=2, plan=plan, device="cpu").run(g)
    cs = repro_torch.stencil(prog, coeffs).compile(GRIDS[ndim], steps=3,
                                                   batch=2, plan=plan)
    assert cs.device == cuda_device
    on_card = cs.run(g.to(cuda_device))
    torch.testing.assert_close(on_card.cpu(), on_cpu, **ULP)
    c64 = repro_torch.ProgramCoeffs(coeffs.center.double(),
                                    coeffs.taps.double())
    torch.testing.assert_close(on_card.cpu().double(),
                               program_nsteps(prog, c64, g.double(), 3),
                               atol=5e-4, rtol=0)


def test_main_path_counts_launches(cuda_device):
    """steps 5 at par_time 2: three supersteps (the last a remainder), each
    one wrap launch (every axis) and one superstep launch."""
    prog, plan, _ = _config(2, "periodic")
    cs = repro_torch.stencil(prog).compile(GRIDS[2], steps=5, plan=plan)
    g = torch.rand(GRIDS[2], device=cuda_device)
    cuda.reset_launches()
    cs.run(g)
    torch.cuda.synchronize()
    launched = {k: v for k, v in cuda.launches().items() if v}
    assert launched == {"padded_superstep": 3, "wrap_halo": 3}


#: (ndim, variant, radius, par_time, grid): periodic carries with
#: round-up slack; the temporal ones have the chunk-deep ring.
WRAP_LAYOUTS = [(2, "plain", 2, 2, (37, 150)), (3, "plain", 2, 2, GRIDS[3]),
                (2, "temporal", 2, 2, (37, 150)),
                (3, "temporal", 2, 1, (20, 32, 140)),
                (2, "plain", 1, 4, (64, 256))]


@pytest.mark.parametrize("layout_case", WRAP_LAYOUTS)
@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("aligned", [True, False])
def test_wrap_refresh_is_one_launch_equal_to_plain(cuda_device, layout_case,
                                                   batch, aligned):
    """B2 refreshes every wrap axis in one launch and equals the
    axis-ordered ``refresh_wrap_halo_plain`` on every cell, exactly; on a
    buffer 4 bytes off 16-byte alignment it copies cell by cell."""
    ndim, variant, radius, par_time, grid = layout_case
    prog = repro_torch.StencilProgram(ndim=ndim, radius=radius,
                                      boundary="periodic")
    plan = repro_torch.BlockPlan(spec=prog, block_shape=BLOCKS[ndim],
                                 par_time=par_time)
    layout = common.ring_schedule(prog, plan, grid, par_time,
                                  variant=variant).layout
    shape = (() if batch is None else (batch,)) + layout.padded_shape
    n = int(np.prod(shape))
    store = _random((n + 1,), cuda_device, ndim)
    src = (store[:n] if aligned else store[1:]).view(shape)
    assert (src.data_ptr() % 16 == 0) == aligned
    want = common.refresh_wrap_halo_plain(src.clone(), layout)
    before = cuda.launches()["wrap_halo"]
    common.refresh_wrap_halo(src, layout)
    assert cuda.launches()["wrap_halo"] == before + 1
    torch.testing.assert_close(src, want, rtol=0, atol=0)


def test_wrappers_refuse_bad_tensors_on_the_card(cuda_device):
    prog, plan, layout = _config(2, "clamp")
    coeffs = prog.default_coeffs().to(cuda_device)
    src = torch.zeros(layout.padded_shape, device=cuda_device)
    before = cuda.launches()
    for bad, match in ((src.double(), "float32"), (src.t(), "contiguous"),
                       (src[1:], "shape")):
        with pytest.raises(ValueError, match=match):
            cuda.padded_superstep(bad, src, coeffs.center, coeffs.taps,
                                  program=prog, plan=plan, layout=layout)
    with pytest.raises(ValueError, match="does not match"):
        cuda.padded_superstep(src, src[None].clone(), coeffs.center,
                              coeffs.taps, program=prog, plan=plan,
                              layout=layout)
    assert cuda.launches() == before


@pytest.mark.parametrize("variant,kernel", [
    ("plain", "superstep"), ("pipelined", "pipelined_superstep"),
    ("temporal", "superstep")])
def test_wrap_degenerate_layout_runs_on_the_card(cuda_device, variant,
                                                 kernel):
    """The re-pad fallback launches the pre-padded superstep (B5, B6 for
    pipelined, B5 with the chunk-deep plan for temporal) and matches the
    CPU."""
    par_time = 1 if variant == "temporal" else 2
    prog, plan, _ = _config(3, "periodic", par_time=par_time)
    shape = (9, 18, 140)
    steps = TEMPORAL_CHUNK * par_time + par_time + 1
    assert common.ring_schedule(prog, plan, shape, steps,
                                variant=variant).fallback
    g = torch.from_numpy(np.random.RandomState(3).uniform(
        -1, 1, shape).astype(np.float32))
    on_cpu = repro_torch.stencil(prog).compile(
        shape, steps=steps, plan=plan, variant=variant, device="cpu").run(g)
    cs = repro_torch.stencil(prog).compile(shape, steps=steps, plan=plan,
                                           variant=variant)
    cuda.reset_launches()
    on_card = cs.run(g.to(cuda_device))
    torch.cuda.synchronize()
    counts = {k: v for k, v in cuda.launches().items() if v}
    # one launch per period, the remainder's included: 5 + 1 at par_time
    # 2, or for temporal 1 chunk of 4 + 1
    assert counts == {kernel: 6 if par_time == 2 else 2}, counts
    torch.testing.assert_close(on_card.cpu(), on_cpu, **ULP)


def _random(shape, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=device) * 2 - 1


#: Corner cases of the streamed geometry (``kernels/streamed.py``), box
#: taps unless named: the picked geometry; a segment shorter than 2h (and
#: a ragged last one); a column tile that divides neither blocked axis;
#: diamond taps; star taps (the kernel's fixed-offset path) of radius 2
#: and 4.
CORNERS = ["picked", "short-segment", "ragged-tile", "diamond", "star",
           "r4"]


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("boundary", ["clamp", "periodic", "constant"])
@pytest.mark.parametrize("phase", ["full", "remainder"])
@pytest.mark.parametrize("variant", ["temporal", "pipelined"])
@pytest.mark.parametrize("corner", CORNERS)
def test_variant_kernels_match_plain_versions(cuda_device, ndim, boundary,
                                              phase, variant, corner):
    """B3 (temporal, the chunk-deep ring) and B4 (pipelined) against
    ``padded_superstep_plain`` on random padded sources, batch 2; the
    remainder phase runs at par_time 1 (B3: a chunk of
    4 steps).  Exact: the same mul-then-add order."""
    par_time = 2 if phase == "full" else 1
    if variant == "temporal" and ndim == 3:
        par_time = 1        # 4 steps of radius 2: the box's rings fit
    radius = 4 if corner == "r4" else 2
    if radius == 4 and variant == "temporal":
        par_time = 1
    shape = {"diamond": "diamond", "star": "star", "r4": "star"}.get(
        corner, "box")
    prog = repro_torch.StencilProgram(ndim=ndim, radius=radius, shape=shape,
                                      boundary=boundary, boundary_value=0.25)
    plan = repro_torch.BlockPlan(spec=prog, block_shape=BLOCKS[ndim],
                                 par_time=par_time)
    grid = (20, 32, 140) if ndim == 3 else GRIDS[2]
    layout = common.ring_schedule(prog, plan, grid, par_time,
                                  variant=variant).layout
    src = _random((2,) + layout.padded_shape, cuda_device, ndim)
    coeffs = prog.default_coeffs(seed=1).to(cuda_device)
    if layout.wrap_axes:
        common.refresh_wrap_halo(src, layout)
    name = {"temporal": "temporal_superstep",
            "pipelined": "padded_pipelined"}[variant]
    steps = plan.kernel_steps(name)
    geometry = {}
    if corner == "short-segment":
        geometry["segment"] = max(1, steps * radius - 1)
    elif corner == "ragged-tile":
        geometry["tile"] = (32,) if ndim == 2 else (3, 32)
    got, want = torch.zeros_like(src), torch.zeros_like(src)
    before = cuda.launches()
    launch = {"temporal": cuda.temporal_superstep,
              "pipelined": cuda.padded_pipelined}[variant]
    launch(src, got, coeffs.center, coeffs.taps, program=prog, plan=plan,
           layout=layout, **geometry)
    assert cuda.launches()[name] == before[name] + 1
    deep = common.deep_plan(plan) if variant == "temporal" else plan
    common.padded_superstep_plain(src, want, coeffs.center, coeffs.taps,
                                  program=prog, plan=deep, layout=layout)
    ix = _interior(layout)
    torch.testing.assert_close(got[ix], want[ix], rtol=0, atol=0)


@pytest.mark.parametrize("variant", ["temporal", "pipelined"])
def test_streamed_launcher_refuses_a_different_ring_count(
        cuda_device, monkeypatch, variant):
    """The launcher sizes its rings itself and refuses a geometry whose
    shared-memory count (``StreamedGeometry.smem_bytes``, the one the tile
    pick and RP105 use) differs by one float; nothing launches."""
    from repro_torch.kernels import streamed
    prog, plan, layout = _config(2, "clamp", shape="star", par_time=1,
                                 variant=variant)
    src = _random(layout.padded_shape, cuda_device, 0)
    coeffs = prog.default_coeffs(seed=1).to(cuda_device)
    launch = {"temporal": cuda.temporal_superstep,
              "pipelined": cuda.padded_pipelined}[variant]
    launch(src, torch.zeros_like(src), coeffs.center, coeffs.taps,
           program=prog, plan=plan, layout=layout)
    monkeypatch.setattr(streamed.StreamedGeometry, "smem_bytes", property(
        lambda geo: geo.rings.bytes(geo.ntaps) + 4))
    before = cuda.launches()
    with pytest.raises(RuntimeError, match="CUDA error"):
        launch(src, torch.zeros_like(src), coeffs.center, coeffs.taps,
               program=prog, plan=plan, layout=layout)
    assert cuda.launches() == before


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("boundary", ["clamp", "periodic", "constant"])
@pytest.mark.parametrize("par_time", [2, 1])
@pytest.mark.parametrize("variant", ["plain", "pipelined"])
@pytest.mark.parametrize("shape", ["star", "box", "diamond"])
def test_prepadded_kernels_match_plain_versions(cuda_device, ndim, boundary,
                                                par_time, variant, shape):
    """B5 (plain) and B6 (pipelined) through ``superstep_call`` against
    ``superstep_plain`` on the same padded grid (batch 2, non-zero shard
    offsets in a larger global grid): the shard's true cells agree
    exactly, on the register queues (the star) and on the streamed
    kernel's pre-padded mode (the box, the diamond)."""
    prog, plan, _ = _config(ndim, boundary, shape=shape, par_time=par_time)
    grid = GRIDS[ndim]
    h = plan.halo
    rounded = tuple(common.round_up(n, b) for n, b in zip(grid,
                                                           BLOCKS[ndim]))
    g = _random((2,) + grid, cuda_device, ndim)
    padded = boundary_pad(prog, g, [(0, 0)] + [
        (h, r - n + h) for n, r in zip(grid, rounded)]).contiguous()
    coeffs = prog.default_coeffs(seed=2).to(cuda_device)
    offsets = (3,) * ndim
    global_shape = tuple(n + 7 for n in grid)
    kernel = "pipelined_superstep" if variant == "pipelined" \
        else "superstep"
    before = cuda.launches()[kernel]
    got = common.superstep_call(padded, coeffs.center, coeffs.taps,
                                program=prog, plan=plan,
                                true_shape=global_shape, offsets=offsets,
                                variant=variant)
    assert cuda.launches()[kernel] == before + 1
    assert tuple(got.shape) == (2,) + rounded
    want = common.superstep_plain(padded, coeffs.center, coeffs.taps,
                                  program=prog, plan=plan,
                                  true_shape=global_shape, offsets=offsets)
    ix = (Ellipsis,) + tuple(slice(0, n) for n in grid)
    torch.testing.assert_close(got[ix], want[ix], rtol=0, atol=0)


@pytest.mark.parametrize("variant,want", [
    ("plain", {"padded_superstep": 3, "wrap_halo": 3}),
    ("pipelined", {"padded_pipelined": 3, "wrap_halo": 3}),
    ("temporal", {"temporal_superstep": 1, "padded_superstep": 1,
                  "wrap_halo": 2}),
])
def test_variant_launch_counts(cuda_device, variant, want):
    """par_time 2 on a periodic grid: plain and pipelined at steps 5 run
    two full supersteps and a remainder; temporal at steps 11 one chunk of
    8 and a plain remainder of 3; one wrap launch before each."""
    prog, plan, _ = _config(2, "periodic")
    steps = 11 if variant == "temporal" else 5
    cs = repro_torch.stencil(prog).compile(GRIDS[2], steps=steps, plan=plan,
                                           variant=variant)
    g = torch.rand(GRIDS[2], device=cuda_device)
    cuda.reset_launches()
    out = cs.run(g)
    torch.cuda.synchronize()
    counts = {k: v for k, v in cuda.launches().items() if v}
    assert counts == want
    on_cpu = repro_torch.stencil(prog).compile(
        GRIDS[2], steps=steps, plan=plan, variant=variant,
        device="cpu").run(g.cpu())
    torch.testing.assert_close(out.cpu(), on_cpu, **ULP)


def test_compile_refuses_a_plan_no_tile_fits(cuda_device):
    """RP105 at compile, before any launch: a 3D box of radius 2 under
    temporal fuses 8 steps per chunk, and its plane rings and offset tables
    fit no column tile.  The 3D radius-4 plan whose B1 remainder of 3
    steps the whole-window kernel refused now compiles."""
    prog = repro_torch.StencilProgram(ndim=3, radius=2, shape="box")
    plan = repro_torch.BlockPlan(spec=prog, block_shape=(32, 64, 704),
                                 par_time=2)
    before = cuda.launches()
    with pytest.raises(DiagnosticError, match="RP105"):
        repro_torch.stencil(prog).compile((512, 1024, 704), steps=9,
                                          plan=plan, variant="temporal")
    star = repro_torch.StencilProgram(ndim=3, radius=4)
    plan4 = repro_torch.BlockPlan(spec=star, block_shape=(32, 64, 704),
                                  par_time=1)
    assert repro_torch.stencil(star).compile(
        (512, 1024, 704), steps=3, plan=plan4,
        variant="temporal").device == cuda_device
    assert repro_torch.stencil(star).compile(
        (512, 1024, 704), steps=3, plan=plan4).device == cuda_device
    assert cuda.launches() == before


#: B1 and B6 (``kernels/queued.py``): (shape, radius, fused steps).  Stars
#: within ``QUEUE_STEPS`` take the register queues; the star of 6 steps,
#: the 3D star of radius 4 at 2 steps, the box and the diamond run the
#: streamed kernel (B1 on the carry, B6 in its pre-padded mode).
QUEUED = [("star", 1, 4), ("star", 2, 3), ("star", 3, 1), ("star", 4, 2),
          ("star", 1, 6), ("box", 1, 2), ("diamond", 2, 1)]
#: The picked geometry; a segment shorter than 2h; a column tile that
#: divides neither blocked axis.
QUEUED_CORNERS = ["picked", "short-segment", "ragged-tile"]


def _queued_geometry(corner, ndim, steps, radius):
    if corner == "short-segment":
        return {"segment": max(1, steps * radius - 1)}
    if corner == "ragged-tile":
        return {"tile": (40,) if ndim == 2 else (3, 40)}
    return {}


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("boundary", ["clamp", "periodic", "constant"])
@pytest.mark.parametrize("shape,radius,steps", QUEUED)
@pytest.mark.parametrize("corner", QUEUED_CORNERS)
def test_padded_superstep_matches_plain_version(cuda_device, ndim,
                                                boundary, shape, radius,
                                                steps, corner):
    """B1 against ``padded_superstep_plain`` on a random padded carry
    (ring and slack random too), batch 2: exact."""
    prog = repro_torch.StencilProgram(ndim=ndim, radius=radius, shape=shape,
                                      boundary=boundary, boundary_value=0.25)
    plan = repro_torch.BlockPlan(spec=prog, block_shape=BLOCKS[ndim],
                                 par_time=steps)
    grid = (23, 30, 150) if ndim == 3 else (37, 150)
    layout = common.ring_schedule(prog, plan, grid, steps).layout
    src = _random((2,) + layout.padded_shape, cuda_device, ndim)
    if layout.wrap_axes:
        common.refresh_wrap_halo_plain(src, layout)
    coeffs = prog.default_coeffs(seed=1).to(cuda_device)
    geometry = _queued_geometry(corner, ndim, steps, radius)
    got, want = torch.zeros_like(src), torch.zeros_like(src)
    before = cuda.launches()
    cuda.padded_superstep(src, got, coeffs.center, coeffs.taps, program=prog,
                          plan=plan, layout=layout, **geometry)
    assert cuda.launches()["padded_superstep"] == \
        before["padded_superstep"] + 1
    common.padded_superstep_plain(src, want, coeffs.center, coeffs.taps,
                                  program=prog, plan=plan, layout=layout)
    ix = _interior(layout)
    torch.testing.assert_close(got[ix], want[ix], rtol=0, atol=0)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("boundary", ["clamp", "periodic", "constant"])
@pytest.mark.parametrize("shape,radius,steps", QUEUED)
@pytest.mark.parametrize("corner", QUEUED_CORNERS)
def test_pipelined_superstep_matches_plain_version(cuda_device, ndim,
                                                   boundary, shape, radius,
                                                   steps, corner):
    """B6 against ``superstep_plain``, batch 2, a shard at non-zero
    offsets in a larger global grid (its low side past the global edge):
    exact on the shard's true cells."""
    prog = repro_torch.StencilProgram(ndim=ndim, radius=radius, shape=shape,
                                      boundary=boundary, boundary_value=0.25)
    plan = repro_torch.BlockPlan(spec=prog, block_shape=BLOCKS[ndim],
                                 par_time=steps)
    shape_ = (23, 30, 150) if ndim == 3 else (37, 150)
    h = plan.halo
    rounded = tuple(common.round_up(n, b) for n, b in zip(shape_,
                                                           BLOCKS[ndim]))
    g = _random((2,) + shape_, cuda_device, ndim)
    padded = boundary_pad(prog, g, [(0, 0)] + [
        (h, r - n + h) for n, r in zip(shape_, rounded)]).contiguous()
    coeffs = prog.default_coeffs(seed=2).to(cuda_device)
    offsets = (2,) * ndim
    global_shape = tuple(n + 5 for n in shape_)
    before = cuda.launches()["pipelined_superstep"]
    got = cuda.pipelined_superstep(
        padded, coeffs.center, coeffs.taps, program=prog, plan=plan,
        true_shape=global_shape, offsets=offsets,
        **_queued_geometry(corner, ndim, steps, radius))
    assert cuda.launches()["pipelined_superstep"] == before + 1
    want = common.superstep_plain(padded, coeffs.center, coeffs.taps,
                                  program=prog, plan=plan,
                                  true_shape=global_shape, offsets=offsets)
    ix = (Ellipsis,) + tuple(slice(0, n) for n in shape_)
    torch.testing.assert_close(got[ix], want[ix], rtol=0, atol=0)


def test_queued_launches_on_two_streams_keep_their_coefficients(
        cuda_device):
    """``csrc/queued_superstep.cu`` holds a launch's coefficients in one
    constant bank per device.  B1 with a star on one stream, and on a
    second stream B6 with the same star and other coefficients (the same
    source's bank) and B6 with a box (the streamed kernel's pre-padded
    mode, coefficients in shared memory), interleaved four times each:
    every output equals its plain version exactly."""
    star = repro_torch.StencilProgram(ndim=3, radius=1, boundary="clamp")
    box = dataclasses.replace(star, shape="box")
    plan = repro_torch.BlockPlan(spec=star, block_shape=(8, 16, 128),
                                 par_time=2)
    plan_box = dataclasses.replace(plan, spec=box)
    assert plan.body("pipelined_superstep") == "queue"
    assert plan_box.body("pipelined_superstep") == "streamed"
    grid = (64, 96, 512)
    layout = common.ring_schedule(star, plan, grid, 2).layout
    src = _random(layout.padded_shape, cuda_device, 3)
    h = plan.halo
    rounded = tuple(common.round_up(n, b) for n, b in zip(grid, BLOCKS[3]))
    padded = boundary_pad(box, src[_interior(layout)], [
        (h, r - n + h) for n, r in zip(grid, rounded)]).contiguous()
    c1 = star.default_coeffs(seed=1).to(cuda_device)
    c2 = star.default_coeffs(seed=2).to(cuda_device)
    c3 = box.default_coeffs(seed=3).to(cuda_device)
    streams = (torch.cuda.Stream(cuda_device), torch.cuda.Stream(cuda_device))
    torch.cuda.synchronize()
    carried, stars, boxes = [], [], []
    for _ in range(4):
        with torch.cuda.stream(streams[0]):
            out = torch.zeros_like(src)
            cuda.padded_superstep(src, out, c1.center, c1.taps, program=star,
                                  plan=plan, layout=layout)
            carried.append(out)
        with torch.cuda.stream(streams[1]):
            stars.append(cuda.pipelined_superstep(
                padded, c2.center, c2.taps, program=star, plan=plan,
                true_shape=grid))
            boxes.append(cuda.pipelined_superstep(
                padded, c3.center, c3.taps, program=box, plan=plan_box,
                true_shape=grid))
    torch.cuda.synchronize()
    want = torch.zeros_like(src)
    common.padded_superstep_plain(src, want, c1.center, c1.taps,
                                  program=star, plan=plan, layout=layout)
    want_star = common.superstep_plain(padded, c2.center, c2.taps,
                                       program=star, plan=plan,
                                       true_shape=grid)
    want_box = common.superstep_plain(padded, c3.center, c3.taps,
                                      program=box, plan=plan_box,
                                      true_shape=grid)
    ix = _interior(layout)
    true = tuple(slice(0, n) for n in grid)
    for got in carried:
        torch.testing.assert_close(got[ix], want[ix], rtol=0, atol=0)
    for got, w in [(g, want_star) for g in stars] + \
            [(g, want_box) for g in boxes]:
        torch.testing.assert_close(got[true], w[true], rtol=0, atol=0)


def test_run_refuses_a_step_count_no_tile_fits(cuda_device):
    """ROADMAP C1: compiled for 4 steps (one 4-step B1, which fits), the
    3D diamond r4 plan of par_time 8 is refused with RP105 at ``run`` for
    5 and 9 steps, before any launch; the compiled count still runs."""
    prog = repro_torch.StencilProgram(ndim=3, radius=4, shape="diamond")
    plan = repro_torch.BlockPlan(spec=prog, block_shape=(32, 64, 704),
                                 par_time=8)
    shape = (512, 1024, 704)
    cs = repro_torch.stencil(prog).compile(shape, steps=4, plan=plan)
    grid = torch.zeros(shape, device=cuda_device)
    for steps in (5, 9):
        cuda.reset_launches()
        with pytest.raises(DiagnosticError, match="RP105"):
            cs.run(grid, steps=steps)
        assert sum(cuda.launches().values()) == 0
    small = repro_torch.stencil(prog).compile((6, 8, 40), steps=4, plan=plan)
    cuda.reset_launches()
    small.run(torch.zeros((6, 8, 40), device=cuda_device))
    assert cuda.launches()["padded_superstep"] == 1


@pytest.mark.parametrize("ndim,shape,radius,boundary,grid,body", [
    (3, "star", 2, "clamp", (128, 256, 256), "queue"),
    (3, "star", 4, "clamp", (64, 96, 160), "streamed"),
    (2, "box", 1, "periodic", (300, 1000), "streamed"),
])
def test_planned_run_equals_the_pinned_run(cuda_device, tmp_path, ndim,
                                           shape, radius, boundary, grid,
                                           body):
    """``plan="auto"`` (the default) and ``plan="model"`` on the card: the
    plan's carry kernel runs the expected body, launches as the schedule
    says, and the result equals the pinned plan's run."""
    prog = repro_torch.StencilProgram(ndim=ndim, radius=radius, shape=shape,
                                      boundary=boundary, boundary_value=0.25)
    steps = 7
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    g = torch.rand(grid, generator=gen, device=cuda_device) * 2 - 1
    pinned = repro_torch.stencil(prog).compile(grid, steps=steps, plan=(
        repro_torch.BlockPlan(spec=prog, block_shape=BLOCKS[ndim],
                              par_time=2)))
    want = pinned.run(g)
    for plan in ("auto", "model"):
        kw = {} if plan == "auto" else {"plan": plan}
        cs = repro_torch.stencil(prog).compile(
            grid, steps=steps, cache_path=str(tmp_path / "p.json"), **kw)
        kernel = common.CARRY_KERNELS[cs.variant]
        if plan == "auto":
            assert cs.plan.body(kernel) == body
        cuda.reset_launches()
        got = cs.run(g)
        sched = common.ring_schedule(prog, cs.plan, grid, steps,
                                     variant=cs.variant)
        want_counts = {}
        for name, _, _, count in common.run_launches(sched):
            want_counts[name] = want_counts.get(name, 0) + count
        if sched.layout.wrap_axes and not sched.fallback:
            want_counts["wrap_halo"] = sched.full + int(sched.rem > 0)
        assert {k: v for k, v in cuda.launches().items() if v} == \
            want_counts
        torch.testing.assert_close(got, want, **ULP)


def test_autotune_measures_on_the_card(cuda_device, tmp_path):
    """``autotune(measure=True)`` times its frontier with CUDA events on
    the card, keeps a cache record under the card's name, and the second
    call comes from the cache with no launch."""
    from repro_torch.tuning import PlanCache, autotune, cache_key
    prog = repro_torch.StencilProgram(ndim=2, radius=2)
    grid = (512, 1024)
    path = str(tmp_path / "plans.json")
    tuned = autotune(prog, grid_shape=grid, variant="auto", measure=True,
                     top_k=2, reps=2, cache_path=path)
    name = torch.cuda.get_device_name(cuda_device)
    assert tuned.measurement is not None
    assert {m.device for m in tuned.measurements} == {name}
    assert all(m.ok and m.measured_ms > 0 and m.predicted_ms > 0
               for m in tuned.measurements)
    key = cache_key(prog, grid, name, "cuda", 1, variant="auto",
                    device="cuda")
    assert tuned.key == key
    records = PlanCache(path).get_all(key)
    assert len(records) == 1 and records[0]["measurement"]["device"] == name
    cuda.reset_launches()
    again = autotune(prog, grid_shape=grid, variant="auto", measure=True,
                     top_k=2, reps=2, cache_path=path)
    assert again.from_cache and sum(cuda.launches().values()) == 0


@pytest.mark.parametrize("ndim", [2, 3])
def test_served_batch_equals_unbatched_runs(cuda_device, ndim):
    """A served chunk of 3 (one batched run on the card) equals three
    unbatched front-door runs under the server's plan, at 0; the results
    stay on the card."""
    from repro_torch.launch.stencil_serve import StencilServer
    from repro_torch.tuning.cache import program_fingerprint
    prog = repro_torch.StencilProgram(ndim=ndim, radius=2, shape="box",
                                      boundary="periodic",
                                      boundary_value=0.25)
    server = StencilServer(max_batch=4, max_par_time=2)
    gen = torch.Generator(device=cuda_device).manual_seed(ndim)
    grids = [torch.rand(GRIDS[ndim], generator=gen, device=cuda_device)
             for _ in range(3)]
    rids = [server.submit(prog, g, steps=5) for g in grids]
    cuda.reset_launches()
    results = server.flush()
    assert not server.failed and server.stats.batched_requests == 3
    launched = {k: v for k, v in cuda.launches().items() if v}
    plan, backend = server._resolved[(program_fingerprint(prog),
                                      GRIDS[ndim])]
    cs = repro_torch.stencil(prog).compile(GRIDS[ndim], steps=5, plan=plan,
                                           backend=backend)
    cuda.reset_launches()
    for rid, g in zip(rids, grids):
        assert results[rid].device == g.device
        torch.testing.assert_close(results[rid], cs.run(g), rtol=0, atol=0)
    torch.cuda.synchronize()
    # one batched run launches what one unbatched run does
    assert {k: v // 3 for k, v in cuda.launches().items() if v} == launched


def _zero_filled_run(cs, grid, steps):
    """``cs``'s run of ``grid`` over zero-filled carry buffers (the padded
    source ``new_zeros`` with the interior copied in, the destination
    ``zeros_like``), launch for launch as ``common.run_call``."""
    sched = common.ring_schedule(cs.program, cs.plan, cs.grid_shape, steps,
                                 variant=cs.variant)
    layout = sched.layout
    inner = _interior(layout)
    src = grid.new_zeros(grid.shape[:grid.ndim - cs.program.ndim]
                         + layout.padded_shape)
    src[inner] = grid
    dst = torch.zeros_like(src)
    c = cs.coeffs
    for _, variant, plan, count in common.run_launches(sched):
        for _ in range(count):
            if layout.wrap_axes:
                common.refresh_wrap_halo(src, layout)
            common.padded_superstep(src, dst, c.center, c.taps,
                                    program=cs.program, plan=plan,
                                    layout=layout, variant=variant)
            src, dst = dst, src
    return src[inner].contiguous()


@pytest.mark.parametrize("ndim", [2, 3])
def test_served_chunk_of_four_equals_four_runs(cuda_device, ndim):
    """A served chunk of 4 radius-4 stars goes to the run driver as a list
    of grids, each copied once into an uninitialised carry whose ring and
    slack alone are zeroed.  The allocator's free memory is first filled
    with NaN, so a cell read before any launch wrote it would show.  The
    results equal 4 unbatched front-door runs and the zero-filled carry's
    run at 0, and the recorder counts the driver's bytes."""
    from repro_torch import obs
    from repro_torch.launch.stencil_serve import StencilServer
    from repro_torch.tuning.cache import program_fingerprint
    prog = repro_torch.StencilProgram(ndim=ndim, radius=4)
    shape = {2: (300, 1100), 3: (40, 72, 300)}[ndim]
    steps = {2: 9, 3: 3}[ndim]
    gen = torch.Generator(device=cuda_device).manual_seed(20 + ndim)
    grids = [torch.rand(shape, generator=gen, device=cuda_device) * 2 - 1
             for _ in range(4)]
    server = StencilServer(max_batch=4)
    rids = [server.submit(prog, g, steps) for g in grids]
    server.flush()                      # plans and geometries, warm
    rids = [server.submit(prog, g, steps) for g in grids]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()            # no free block but the poisoned one
    poison = torch.full((1 << 27,), float("nan"), device=cuda_device)
    del poison                          # its block goes back to the cache
    with obs.profile() as rec:
        results = server.flush()
    assert not server.failed and server.stats.batched_requests == 8
    plan, backend = server._resolved[(program_fingerprint(prog), shape)]
    cs = repro_torch.stencil(prog).compile(shape, steps=steps, plan=plan,
                                           backend=backend)
    batched = repro_torch.stencil(prog).compile(
        shape, steps=steps, batch=4, plan=plan, backend=backend)
    old = _zero_filled_run(batched, torch.stack(grids), steps)
    for i, (rid, g) in enumerate(zip(rids, grids)):
        assert not torch.isnan(results[rid]).any()
        torch.testing.assert_close(results[rid], cs.run(g), rtol=0, atol=0)
        torch.testing.assert_close(results[rid], old[i], rtol=0, atol=0)
    layout = common.ring_schedule(prog, plan, shape, steps,
                                  variant=batched.variant).layout
    n = int(np.prod(shape))
    outside = 4 * (int(np.prod(layout.padded_shape)) - n)
    assert rec.counter("run_call.copy_bytes") == 4 * (4 * 4 * n
                                                      + 2 * outside)


@pytest.mark.parametrize("variant,want", [
    ("plain", {"padded_superstep": 3, "wrap_halo": 3}),
    ("pipelined", {"padded_pipelined": 3, "wrap_halo": 3}),
    ("temporal", {"temporal_superstep": 1, "padded_superstep": 1,
                  "wrap_halo": 2}),
])
def test_recorded_run_is_timed_on_the_card(cuda_device, variant, want):
    """Under ``obs.profile()`` a run's span carries CUDA-event seconds no
    longer than its synchronised wall time, and the launches it made."""
    from repro_torch import obs
    prog, plan, _ = _config(2, "periodic")
    steps = 11 if variant == "temporal" else 5
    cs = repro_torch.stencil(prog).compile(GRIDS[2], steps=steps, plan=plan,
                                           variant=variant)
    g = torch.rand(GRIDS[2], device=cuda_device)
    with obs.profile() as rec:
        out = cs.run(g)
    (sp,) = rec.spans("run")
    assert 0 < sp["device_s"] <= sp["wall_s"]
    assert sp["host_s"] == pytest.approx(sp["wall_s"] - sp["device_s"])
    assert sp["launch_delta"] == want
    assert sp["device"] == "cuda"
    assert sp["chip"] == torch.cuda.get_device_name(cuda_device)
    (sample,) = rec.accuracy_samples()
    assert sample["device_s"] == sp["device_s"]
    assert sample["model_accuracy"] == sp["model_accuracy"] > 0
    torch.testing.assert_close(out, cs.run(g), rtol=0, atol=0)


# ---- the pre-flight checks on the card --------------------------------------

#: Grids the canary runs at: no axis a multiple of its block, so the
#: round-up slack is poisoned too, and periodic under every variant keeps
#: its ring schedule (no wrap-degenerate fallback).
CANARY_GRIDS = {2: (37, 150), 3: (20, 40, 140)}


def _canary_counts(prog, variant, remainder):
    """The launches of a canary run of two full supersteps (+ one)."""
    main = {"plain": "padded_superstep", "pipelined": "padded_pipelined",
            "temporal": "temporal_superstep"}[variant]
    want = {main: 2}
    if remainder:
        tail = "padded_superstep" if variant == "temporal" else main
        want[tail] = want.get(tail, 0) + 1
    if prog.boundary == "periodic":
        want["wrap_halo"] = 2 + int(remainder)
    return want


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("boundary", ["clamp", "periodic", "constant"])
@pytest.mark.parametrize("variant", ["plain", "pipelined", "temporal"])
@pytest.mark.parametrize("remainder", [False, True])
def test_canary_on_the_kernels_is_clean_and_equals_the_run(
        cuda_device, ndim, boundary, variant, remainder):
    """The NaN canary runs B1, B3 or B4 (and B2 when periodic) with every
    ring and slack cell poisoned: clean, and its interior equals the front
    door's run of the same grid at 0."""
    from repro_torch.lint import sanitize_run
    from repro_torch.lint.sanitize import canary_grid
    prog = repro_torch.StencilProgram(ndim=ndim, radius=2,
                                      boundary=boundary, boundary_value=0.25)
    plan = repro_torch.BlockPlan(spec=prog, block_shape=BLOCKS[ndim],
                                 par_time=2)
    grid = CANARY_GRIDS[ndim]
    steps = 2 * plan.par_time * (TEMPORAL_CHUNK if variant == "temporal"
                                 else 1) + int(remainder)
    cuda.reset_launches()
    report = sanitize_run(prog, plan, grid, steps=steps, variant=variant)
    torch.cuda.synchronize()
    assert report.ok and not report.fallback, report.describe()
    assert report.supersteps == 2 + int(remainder)
    assert {k: v for k, v in cuda.launches().items() if v} == \
        _canary_counts(prog, variant, remainder)
    assert report.interior.device.type == "cuda"
    cs = repro_torch.stencil(prog, prog.default_coeffs(0)).compile(
        grid, steps=steps, plan=plan, variant=variant)
    g = torch.from_numpy(canary_grid(grid)).to(cuda_device)
    torch.testing.assert_close(report.interior, cs.run(g), rtol=0, atol=0)


def test_canary_on_the_kernels_catches_a_skipped_wrap(cuda_device,
                                                      monkeypatch):
    """With the wrap copies gone no B2 runs, B1 reads the NaN ring, and
    both the canary and the proof say RP405."""
    from repro_torch.lint import sanitize_run, verify_dataflow
    prog = repro_torch.StencilProgram(ndim=2, radius=2, boundary="periodic")
    plan = repro_torch.BlockPlan(spec=prog, block_shape=BLOCKS[2],
                                 par_time=2)
    grid = CANARY_GRIDS[2]
    assert sanitize_run(prog, plan, grid, steps=5).ok
    monkeypatch.setattr(common, "wrap_copies", lambda layout: ())
    cuda.reset_launches()
    report = sanitize_run(prog, plan, grid, steps=5)
    torch.cuda.synchronize()
    assert [d.code for d in report.diagnostics] == ["RP405"]
    assert report.supersteps == 1 and report.interior is None
    assert cuda.launches()["wrap_halo"] == 0
    assert cuda.launches()["padded_superstep"] == 1
    assert "RP405" in [d.code for d in verify_dataflow(prog, plan, grid,
                                                       steps=5)]


def test_compile_sanitize_on_the_card(cuda_device):
    prog = repro_torch.StencilProgram(ndim=3, radius=2, boundary="periodic")
    plan = repro_torch.BlockPlan(spec=prog, block_shape=BLOCKS[3],
                                 par_time=2)
    cs = repro_torch.stencil(prog).compile(CANARY_GRIDS[3], steps=5,
                                           plan=plan, sanitize=True)
    assert cs.sanitize_report.ok and cs.sanitize_report.supersteps == 3
    assert cs.sanitize_report.interior.device.type == "cuda"
    g = torch.rand(CANARY_GRIDS[3], device=cuda_device)
    assert torch.isfinite(cs.run(g)).all()


def test_rp106_on_an_odd_halo_plan(cuda_device):
    """2D r1 at par_time 1: a carry pitch of 258 floats, which turns the
    register queues' bulk row copies off; par_time 2 does not warn."""
    prog = repro_torch.StencilProgram(ndim=2, radius=1, boundary="clamp")
    plan = repro_torch.BlockPlan(spec=prog, block_shape=(64, 256),
                                 par_time=1)
    cs = repro_torch.stencil(prog).compile((64, 256), steps=3, plan=plan)
    assert [d.code for d in cs.preflight] == ["RP106"]
    assert "pitch 258" in cs.preflight[0].message
    even = repro_torch.stencil(prog).compile(
        (64, 256), steps=3, plan=dataclasses.replace(plan, par_time=2))
    assert even.preflight == []
    g = torch.rand((64, 256), device=cuda_device)
    torch.testing.assert_close(cs.run(g), even.run(g, steps=3), **ULP)


def test_rp104_on_the_card(cuda_device):
    prog = repro_torch.StencilProgram(ndim=2, radius=1, boundary="clamp")
    for block in ((0, 128), (8, 0), (-4, 128)):
        plan = repro_torch.BlockPlan(spec=prog, block_shape=block,
                                     par_time=1)
        before = cuda.launches()
        with pytest.raises(DiagnosticError, match="RP104"):
            repro_torch.stencil(prog).compile((16, 128), steps=3, plan=plan)
        assert cuda.launches() == before


# ---- the mesh: sharded carry kernels and shards on one card -----------------


#: A shard's place along each axis, for a local extent n in a global grid
#: of 3n: the last shard (non-zero origin, its high side on the global
#: edge), an inner shard (no global edge), the first shard (origin 0, its
#: high side an inner edge).
SHARD_ORIGINS = {"last": 2, "inner": 1, "first": 0}
SHARD_GRIDS = {2: (24, 96), 3: (12, 16, 96)}


def _shard_case(ndim, boundary, shape, radius, steps, where, device):
    prog = repro_torch.StencilProgram(ndim=ndim, radius=radius, shape=shape,
                                      boundary=boundary, boundary_value=0.25)
    local = SHARD_GRIDS[ndim]
    plan = repro_torch.BlockPlan(spec=prog, block_shape=local,
                                 par_time=steps)
    global_shape = tuple(3 * n for n in local)
    layout = common.ring_schedule(prog, plan, global_shape, steps,
                                  decomp=(3,) * ndim).layout
    offsets = tuple(SHARD_ORIGINS[where] * n for n in local)
    # random everywhere: the ring stands for exchanged neighbour cells
    # and, past the global edge, for cells nothing wrote
    src = _random((2,) + layout.padded_shape, device, ndim)
    coeffs = prog.default_coeffs(seed=1).to(device)
    return prog, plan, layout, offsets, global_shape, src, coeffs


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("boundary", ["clamp", "periodic", "constant"])
@pytest.mark.parametrize("shape,radius,steps", QUEUED)
@pytest.mark.parametrize("where", sorted(SHARD_ORIGINS))
@pytest.mark.parametrize("variant", ["plain", "pipelined"])
def test_sharded_carry_matches_plain_version(cuda_device, ndim, boundary,
                                             shape, radius, steps, where,
                                             variant):
    """B1 and B4 on a mesh shard's carry (the sharded instantiations, a
    launch counted apart) against ``padded_superstep_plain`` with the
    same ``offsets`` and ``global_shape``, batch 2: exact on the shard's
    true cells, whether its edges are global or inner."""
    prog, plan, layout, offsets, global_shape, src, coeffs = _shard_case(
        ndim, boundary, shape, radius, steps, where, cuda_device)
    launch, name = (cuda.padded_superstep, "padded_superstep_sharded") \
        if variant == "plain" else (cuda.padded_pipelined,
                                    "padded_pipelined_sharded")
    got, want = torch.zeros_like(src), torch.zeros_like(src)
    before = cuda.launches()
    launch(src, got, coeffs.center, coeffs.taps, program=prog, plan=plan,
           layout=layout, offsets=offsets, global_shape=global_shape)
    after = cuda.launches()
    assert {k: v - before[k] for k, v in after.items()
            if v != before[k]} == {name: 1}
    common.padded_superstep_plain(src, want, coeffs.center, coeffs.taps,
                                  program=prog, plan=plan, layout=layout,
                                  offsets=offsets,
                                  global_shape=global_shape)
    ix = _interior(layout)
    torch.testing.assert_close(got[ix], want[ix], rtol=0, atol=0)


def _mesh(prog, plan, grid, axis_shards, variant, device):
    from repro_torch.core import distributed
    mesh = distributed.make_mesh(axis_shards, [device] * 8)
    decomp = distributed.Decomposition(tuple(
        (f"d{i}",) if s > 1 else () for i, s in enumerate(axis_shards)))
    return distributed.DistributedStencil(
        prog, prog.default_coeffs(seed=3), plan, mesh, decomp, grid,
        variant=variant, _warn=False)


@pytest.mark.parametrize("ndim,grid,block,axis_shards", [
    (2, (64, 256), (16, 64), (2, 2)), (3, (16, 32, 128), (4, 8, 64),
                                       (2, 2, 1))])
@pytest.mark.parametrize("boundary", ["clamp", "periodic", "constant"])
@pytest.mark.parametrize("shape", ["star", "box"])
@pytest.mark.parametrize("variant", ["plain", "pipelined"])
def test_mesh_on_one_card_equals_the_single_device_run(
        cuda_device, ndim, grid, block, axis_shards, boundary, shape,
        variant):
    """Four shards on one card, 5 steps at par_time 2 (a remainder),
    batch 2: the sharded kernels only, equal to the single-device front
    door's run at 0."""
    prog = repro_torch.StencilProgram(ndim=ndim, radius=2, shape=shape,
                                      boundary=boundary, boundary_value=0.25)
    plan = repro_torch.BlockPlan(spec=prog, block_shape=block, par_time=2)
    dist = _mesh(prog, plan, grid, axis_shards, variant, cuda_device)
    g = _random((2,) + grid, cuda_device, ndim)
    cuda.reset_launches()
    got = dist.run(g, 5)
    torch.cuda.synchronize()
    counts = {k: v for k, v in cuda.launches().items() if v}
    name = "padded_superstep" if variant == "plain" else "padded_pipelined"
    want_counts = {f"{name}_sharded": 4 * 3}
    wrap = boundary == "periodic" and 1 in axis_shards
    if wrap:
        want_counts["wrap_halo"] = 4 * 3
    assert counts == want_counts
    want = repro_torch.stencil(prog, prog.default_coeffs(seed=3)).compile(
        grid, steps=5, batch=2, plan=plan, variant=variant).run(g)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    one = dist.superstep(g)
    torch.testing.assert_close(
        one, common.pad_superstep(g, dist.coeffs_on(cuda_device).center,
                                  dist.coeffs_on(cuda_device).taps,
                                  program=prog, plan=plan, variant=variant),
        rtol=0, atol=0)


def test_mesh_shards_on_two_streams_keep_their_coefficients(cuda_device):
    """Two meshes of four shards on one card with different coefficients,
    on two streams at once: the queued source's one constant bank per
    device takes turns, so each run equals its own single-device run."""
    star = repro_torch.StencilProgram(ndim=3, radius=2, boundary="clamp")
    plan = repro_torch.BlockPlan(spec=star, block_shape=(4, 8, 64),
                                 par_time=2)
    grid = (16, 32, 128)
    assert plan.body("padded_superstep") == "queue"
    a = _mesh(star, plan, grid, (2, 2, 1), "plain", cuda_device)
    b = _mesh(star, plan, grid, (2, 2, 1), "plain", cuda_device)
    b.coeffs = star.default_coeffs(seed=4)
    g = _random(grid, cuda_device, 5)
    streams = (torch.cuda.Stream(cuda_device), torch.cuda.Stream(cuda_device))
    torch.cuda.synchronize()
    outs = []
    for _ in range(3):
        for dist, stream in zip((a, b), streams):
            with torch.cuda.stream(stream):
                outs.append((dist, dist.run(g, 4)))
    torch.cuda.synchronize()
    for dist, got in outs:
        want = repro_torch.stencil(star, dist.coeffs).compile(
            grid, steps=4, plan=plan).run(g)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---- 16-bit grids ----------------------------------------------------------
#
# Every kernel in bfloat16 and float16 (one library per dtype, the element
# type of ``csrc/elem.cuh``) against its plain version on the card, at 0:
# both round to the grid's dtype after every multiply and every add.  A
# boundary value of 0.3 is not exact in 16 bits, so its rounding shows.

DT16 = ["bfloat16", "float16"]


def _random16(shape, device, seed, dtype):
    return _random(shape, device, seed).to(getattr(torch, dtype))


def _prog16(ndim, boundary, shape, radius, dtype):
    return repro_torch.StencilProgram(ndim=ndim, radius=radius, shape=shape,
                                      boundary=boundary, boundary_value=0.3,
                                      dtype=dtype)


@pytest.mark.parametrize("dtype", DT16)
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("boundary", ["clamp", "periodic", "constant"])
@pytest.mark.parametrize("shape,radius,steps", QUEUED + [("star", 4, 1)])
@pytest.mark.parametrize("variant", ["plain", "temporal", "pipelined"])
def test_16bit_carry_kernels_equal_plain_versions(cuda_device, dtype, ndim,
                                                  boundary, shape, radius,
                                                  steps, variant):
    """B1 (both bodies: the register queues take a star of radius 4 at 1
    and, in 2D, 2 steps), B3 (at par_time 1: a chunk of 4 steps) and B4 in
    16 bits against ``padded_superstep_plain`` on a random padded carry,
    batch 2, exact; B2 exact on the periodic ring."""
    prog = _prog16(ndim, boundary, shape, radius, dtype)
    par_time = 1 if variant == "temporal" else steps
    plan = repro_torch.BlockPlan(spec=prog, block_shape=BLOCKS[ndim],
                                 par_time=par_time)
    grid = (23, 30, 150) if ndim == 3 else (37, 150)
    layout = common.ring_schedule(prog, plan, grid, par_time,
                                  variant=variant).layout
    src = _random16((2,) + layout.padded_shape, cuda_device, ndim, dtype)
    coeffs = prog.default_coeffs(seed=1).to(cuda_device)
    before = cuda.launches(dtype)
    if layout.wrap_axes:
        got = src.clone()
        common.refresh_wrap_halo(got, layout)
        src = common.refresh_wrap_halo_plain(src, layout)
        torch.testing.assert_close(got, src, rtol=0, atol=0)
    got, want = torch.zeros_like(src), torch.zeros_like(src)
    common.padded_superstep(src, got, coeffs.center, coeffs.taps,
                            program=prog, plan=plan, layout=layout,
                            variant=variant)
    name = {"plain": "padded_superstep", "temporal": "temporal_superstep",
            "pipelined": "padded_pipelined"}[variant]
    after = cuda.launches(dtype)
    assert after[name] == before[name] + 1
    assert after["wrap_halo"] == before["wrap_halo"] + \
        int(bool(layout.wrap_axes))
    deep = common.deep_plan(plan) if variant == "temporal" else plan
    common.padded_superstep_plain(src, want, coeffs.center, coeffs.taps,
                                  program=prog, plan=deep, layout=layout)
    ix = _interior(layout)
    assert got.dtype == want.dtype == getattr(torch, dtype)
    torch.testing.assert_close(got[ix], want[ix], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DT16)
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("boundary", ["clamp", "periodic", "constant"])
@pytest.mark.parametrize("variant", ["plain", "pipelined"])
@pytest.mark.parametrize("shape", ["star", "box", "diamond"])
@pytest.mark.parametrize("radius", [2, 4])
def test_16bit_prepadded_kernels_equal_plain_versions(cuda_device, dtype,
                                                      ndim, boundary,
                                                      variant, shape,
                                                      radius):
    """B5 and B6 in 16 bits through ``superstep_call`` against
    ``superstep_plain`` (batch 2, a shard origin in a larger grid): the
    register queues (a star: radius 4 at 2 steps in 2D, at 1 in 3D) and
    the streamed pre-padded mode, exact."""
    prog = _prog16(ndim, boundary, shape, radius, dtype)
    par_time = 1 if (ndim, radius) == (3, 4) else 2
    plan = repro_torch.BlockPlan(spec=prog, block_shape=BLOCKS[ndim],
                                 par_time=par_time)
    grid = GRIDS[ndim]
    h = plan.halo
    rounded = tuple(common.round_up(n, b) for n, b in zip(grid,
                                                           BLOCKS[ndim]))
    g = _random16((2,) + grid, cuda_device, ndim, dtype)
    padded = boundary_pad(prog, g, [(0, 0)] + [
        (h, r - n + h) for n, r in zip(grid, rounded)]).contiguous()
    coeffs = prog.default_coeffs(seed=2).to(cuda_device)
    offsets, global_shape = (3,) * ndim, tuple(n + 7 for n in grid)
    kernel = "pipelined_superstep" if variant == "pipelined" \
        else "superstep"
    before = cuda.launches(dtype)[kernel]
    got = common.superstep_call(padded, coeffs.center, coeffs.taps,
                                program=prog, plan=plan,
                                true_shape=global_shape, offsets=offsets,
                                variant=variant)
    assert cuda.launches(dtype)[kernel] == before + 1
    want = common.superstep_plain(padded, coeffs.center, coeffs.taps,
                                  program=prog, plan=plan,
                                  true_shape=global_shape, offsets=offsets)
    ix = (Ellipsis,) + tuple(slice(0, n) for n in grid)
    assert got.dtype == getattr(torch, dtype)
    torch.testing.assert_close(got[ix], want[ix], rtol=0, atol=0)


#: The 16-bit edge cases: input classes that reach the corners of the
#: rounding, and the kernels of the packed arithmetic (``csrc/elem.cuh``,
#: ``__hmul2_rn``/``__hadd2_rn`` on pairs) as (variant, ndim, shape,
#: radius, par_time): B1 on the register queues (radius 4 in 2D and 3D),
#: B1 on the streamed body (a box, and a star past the queues' steps), B3
#: (2D radius 4: a lane of two planes, 3D radius 2: one lane a thread).
EDGE_CLASSES = ("subnormal", "ties", "zeros", "specials", "overflow")
EDGE_KERNELS = [("plain", 2, "star", 4, 2), ("plain", 3, "star", 4, 1),
                ("plain", 2, "box", 1, 2), ("plain", 2, "star", 1, 6),
                ("temporal", 2, "star", 4, 1), ("temporal", 3, "star", 2, 1)]


def _edge_inputs(kind, prog, shape, seed):
    """A carry of ``shape`` in the program's dtype and coefficients for
    one :data:`EDGE_CLASSES` class (numpy, seeded):

    - subnormal: multiples of the smallest subnormal up to four times the
      smallest normal; a bfloat16 product then lies below float's normal
      range, where float rounds before the cast does;
    - ties: p-bit values over p + 3 binades and coefficients of 3
      significant bits, so products and sums land on halfway points;
    - zeros: +0 and -0 in seven cells of ten, negative coefficients;
    - specials: +inf, -inf and NaN in two cells of a hundred each;
    - overflow: values within a factor 2 of the largest finite, and
      coefficients up to 1.5, so products and sums overflow to inf."""
    dt = getattr(torch, prog.dtype)
    info = torch.finfo(dt)
    p = 8 if prog.dtype == "bfloat16" else 11  # significand bits
    rng = np.random.RandomState(seed)
    n = int(np.prod(shape))
    sign = rng.choice([-1.0, 1.0], n)
    k = prog.num_neighbor_taps + 1
    coef = rng.choice([-1.0, 1.0], k) * rng.choice(
        [0.375, 0.5, 0.625, 0.75, 1.0, 1.5], k)
    if kind == "subnormal":
        q = info.tiny * 2.0 ** (1 - p)
        v = sign * rng.randint(0, 2 ** (p + 1), n) * q
        coef = None
    elif kind == "ties":
        m = 2 ** (p - 1) + rng.randint(0, 2 ** (p - 1), n)
        v = sign * m * 2.0 ** (rng.randint(-p - 2, 1, n) - (p - 1))
    elif kind == "zeros":
        v = np.where(rng.uniform(size=n) < 0.7, sign * 0.0,
                     sign * rng.uniform(0.5, 2.0, n))
    elif kind == "specials":
        v = sign * rng.uniform(0.5, 2.0, n)
        u = rng.uniform(size=n)
        v = np.where(u < 0.02, np.inf, np.where(u < 0.04, -np.inf, v))
        v = np.where((u >= 0.04) & (u < 0.06), np.nan, v)
        coef = None
    else:
        v = sign * info.max * rng.uniform(0.5, 1.0, n)
    grid = torch.from_numpy(v.reshape(shape)).to(dt)
    if coef is None:
        coeffs = prog.default_coeffs(seed=seed)
    else:
        c = torch.from_numpy(coef).to(dt)
        coeffs = repro_torch.ProgramCoeffs(c[0], c[1:])
    return grid, coeffs


def _assert_same_bits(got, want):
    """Equal at 0 with NaN in the same cells, and bit for bit elsewhere
    (so +0 and -0 differ)."""
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    bits_g = got.view(torch.int16)[~nan]
    bits_w = want.view(torch.int16)[~nan]
    assert torch.equal(bits_g, bits_w), \
        f"{int((bits_g != bits_w).sum())} cells differ in their bits"


@pytest.mark.parametrize("dtype", DT16)
@pytest.mark.parametrize("kind", EDGE_CLASSES)
@pytest.mark.parametrize("variant,ndim,shape,radius,par_time", EDGE_KERNELS)
def test_16bit_edge_values_equal_plain_versions(cuda_device, dtype, kind,
                                                variant, ndim, shape, radius,
                                                par_time):
    """The packed 16-bit arithmetic of B1 (both bodies) and B3 gives
    ``padded_superstep_plain``'s bits on subnormals, rounding ties, signed
    zeros, infinities, NaN and overflow (:func:`_edge_inputs`), batch 2,
    with the kernel and body the case names."""
    prog = repro_torch.StencilProgram(ndim=ndim, radius=radius, shape=shape,
                                      boundary="clamp", dtype=dtype)
    plan = repro_torch.BlockPlan(spec=prog, block_shape=BLOCKS[ndim],
                                 par_time=par_time)
    grid = (23, 30, 150) if ndim == 3 else (37, 150)
    layout = common.ring_schedule(prog, plan, grid, par_time,
                                  variant=variant).layout
    src, coeffs = _edge_inputs(kind, prog, (2,) + layout.padded_shape,
                               seed=EDGE_CLASSES.index(kind))
    src, coeffs = src.to(cuda_device), coeffs.to(cuda_device)
    name = "temporal_superstep" if variant == "temporal" \
        else "padded_superstep"
    body = "streamed" if variant == "temporal" else plan.body(name)
    assert body == ("queue" if shape == "star" and radius == 4
                    and variant == "plain" else "streamed")
    before = cuda.launches(dtype)[name]
    got, want = torch.zeros_like(src), torch.zeros_like(src)
    common.padded_superstep(src, got, coeffs.center, coeffs.taps,
                            program=prog, plan=plan, layout=layout,
                            variant=variant)
    assert cuda.launches(dtype)[name] == before + 1
    deep = common.deep_plan(plan) if variant == "temporal" else plan
    common.padded_superstep_plain(src, want, coeffs.center, coeffs.taps,
                                  program=prog, plan=deep, layout=layout)
    ix = _interior(layout)
    _assert_same_bits(got[ix], want[ix])


@pytest.mark.parametrize("dtype", DT16)
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("boundary", ["clamp", "periodic", "constant"])
@pytest.mark.parametrize("shape,radius,steps", [("star", 2, 3),
                                                ("box", 1, 2),
                                                ("star", 4, 1),
                                                ("star", 3, 2),
                                                ("star", 4, 2)])
@pytest.mark.parametrize("where", sorted(SHARD_ORIGINS))
@pytest.mark.parametrize("variant", ["plain", "pipelined"])
def test_16bit_sharded_carry_equals_plain_version(cuda_device, dtype, ndim,
                                                  boundary, shape, radius,
                                                  steps, where, variant):
    """The sharded instantiations of B1 and B4 in 16 bits, exact: B1's
    register queues at radius 4 (2D at 1 and 2 steps, 3D at 1) and 2D
    radius 3 at 2 steps among them, and the streamed body where a star
    is past the queues (3D radius 4 at 2 steps)."""
    prog, plan, layout, offsets, global_shape, src, coeffs = _shard_case(
        ndim, boundary, shape, radius, steps, where, cuda_device)
    prog = dataclasses.replace(prog, dtype=dtype)
    plan = dataclasses.replace(plan, spec=prog)
    src = src.to(getattr(torch, dtype))
    launch, name = (cuda.padded_superstep, "padded_superstep_sharded") \
        if variant == "plain" else (cuda.padded_pipelined,
                                    "padded_pipelined_sharded")
    queued = (shape == "star" and variant == "plain"
              and steps <= QUEUE_STEPS[ndim][radius])
    assert plan.body(CARRY_KERNELS[variant]) == \
        ("queue" if queued else "streamed")
    got, want = torch.zeros_like(src), torch.zeros_like(src)
    before = cuda.launches(dtype)
    launch(src, got, coeffs.center, coeffs.taps, program=prog, plan=plan,
           layout=layout, offsets=offsets, global_shape=global_shape)
    after = cuda.launches(dtype)
    assert {k: v - before[k] for k, v in after.items()
            if v != before[k]} == {name: 1}
    common.padded_superstep_plain(src, want, coeffs.center, coeffs.taps,
                                  program=prog, plan=plan, layout=layout,
                                  offsets=offsets,
                                  global_shape=global_shape)
    ix = _interior(layout)
    torch.testing.assert_close(got[ix], want[ix], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DT16)
@pytest.mark.parametrize("layout_case", WRAP_LAYOUTS)
@pytest.mark.parametrize("offset", [0, 1, 4])
def test_16bit_wrap_refresh_equals_plain(cuda_device, dtype, layout_case,
                                         offset):
    """B2 on a 16-bit carry, batch 3: 8-cell (16-byte) copies on an
    aligned buffer, cell copies on one 2 or 8 bytes off; exact."""
    ndim, variant, radius, par_time, grid = layout_case
    prog = _prog16(ndim, "periodic", "star", radius, dtype)
    plan = repro_torch.BlockPlan(spec=prog, block_shape=BLOCKS[ndim],
                                 par_time=par_time)
    layout = common.ring_schedule(prog, plan, grid, par_time,
                                  variant=variant).layout
    shape = (3,) + layout.padded_shape
    n = int(np.prod(shape))
    store = _random16((n + offset,), cuda_device, ndim, dtype)
    src = store[offset:].view(shape)
    want = common.refresh_wrap_halo_plain(src.clone(), layout)
    before = cuda.launches(dtype)["wrap_halo"]
    common.refresh_wrap_halo(src, layout)
    assert cuda.launches(dtype)["wrap_halo"] == before + 1
    torch.testing.assert_close(src, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DT16)
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("boundary", ["clamp", "periodic", "constant"])
@pytest.mark.parametrize("variant", ["plain", "pipelined", "temporal"])
def test_16bit_front_door_on_the_card_equals_the_cpu(cuda_device, dtype,
                                                     ndim, boundary,
                                                     variant):
    """A 16-bit grid through the front door, 9 steps at par_time 2 (a
    remainder), batch 2: the kernels on the card equal the plain versions
    on the CPU at 0 (the same roundings), the result in the grid's dtype;
    a float32 grid is RP109."""
    prog = _prog16(ndim, boundary, "star", 2, dtype)
    plan = repro_torch.BlockPlan(spec=prog, block_shape=BLOCKS[ndim],
                                 par_time=2)
    g = _random16((2,) + GRIDS[ndim], cuda_device, ndim, dtype)
    cs = repro_torch.stencil(prog).compile(GRIDS[ndim], steps=9, batch=2,
                                           plan=plan, variant=variant)
    cuda.reset_launches()
    on_card = cs.run(g)
    torch.cuda.synchronize()
    assert on_card.dtype == g.dtype
    assert sum(cuda.launches(dtype).values()) == \
        sum(cuda.launches().values()) > 0
    on_cpu = repro_torch.stencil(prog).compile(
        GRIDS[ndim], steps=9, batch=2, plan=plan, variant=variant,
        device="cpu").run(g.cpu())
    torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=0, atol=0)
    with pytest.raises(DiagnosticError, match="RP109"):
        cs.run(g.float())


@pytest.mark.parametrize("dtype", DT16)
@pytest.mark.parametrize("variant", ["plain", "pipelined"])
def test_16bit_mesh_on_one_card_equals_the_single_device_run(
        cuda_device, dtype, variant):
    """Four shards of a 16-bit grid on one card: the sharded kernels of
    the dtype, equal to the single device's run at 0."""
    prog = _prog16(2, "clamp", "star", 2, dtype)
    plan = repro_torch.BlockPlan(spec=prog, block_shape=(16, 64),
                                 par_time=2)
    grid = (64, 256)
    dist = _mesh(prog, plan, grid, (2, 2), variant, cuda_device)
    g = _random16((2,) + grid, cuda_device, 2, dtype)
    cuda.reset_launches()
    got = dist.run(g, 5)
    torch.cuda.synchronize()
    name = "padded_superstep" if variant == "plain" else "padded_pipelined"
    assert {k: v for k, v in cuda.launches(dtype).items() if v} == \
        {f"{name}_sharded": 4 * 3}
    want = repro_torch.stencil(prog, prog.default_coeffs(seed=3)).compile(
        grid, steps=5, batch=2, plan=plan, variant=variant).run(g)
    assert got.dtype == want.dtype == g.dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DT16)
@pytest.mark.parametrize("boundary", ["clamp", "periodic", "constant"])
@pytest.mark.parametrize("variant", ["plain", "pipelined", "temporal"])
def test_16bit_canary_on_the_kernels_is_clean(cuda_device, dtype, boundary,
                                              variant):
    """The NaN canary on a 16-bit carry (B1, B3, B4, B2): clean, and equal
    to the front door's run at 0."""
    from repro_torch.lint import sanitize_run
    from repro_torch.lint.sanitize import canary_grid
    prog = _prog16(3, boundary, "star", 2, dtype)
    plan = repro_torch.BlockPlan(spec=prog, block_shape=BLOCKS[3],
                                 par_time=2)
    grid = CANARY_GRIDS[3]
    steps = 2 * plan.par_time * (TEMPORAL_CHUNK if variant == "temporal"
                                 else 1) + 1
    report = sanitize_run(prog, plan, grid, steps=steps, variant=variant)
    torch.cuda.synchronize()
    assert report.ok, report.describe()
    cs = repro_torch.stencil(prog, prog.default_coeffs(0)).compile(
        grid, steps=steps, plan=plan, variant=variant)
    g = torch.from_numpy(canary_grid(grid)).to(cuda_device,
                                               getattr(torch, dtype))
    assert report.interior.dtype == g.dtype
    torch.testing.assert_close(report.interior, cs.run(g), rtol=0, atol=0)


def test_16bit_served_request_comes_back_in_its_dtype(cuda_device):
    """A served bfloat16 request (a float32 array) runs in bfloat16 on the
    card under the planner's plan for 2-byte cells, equal to the front
    door's run under that plan at 0."""
    from repro_torch.launch.stencil_serve import StencilServer
    from repro_torch.tuning.cache import program_fingerprint
    prog = _prog16(2, "clamp", "star", 2, "bfloat16")
    g = np.random.RandomState(4).uniform(-1, 1, (48, 256)).astype(
        np.float32)
    server = StencilServer(max_batch=2)
    rid = server.submit(prog, g, 5)
    out = server.flush()[rid]
    assert not server.failed and out.dtype == torch.bfloat16
    plan, backend = server._resolved[(program_fingerprint(prog), (48, 256))]
    want = repro_torch.stencil(prog).compile(
        (48, 256), steps=5, plan=plan, backend=backend).run(
        torch.from_numpy(g).to(cuda_device, torch.bfloat16))
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def _lm_engine_run(model, device, batch=2, cache_len=32):
    """Every decode call's logits (float64, on the host) and the tokens
    of a seeded mixed-length run that refills slots."""
    import numpy as np
    from repro_torch.launch import serve
    rng = np.random.RandomState(3)
    reqs = [serve.Request(rid=i, prompt=rng.randint(0, model.cfg.vocab,
                                                     size=(n,)), max_new=g)
            for i, (n, g) in enumerate(((7, 4), (3, 6), (12, 3), (5, 5),
                                        (9, 2)))]
    engine = serve.ServeEngine(model, batch, cache_len, device=device)
    decode, calls = engine.decode, []

    def record(*args):
        logits, caches = decode(*args)
        calls.append(logits.double().cpu())
        return logits, caches

    engine.decode = record
    engine.run(reqs)
    return calls, [r.generated for r in reqs]


@pytest.mark.parametrize("arch", ["gemma3-4b", "starcoder2-7b",
                                  "gemma2-27b", "minicpm3-4b",
                                  "llava-next-34b", "granite-moe-3b-a800m",
                                  "grok-1-314b", "rwkv6-7b",
                                  "jamba-v0.1-52b"])
def test_lm_serve_engine_on_the_card_equals_the_cpu(cuda_device, arch):
    """Reduced width, float32: the card's engine against the CPU's (the
    path tests/test_torch_lm.py holds to the JAX package), call for call
    at atol 1e-3, rtol 1e-4, the tokens identical."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer
    cfg = get_arch(arch).reduced()
    cpu = transformer.build(cfg, device="cpu", seed=2)
    card = transformer.build(cfg, device=cuda_device, seed=2)
    card.load_state_dict(cpu.state_dict())
    card_calls, card_gen = _lm_engine_run(card, cuda_device)
    cpu_calls, cpu_gen = _lm_engine_run(cpu, "cpu")
    assert card_gen == cpu_gen and len(card_calls) == len(cpu_calls) > 40
    for got, want in zip(card_calls, cpu_calls):
        torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "llava-next-34b",
                                  "granite-moe-3b-a800m", "grok-1-314b",
                                  "rwkv6-7b", "jamba-v0.1-52b",
                                  "musicgen-large"])
def test_lm_family_on_the_card_equals_the_cpu(cuda_device, arch):
    """Reduced width, float32, the same weights: ``forward`` over 32
    tokens (llava's with its frontend embeddings, musicgen's in 4
    codebooks) and 16 ``decode_step`` calls into caches of 16 (the rings
    wrap, the recurrent states carry) on the card against the CPU at
    atol 1e-3, rtol 1e-4, with the MoE losses."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer
    cfg = get_arch(arch).reduced()
    cpu = transformer.build(cfg, device="cpu", seed=2)
    card = transformer.build(cfg, device=cuda_device, seed=2)
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(4)
    K = cfg.num_codebooks
    toks = torch.randint(0, cfg.vocab, (2, 32, K) if K > 1 else (2, 32),
                         generator=g, dtype=torch.int32)
    fe = torch.randn((2, cfg.img_tokens, cfg.frontend_dim), generator=g) \
        if cfg.frontend_dim else None
    outs = [m(toks.to(m.device), None if fe is None else fe.to(m.device))
            for m in (cpu, card)]
    torch.testing.assert_close(outs[1].logits.cpu(), outs[0].logits,
                               atol=1e-3, rtol=1e-4)
    for k in outs[0].aux:
        torch.testing.assert_close(outs[1].aux[k].cpu(), outs[0].aux[k],
                                   atol=1e-5, rtol=1e-4)
    caches = [m.init_caches(2, 16) for m in (cpu, card)]
    for t in range(16):
        pos = torch.full((2, 1), t, dtype=torch.int32)
        got = []
        for i, m in enumerate((cpu, card)):
            logits, caches[i] = m.decode_step(
                caches[i], toks[:, t:t + 1].to(m.device), pos.to(m.device))
            got.append(logits.cpu())
        torch.testing.assert_close(got[1], got[0], atol=1e-3, rtol=1e-4)


def _train_state(model, seed):
    """An AdamW state at step 3 for ``model``'s parameters, on the CPU:
    moments in ``moment_dtype``, ``mu`` about 1e-3, ``nu`` positive
    about 1e-5 (from zero moments the first update turns a gradient's
    last bit near zero into a whole ±lr)."""
    from repro_torch.optim import AdamWState
    g = torch.Generator().manual_seed(seed)
    dt = getattr(torch, model.cfg.moment_dtype)
    names = [(n, p.shape) for n, p in model.named_parameters()]
    mu = {n: (torch.randn(s, generator=g) * 1e-3).to(dt) for n, s in names}
    nu = {n: (torch.randn(s, generator=g).abs() * 1e-5).to(dt)
          for n, s in names}
    return AdamWState(torch.tensor(3, dtype=torch.int32), mu, nu)


@pytest.mark.parametrize("arch", ["gemma3-4b", "starcoder2-7b",
                                  "gemma2-27b", "minicpm3-4b",
                                  "llava-next-34b", "granite-moe-3b-a800m",
                                  "grok-1-314b", "rwkv6-7b",
                                  "jamba-v0.1-52b", "musicgen-large"])
def test_lm_train_step_on_the_card_equals_the_cpu(cuda_device, arch):
    """Reduced width, float32, the same weights, AdamW state and batch:
    the loss at atol 1e-3, rtol 1e-4, and each leaf's gradient, and after
    one ``make_train_step`` with ``accum=2`` each parameter's change and
    moment, on the card against the CPU (the path
    tests/test_torch_train_lm.py holds to the JAX package) within
    ``TRAIN_STEP_SHARE`` of the CPU's max in the leaf (``_step_gap``;
    grok-1's step, whose gradient is summed in bfloat16, within one
    bfloat16 ulp); a step that left the state as it was, or did not write
    its moments back, reads above it."""
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import transformer
    from repro_torch.optim import AdamW, WarmupCosine
    from repro_torch.runtime.trainer import make_train_step
    cfg = get_arch(arch).reduced()
    cpu = transformer.build(cfg, device="cpu", seed=2, train=True)
    card = transformer.build(cfg, device=cuda_device, seed=2, train=True)
    card.load_state_dict(cpu.state_dict())
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=5,
                        num_codebooks=cfg.num_codebooks,
                        frontend=(cfg.img_tokens, cfg.frontend_dim)
                        if cfg.frontend_dim else None).batch(0)
    out = []
    for m in (cpu, card):
        b = {k: torch.as_tensor(v).to(m.device) for k, v in batch.items()}
        total, _ = m.loss(b)
        total.backward()
        grads = {n: p.grad.double().cpu() for n, p in m.named_parameters()}
        before = {n: p.detach().double().cpu()
                  for n, p in m.named_parameters()}
        state = _train_state(m, 6)
        moments = {k: {n: t.double() for n, t in getattr(state, k).items()}
                   for k in ("mu", "nu")}
        state = state._replace(
            mu={n: t.to(m.device) for n, t in state.mu.items()},
            nu={n: t.to(m.device) for n, t in state.nu.items()})
        opt = AdamW(schedule=WarmupCosine(peak_lr=1e-3, warmup_steps=2,
                                          total_steps=10),
                    moment_dtype=cfg.moment_dtype)
        state, _, metrics = make_train_step(m, opt, accum=2)(state, None, b)
        leaves = {"grad": grads,
                  "delta": {n: p.detach().double().cpu() - before[n]
                            for n, p in m.named_parameters()},
                  **{k: {n: t.double().cpu()
                         for n, t in getattr(state, k).items()}
                     for k in ("mu", "nu")}}
        out.append((total.detach().cpu(), leaves, moments, state, metrics))
    (want, want_l, moments, want_s, want_m), (got, got_l, _, got_s, got_m) \
        = out
    tol = dict(atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(got, want, **tol)
    for k, v in want_m.items():
        torch.testing.assert_close(got_m[k].cpu(), v, **tol)
    slack = {"grad": {}, "delta": {}, **{
        k: {n: BF16_SLACK * want_l[k][n].abs()
            for n, t in getattr(want_s, k).items()
            if t.dtype == torch.bfloat16} for k in ("mu", "nu")}}
    stepped = BF16_SLACK if cfg.accum_dtype == "bfloat16" \
        else TRAIN_STEP_SHARE
    limits = {"grad": TRAIN_STEP_SHARE, "delta": stepped, "mu": stepped,
              "nu": stepped}
    assert _step_gap(got_l, want_l, slack, limits) <= 1.0
    zero = {n: 0.0 * t for n, t in want_l["delta"].items()}
    for fault in ({"delta": zero, **moments}, moments):
        assert _step_gap(dict(got_l, **fault), want_l, slack, limits) > 1.0
    assert int(got_s.step) == int(want_s.step) == 4


#: the share of a leaf's max |value| on the CPU within which the card's
#: train step agrees (gradients, parameter changes, moments; about twice
#: the largest reading on an H100), and one bfloat16 ulp (relative): the
#: slack of each element of a bfloat16 moment, and the share for a step
#: whose gradient is summed in bfloat16 (grok-1's ``accum_dtype``)
TRAIN_STEP_SHARE = 2e-4
BF16_SLACK = 2.0 ** -7


def _step_gap(got, want, slack, limits) -> float:
    """The largest share by which a leaf of ``got`` differs from its leaf
    in ``want`` (by kind, then name) of that leaf's max |value|, past
    each element's ``slack`` (by kind and name; none where absent), as a
    multiple of its kind's limit."""
    worst = 0.0
    for kind, leaves in want.items():
        for n, w in leaves.items():
            err = (got[kind][n] - w).abs() - slack[kind].get(n, 0.0)
            worst = max(worst, max(err.max().item(), 0.0)
                        / max(w.abs().max().item(), 1e-30) / limits[kind])
    return worst


def test_lm_train_checkpoint_restores_bf16_moments_on_the_card(
        cuda_device, tmp_path):
    """grok-1 reduced (bfloat16 moments): a run on the card saved after
    one step and restored into a fresh run equals it bit for bit."""
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    cfg = get_arch("grok-1-314b").reduced()
    assert cfg.moment_dtype == "bfloat16"
    data = SyntheticLM(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=1)
    run = train.build_run(cfg, steps=2, device=cuda_device,
                          ckpt_dir=str(tmp_path))
    train.train_loop(run, data, 1, quiet=True)
    fresh = train.build_run(cfg, steps=2, device=cuda_device, seed=9)
    fresh.load_state_tree(run.ckpt.restore(1, fresh.state_tree()))
    assert int(fresh.opt_state.step) == 1
    for a, b in ((run.params, fresh.params),
                 (run.opt_state.mu, fresh.opt_state.mu),
                 (run.opt_state.nu, fresh.opt_state.nu)):
        for n, t in a.items():
            assert b[n].dtype == t.dtype and b[n].device == t.device
            if t.dtype == torch.bfloat16:
                assert torch.equal(b[n].view(torch.int16),
                                   t.view(torch.int16)), n
            else:
                assert torch.equal(b[n], t), n
    assert any(t.dtype == torch.bfloat16 and bool(t.ne(0).any())
               for t in run.opt_state.nu.values())


# ---- the LM mesh tooling on the card -----------------------------------------

def _mesh_tree(cuda_device):
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer
    from repro_torch.models.common import LogicalAxes
    model = transformer.build(get_arch("gemma3-4b").reduced(),
                              device=cuda_device, seed=2, train=True)
    params = {n: p.detach() for n, p in model.named_parameters()}
    specs = {n: LogicalAxes(a) for n, a in model.logical_axes().items()}
    return model, params, specs


def test_mesh_reshard_tree_on_the_card(cuda_device, monkeypatch, tmp_path):
    """A reduced gemma3-4b's parameters (2, 2) -> (4, 1) on four mesh
    devices of the card, live and through restore(shardings=), at 0."""
    from repro_torch.checkpoint import (CheckpointManager, reshard_tree,
                                        shardings_from_specs)
    from repro_torch.core.distributed import ENV_DEVICE_COUNT
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.runtime import mesh_rules

    monkeypatch.setenv(ENV_DEVICE_COUNT, "4")
    _, params, specs = _mesh_tree(cuda_device)
    rules = mesh_rules.default_rules(False)
    sh_a = shardings_from_specs(make_local_mesh((2, 2)), rules, specs)
    sh_b = shardings_from_specs(make_local_mesh((4, 1)), rules, specs)
    tree_a = reshard_tree(params, sh_a)
    live = reshard_tree(tree_a, sh_b)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree_a)
    restored = mgr.restore(1, params, shardings=sh_b)
    for n, p in params.items():
        for tree in (tree_a, live, restored):
            t = tree[n]
            assert all(piece.device.type == "cuda" for piece in t.pieces)
            assert torch.equal(t.full(), p), n
            for idx, piece in zip(t.sharding.indices(t.shape), t.pieces):
                assert torch.equal(piece, p[idx]), n


def test_mesh_pipeline_of_pattern_units_on_the_card(cuda_device,
                                                    monkeypatch):
    """Two pattern units of a reduced gemma3-4b as pipeline stages on two
    mesh devices of the card, against the units in turn, at 0."""
    from repro_torch.core.distributed import ENV_DEVICE_COUNT
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer
    from repro_torch.runtime.pipeline_parallel import pipeline_apply

    monkeypatch.setenv(ENV_DEVICE_COUNT, "2")
    model, _, _ = _mesh_tree(cuda_device)
    units = [transformer.PatternUnit(model, u) for u in range(2)]
    stacked = {n: torch.stack([dict(u.named_parameters())[n].detach()
                               for u in units])
               for n, _ in units[0].named_parameters()}
    x = torch.randn(4, 1, 16, model.cfg.d_model, device=cuda_device,
                    generator=torch.Generator(device=cuda_device)
                    .manual_seed(3))

    def stage_fn(p, h):
        return torch.func.functional_call(units[0], p, (h,))

    with torch.no_grad():
        got = pipeline_apply(stage_fn, stacked, x,
                             mesh=make_local_mesh((2,), ("pod",)))
        want = x.clone()
        for m in range(x.shape[0]):
            for u in units:
                want[m] = u(want[m])
    assert torch.equal(got, want)


# ---- the legacy surface and the launch audit on the card ---------------------------

def _legacy_case(cuda_device, ndim, boundary="clamp", par_time=2):
    """A legacy spec, its coefficients and plan, and a grid on the card."""
    import warnings
    from repro_torch.core.spec import StencilSpec
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        spec = StencilSpec(ndim=ndim, radius=2, boundary=boundary)
    plan = repro_torch.BlockPlan(spec=spec, block_shape=BLOCKS[ndim],
                                 par_time=par_time)
    gen = torch.Generator(device=cuda_device).manual_seed(ndim)
    grid = torch.rand(GRIDS[ndim], generator=gen, device=cuda_device) * 2 - 1
    return spec, spec.default_coeffs(seed=1), plan, grid


def _counted(fn):
    cuda.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n for k, n in cuda.launches().items() if n}


@pytest.mark.parametrize("shim,ndim,boundary,variant", [
    ("engine_run", 2, "clamp", "plain"),
    ("engine_run", 2, "periodic", "plain"),
    ("engine_superstep", 2, "clamp", "plain"),
    ("engine_superstep", 3, "constant", "pipelined"),
    ("stencil_run", 3, "clamp", "pipelined"),
    ("stencil_run", 2, "clamp", "temporal"),
])
def test_legacy_shims_equal_the_front_door_on_the_card(cuda_device, shim,
                                                       ndim, boundary,
                                                       variant):
    """Each shim launches the front door's kernels, as many times, and
    its result equals the front door's at 0."""
    import warnings
    from repro_torch.backends import lower
    from repro_torch.core.temporal import StencilEngine
    from repro_torch.kernels import ops
    spec, coeffs, plan, grid = _legacy_case(cuda_device, ndim, boundary)
    steps = 4 * plan.par_time + plan.par_time + 1
    pipe = variant == "pipelined"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        engine = StencilEngine(spec=spec, coeffs=coeffs, plan=plan,
                               pipelined=pipe)  # legacy-ok
    if shim == "engine_run":
        got, counts = _counted(lambda: engine.run(grid, steps))
    elif shim == "engine_superstep":
        got, counts = _counted(lambda: engine.superstep(grid))
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            got, counts = _counted(lambda: ops.stencil_run(
                grid, spec, coeffs, plan, steps, variant=variant))
    if shim == "engine_superstep":
        low = lower(spec, plan, coeffs=coeffs,
                    backend="cuda-pipelined" if pipe else "cuda")
        want, front = _counted(lambda: low.superstep(grid))
    else:
        cs = repro_torch.stencil(spec, coeffs).compile(
            GRIDS[ndim], steps=steps, plan=plan, variant=variant)
        want, front = _counted(lambda: cs.run(grid))
    assert counts == front and counts
    assert torch.equal(got, want)


def test_audit_of_real_launches_is_clean(cuda_device):
    """A periodic run on the card: every launch recorded by ``data_ptr``
    (B1 and B2), no finding, and a warm loop moves no trace counter."""
    from repro_torch.lint.artifact import (audit_run, check_trace_budget,
                                           record_launches)
    spec, coeffs, plan, grid = _legacy_case(cuda_device, 2, "periodic")
    cs = repro_torch.stencil(spec, coeffs).compile(GRIDS[2], steps=5,
                                                   plan=plan)
    cs.run(grid)
    before = common.trace_counts()
    with record_launches() as log:
        out, diags = audit_run(cs.run, grid, expect_dtype="float32")
    assert diags == [] and out.device == grid.device
    assert {(la.kernel, la.route) for la in log.launches} == {
        ("padded_superstep", "cuda"), ("wrap_halo", "cuda")}
    for _ in range(5):
        cs.run(grid)
    assert check_trace_budget(common.trace_delta(before), 0) == []


def test_trace_count_reads_new_geometry_and_no_warm_work(cuda_device):
    """``common.trace_count`` on the card: after ``reset_trace_counts`` a
    warm run resolves nothing, while a new remainder and a new batch rank
    each add launch-geometry misses (the reference's ``run_call``
    question); a reset clears no cache, so the warm run after it reads 0
    again."""
    prog = repro_torch.StencilProgram(ndim=2, radius=1)
    plan = repro_torch.BlockPlan(spec=prog, block_shape=(16, 128),
                                 par_time=3)
    shape = (41, 157)                  # a shape no other test resolves
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    g = torch.rand(shape, generator=gen, device=cuda_device)
    geometry = ("queued_geometry", "streamed_geometry", "wrap_geometry")

    def resolved():
        return sum(common.trace_count(n) for n in geometry)

    cs = repro_torch.stencil(prog).compile(shape, steps=3 * 3 + 2, plan=plan)
    cs_b = repro_torch.stencil(prog).compile(shape, steps=3 * 3 + 2,
                                             plan=plan, batch=2)
    cs.run(g)
    common.reset_trace_counts()
    cs.run(g)
    cs.run(g, steps=5 * 3 + 2)             # the same remainder
    torch.cuda.synchronize()
    assert resolved() == 0
    assert common.trace_count("library_builds") == 0
    cs.run(g, steps=3 * 3 + 1)             # a new remainder
    torch.cuda.synchronize()
    after_rem = resolved()
    assert after_rem >= 1
    cs_b.run(torch.stack([g, g]))          # a new batch rank
    assert resolved() > after_rem
    common.reset_trace_counts()
    cs.run(g, steps=3 * 3 + 1)
    cs_b.run(torch.stack([g, g]))
    torch.cuda.synchronize()
    assert resolved() == 0


def test_audit_refuses_a_planted_alias_on_the_card(cuda_device):
    """B1 launched with dst = src (RP204), and with a dst that overlaps
    src by 128 cells (RP201), on the card."""
    import math
    from repro_torch.lint.artifact import analyze_launches, record_launches
    prog, plan, layout = _config(2, "clamp", shape="star")
    P = layout.padded_shape
    n = math.prod(P)
    c = prog.default_coeffs().to(cuda_device)
    src = torch.rand(P, device=cuda_device)
    with record_launches() as log:
        cuda.padded_superstep(src, src, c.center, c.taps, program=prog,
                              plan=plan, layout=layout)
    torch.cuda.synchronize()
    assert [d.code for d in analyze_launches(log.launches)] == ["RP204"]
    big = torch.rand(n + 128, device=cuda_device)
    with record_launches() as log:
        cuda.padded_superstep(big[:n].view(P), big[128:].view(P), c.center,
                              c.taps, program=prog, plan=plan,
                              layout=layout)
    torch.cuda.synchronize()
    assert [d.code for d in analyze_launches(log.launches)] == ["RP201"]
