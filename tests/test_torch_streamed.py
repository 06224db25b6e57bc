"""The streamed superstep kernels' geometry and plane order, on the CPU.

B3 (``temporal_superstep``) and B4 (``padded_pipelined``) stream a column
tile plane by plane through one ring of planes per fused step
(``csrc/streamed_superstep.cu``).  A CUDA kernel has no CPU mode, so this
file checks what surrounds it:

* the host geometry (``kernels/streamed.py``): segments, column tiles,
  stage extents and overlaps, and the shared memory the pre-flight counts;
* a torch replay of the kernel's schedule (a model kept here, not used by
  the package): the same plane groups, ring slots, clamped loads, in-plane
  ghost cells computed at the clamped coordinate, ghost-plane copies at
  both ends and the order of the copies (group i + 1 in flight while
  group i computes).  Rings start as NaN, so a read of a
  slot the schedule never filled shows.  On tiny grids it must equal
  ``common.padded_superstep_plain`` bit for bit, and so the JAX reference's
  padded superstep (interpret mode) at ``ULP``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.blocking import BlockPlan as RefPlan
from repro.core.program import StencilProgram as RefProgram
from repro.kernels import common as ref_common

import repro_torch
from repro_torch import convert
from repro_torch.analysis.hw import H100_SXM
from repro_torch.configs import stencil2d, stencil3d
from repro_torch.core.blocking import (TEMPORAL_CHUNK, round_up,
                                       streamed_rings, streamed_smem_bytes)
from repro_torch.core.codegen import boundary_pad
from repro_torch.kernels import common, cuda, streamed
from repro_torch.lint.verify import smem_diagnostics

ULP = dict(atol=1e-6, rtol=1e-5)
LIMIT = H100_SXM.smem_optin
GRIDS = {2: (13, 75), 3: (9, 11, 70)}
BLOCKS = {2: (8, 32), 3: (4, 8, 32)}


def _program(ndim, boundary, shape="star", radius=2, dtype="float32"):
    return repro_torch.StencilProgram(ndim=ndim, radius=radius, shape=shape,
                                      boundary=boundary, boundary_value=0.25,
                                      dtype=dtype)


def _layout(prog, steps, grid, ring=None):
    """A padded layout whose ring holds ``ring`` (default ``steps * r``)."""
    plan = repro_torch.BlockPlan(spec=prog, block_shape=BLOCKS[prog.ndim],
                                 par_time=steps)
    lay = common.ring_schedule(prog, plan, grid, steps).layout
    if ring is not None:
        lay = dataclasses.replace(lay, halo=ring)
    return plan, lay


# ---- the torch replay of the kernel's schedule --------------------------------


def _clamp(v, lo, hi):
    return max(lo, min(hi, v))


def replay(program, center, taps, src, geo: streamed.StreamedGeometry):
    """Run ``geo``'s launch the way every CTA of the kernel does, one work
    item after another; returns the output (the carry: true cells written,
    the rest zero; pre-padded: the rounded grid)."""
    nd = program.ndim
    batched = src.ndim > nd
    s3 = src if batched else src[None]
    if nd == 2:
        s3 = s3[:, :, None, :]                  # (batch, Y, 1, X)
    out = torch.zeros((s3.shape[0],) + geo.dst, dtype=src.dtype)
    coef = torch.cat([center.reshape(1), taps.reshape(-1)])
    offs = streamed.streamed_taps(program)
    rings_geo = geo.rings
    E1, E2 = rings_geo.plane
    B, D0, D = rings_geo.group, rings_geo.depth0, rings_geo.depth
    T, (r0, r1, r2) = geo.steps, geo.radii
    h0, h1, h2 = geo.halo
    n0, n1, n2 = geo.true
    o0, o1, o2 = geo.origin
    bnd, bval = program.boundary, float(program.boundary_value)
    raw = bnd == "periodic" or geo.prepadded
    ty, tx = geo.tile
    tys, txs = geo.tiles
    zero = -o0                                  # local plane of global 0

    for lin in range(geo.total):
        xi = lin % txs
        yi = (lin // txs) % tys
        si = (lin // (txs * tys)) % geo.segments
        b = lin // (txs * tys * geo.segments)
        a, e = geo.segment_bounds(si)
        y0, x0 = yi * ty, xi * tx
        ly0, lx0 = y0 - h1, x0 - h2             # local
        gy0, gx0 = ly0 + o1, lx0 + o2           # global
        z0, zend = a - h0, e + h0
        rings = [torch.full((D0 if s == 0 else D, E1, E2), float("nan"),
                            dtype=src.dtype) for s in range(T)]

        def load(lo, hi):
            # the carry's mapping at global coordinates (origin + local:
            # a mesh shard's carry; origin 0 on one device)
            gy = ly0 + torch.arange(E1)
            gx = lx0 + torch.arange(E2)
            for z in range(lo, min(hi, zend)):
                gz, ys, xs = z, gy, gx
                if bnd == "clamp" and not raw:
                    gz = _clamp(z + o0, 0, n0 - 1) - o0
                    ys = (gy + o1).clamp(0, n1 - 1) - o1
                    xs = (gx + o2).clamp(0, n2 - 1) - o2
                pz = gz + geo.src_off[0]
                py, px = ys + geo.src_off[1], xs + geo.src_off[2]
                ok = ((py >= 0) & (py < geo.src[1]))[:, None] & \
                    ((px >= 0) & (px < geo.src[2]))[None, :]
                ok &= 0 <= pz < geo.src[0]
                plane = torch.where(
                    ok, s3[b, _clamp(pz, 0, geo.src[0] - 1)][
                        py.clamp(0, geo.src[1] - 1)[:, None],
                        px.clamp(0, geo.src[2] - 1)[None, :]],
                    torch.tensor(0.0))
                if bnd == "constant" and not raw:
                    out_ = ((gy + o1 < 0) | (gy + o1 >= n1))[:, None] | \
                        ((gx + o2 < 0) | (gx + o2 >= n2))[None, :]
                    out_ |= not 0 <= z + o0 < n0
                    plane = torch.where(out_, torch.tensor(bval), plane)
                rings[0][(z - z0) % D0] = plane

        iters = geo.iterations(a, e)
        assert iters == -(-(e - a + 2 * h0) // B)
        load(z0, z0 + B)
        for i in range(iters):
            g_lo = z0 + (i + 1) * B
            load(g_lo, g_lo + B)
            for s in range(1, T + 1):
                last = s == T
                grow = (T - s) * r0
                lo = max(z0 + i * B - s * r0, a - grow)
                hi = min(z0 + i * B - s * r0 + B, e + grow)
                if lo >= hi:
                    continue
                top = n0 - o0
                if geo.prepadded and bnd == "clamp" and top <= a - grow:
                    top = a - grow + 1
                clo, chi = lo, hi
                if not last and bnd != "periodic":
                    clo, chi = max(lo, zero), min(hi, top)
                src_ring = rings[s - 1]
                depth = D0 if s == 1 else D
                if last:
                    ylo, yhi = h1, h1 + min(ty, geo.written[1] - y0)
                    xlo, xhi = h2, h2 + min(tx, geo.written[2] - x0)
                else:
                    ylo, yhi = s * r1, E1 - s * r1
                    xlo, xhi = s * r2, E2 - s * r2
                for q in range(clo, chi):
                    ys = torch.arange(ylo, yhi)
                    xs = torch.arange(xlo, xhi)
                    gy, gx = gy0 + ys, gx0 + xs
                    my, mx = ys, xs
                    if not last and bnd == "clamp":
                        my = (gy.clamp(0, n1 - 1) - gy0).clamp(ylo, yhi - 1)
                        mx = (gx.clamp(0, n2 - 1) - gx0).clamp(xlo, xhi - 1)
                    acc = None
                    for k, (dz, dy, dx) in enumerate(offs):
                        val = src_ring[(q + dz - z0) % depth][
                            (my + dy)[:, None], (mx + dx)[None, :]]
                        term = coef[k] * val
                        acc = term if acc is None else acc + term
                    if not last and bnd == "constant":
                        outside = ((gy < 0) | (gy >= n1))[:, None] | \
                            ((gx < 0) | (gx >= n2))[None, :]
                        acc = torch.where(outside, torch.tensor(bval), acc)
                    if last:
                        out[b, q + geo.dst_off[0],
                            (ly0 + ys + geo.dst_off[1])[:, None],
                            (lx0 + xs + geo.dst_off[2])[None, :]] = acc
                    else:
                        rings[s][(q - z0) % D, ylo:yhi, xlo:xhi] = acc
                # ghost planes in this group, or plane 0 whose copies are
                # the ghost planes below it (due in an earlier group)
                if last or bnd == "periodic" or (
                        clo == lo and chi == hi
                        and not (lo <= zero < hi and a - grow < zero)):
                    continue
                ring = rings[s]

                def ghost(to, frm):
                    assert to >= z0 and (frm is None or frm >= z0)
                    tgt = ring[(to - z0) % D, ylo:yhi, xlo:xhi]
                    if frm is None:
                        tgt.fill_(bval)
                    else:
                        tgt.copy_(ring[(frm - z0) % D, ylo:yhi, xlo:xhi])

                if bnd == "constant":
                    for q in range(lo, hi):
                        if q < zero or q >= top:
                            ghost(q, None)
                    continue
                if lo <= zero < hi:
                    for q in range(max(a - grow, zero - r0), zero):
                        ghost(q, zero)
                # the carry's next stage reads r planes above the grid
                qend = hi if geo.prepadded else min(hi, top + r0)
                for q in range(max(lo, top), qend):
                    ghost(q, q - 1)
    if nd == 2:
        out = out[:, :, 0, :]
    return out if batched else out[0]


def _case(ndim, boundary, shape, radius, steps, *, tile=None,
          segment=None, ring=None, seed=0, dtype="float32"):
    prog = _program(ndim, boundary, shape, radius, dtype)
    grid = GRIDS[ndim]
    plan, lay = _layout(prog, steps, grid, ring)
    rng = np.random.RandomState(seed)
    src = torch.from_numpy(rng.uniform(
        -1, 1, (2,) + lay.padded_shape).astype(np.float32)).to(
        getattr(torch, dtype))
    if lay.wrap_axes:
        common.refresh_wrap_halo_plain(src, lay)
    coeffs = prog.default_coeffs(seed=seed)
    geo = streamed.carry_geometry(prog, steps, lay, batch=2,
                                  smem_limit=LIMIT,
                                  tile=tile, segment=segment)
    return prog, plan, lay, src, coeffs, geo


def _interior(lay):
    return (Ellipsis,) + tuple(slice(lay.halo, lay.halo + n)
                               for n in lay.local_shape)


#: (shape, radius, steps, tile, segment): segments shorter than 2h, ragged
#: last segments and ragged column tiles (grid x 75 / 70 over tile x 32).
REPLAYS = [
    ("star", 1, 1, None, None),
    ("star", 1, 4, None, 3),
    ("box", 1, 3, None, 4),
    ("star", 2, 2, None, 5),
    ("box", 2, 1, None, 2),
    ("star", 3, 1, None, 4),
    ("box", 3, 2, None, 6),
]


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("boundary", ["clamp", "constant", "periodic"])
@pytest.mark.parametrize("shape,radius,steps,tile,segment", REPLAYS)
def test_replay_equals_plain_superstep(ndim, boundary, shape, radius, steps,
                                       tile, segment):
    """Batch 2, at a narrow column tile so the columns are ragged."""
    if ndim == 3 and shape == "box" and radius == 3 and steps == 2:
        steps = 1              # 343 taps: keep the replay quick
    narrow = (32,) if ndim == 2 else (2, 32)
    prog, plan, lay, src, coeffs, geo = _case(
        ndim, boundary, shape, radius, steps, tile=tile or narrow,
        segment=segment)
    got = replay(prog, coeffs.center, coeffs.taps, src, geo)
    want = common.padded_superstep_plain(
        src, torch.zeros_like(src), coeffs.center, coeffs.taps,
        program=prog, plan=plan, layout=lay)
    ix = _interior(lay)
    assert not torch.isnan(got[ix]).any()
    torch.testing.assert_close(got[ix], want[ix], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("boundary", ["clamp", "constant", "periodic"])
@pytest.mark.parametrize("shape,radius,steps,tile,segment", REPLAYS[1:4])
def test_replay_in_16_bits_equals_plain_superstep(dtype, ndim, boundary,
                                                  shape, radius, steps,
                                                  tile, segment):
    """A 16-bit carry, batch 2, at a narrow column tile: the rings of
    2-byte cells (pitch a multiple of 8 cells) and the rounding after
    every multiply and add give the plain version bit for bit."""
    narrow = (32,) if ndim == 2 else (2, 32)
    prog, plan, lay, src, coeffs, geo = _case(
        ndim, boundary, shape, radius, steps, tile=tile or narrow,
        segment=segment, dtype=dtype)
    assert geo.itemsize == 2 and geo.rings.pitch % 8 == 0
    center, taps = common.grid_coeffs(coeffs.center, coeffs.taps, src)
    got = replay(prog, center, taps, src, geo)
    want = common.padded_superstep_plain(
        src, torch.zeros_like(src), coeffs.center, coeffs.taps,
        program=prog, plan=plan, layout=lay)
    ix = _interior(lay)
    assert got.dtype == want.dtype == src.dtype
    torch.testing.assert_close(got[ix], want[ix], rtol=0, atol=0)


#: A shard's place along each axis for a local extent n in a global grid
#: of 3n: the last shard (a non-zero origin, its high side on the global
#: edge) and an inner one (no global edge).
SHARD_ORIGINS = {"last": 2, "inner": 1}


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("boundary", ["clamp", "periodic", "constant"])
@pytest.mark.parametrize("shape,radius,steps", [("box", 1, 2),
                                                ("diamond", 2, 1)])
@pytest.mark.parametrize("where", sorted(SHARD_ORIGINS))
def test_sharded_carry_replay_equals_plain_superstep(ndim, boundary, shape,
                                                     radius, steps, where):
    """B1/B4 on a mesh shard's carry (the sharded instantiation) against
    ``padded_superstep_plain`` with the same ``offsets`` and
    ``global_shape``, batch 2, short segments and ragged column tiles:
    bit for bit on the shard's true cells."""
    prog = _program(ndim, boundary, shape, radius)
    local = GRIDS[ndim]
    plan = repro_torch.BlockPlan(spec=prog, block_shape=local,
                                 par_time=steps)
    global_shape = tuple(3 * n for n in local)
    lay = common.ring_schedule(prog, plan, global_shape, steps,
                               decomp=(3,) * ndim).layout
    offsets = tuple(SHARD_ORIGINS[where] * n for n in local)
    rng = np.random.RandomState(radius)
    src = torch.from_numpy(rng.uniform(
        -1, 1, (2,) + lay.padded_shape).astype(np.float32))
    coeffs = prog.default_coeffs(seed=radius)
    geo = streamed.carry_geometry(
        prog, steps, lay, batch=2, smem_limit=LIMIT, segment=3,
        tile=(32,) if ndim == 2 else (2, 32), origin=offsets,
        true_shape=global_shape)
    assert geo.sharded and not geo.prepadded
    assert geo.array()[-1] == 1 and geo.array()[-2] == 0
    got = replay(prog, coeffs.center, coeffs.taps, src, geo)
    want = common.padded_superstep_plain(
        src, torch.zeros_like(src), coeffs.center, coeffs.taps,
        program=prog, plan=plan, layout=lay, offsets=offsets,
        global_shape=global_shape)
    ix = _interior(lay)
    assert not torch.isnan(got[ix]).any()
    torch.testing.assert_close(got[ix], want[ix], rtol=0, atol=0)


def _prepadded_case(ndim, boundary, shape, radius, steps, offsets, seed=0,
                    **geometry):
    prog = _program(ndim, boundary, shape, radius)
    plan = repro_torch.BlockPlan(spec=prog, block_shape=BLOCKS[ndim],
                                 par_time=steps)
    n = GRIDS[ndim]
    h = plan.halo
    rounded = tuple(round_up(s, b) for s, b in zip(n, BLOCKS[ndim]))
    rng = np.random.RandomState(seed)
    grid = torch.from_numpy(rng.uniform(-1, 1, (2,) + n).astype(np.float32))
    padded = boundary_pad(prog, grid, [(0, 0)] + [
        (h, r - s + h) for s, r in zip(n, rounded)]).contiguous()
    true_shape = tuple(s + 2 * o for s, o in zip(n, offsets))
    coeffs = prog.default_coeffs(seed=seed)
    geo = streamed.prepadded_geometry(
        prog, steps, tuple(padded.shape[-ndim:]), true_shape, offsets,
        batch=2, smem_limit=LIMIT, **geometry)
    return prog, plan, padded, true_shape, coeffs, geo


#: The tap sets without a register-queue form that B5 and B6 run on the
#: streamed kernel's pre-padded mode: a box, a diamond, and a star deeper
#: than its queues.
PREPADDED = [("box", 1, 2), ("diamond", 2, 1), ("star", 1, 5)]


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("boundary", ["clamp", "constant", "periodic"])
@pytest.mark.parametrize("shape,radius,steps", PREPADDED)
@pytest.mark.parametrize("offsets", ["zero", "shard"])
def test_prepadded_replay_equals_plain_superstep(ndim, boundary, shape,
                                                 radius, steps, offsets):
    """The pre-padded mode (B5, B6), batch 2, ragged tiles and short
    segments: a single grid, or a shard at offsets 3 in a global grid 3
    wider on each side (so the boundary acts past the shard's padding).
    Every cell of the rounded output is written and finite; it equals
    ``superstep_plain`` bit for bit on the shard's true cells, and on
    every cell but under clamp (whose clamped cell a tile wholly past the
    grid does not hold)."""
    offs = (0,) * ndim if offsets == "zero" else (3,) * ndim
    prog, plan, padded, true_shape, coeffs, geo = _prepadded_case(
        ndim, boundary, shape, radius, steps, offs, segment=4,
        tile=(24,) if ndim == 2 else (3, 24))
    assert geo.prepadded and geo.origin == ((offs[0], 0, offs[1])
                                            if ndim == 2 else offs)
    got = replay(prog, coeffs.center, coeffs.taps, padded, geo)
    want = common.superstep_plain(padded, coeffs.center, coeffs.taps,
                                  program=prog, plan=plan,
                                  true_shape=true_shape, offsets=offs)
    assert got.shape == want.shape and not torch.isnan(got).any()
    ix = (Ellipsis,) + tuple(slice(0, s) for s in GRIDS[ndim])
    torch.testing.assert_close(got[ix], want[ix], rtol=0, atol=0)
    if boundary != "clamp":
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("boundary", ["clamp", "constant", "periodic"])
def test_replay_in_a_deep_ring_matches_jax_reference(ndim, boundary):
    """A temporal-like launch (2 steps read at offset H - h of a ring twice
    as deep) against the reference's padded superstep in interpret mode."""
    steps, radius = 2, 1
    prog, plan, lay, src, coeffs, geo = _case(
        ndim, boundary, "box", radius, steps, segment=3,
        ring=2 * steps * radius, tile=(32,) if ndim == 2 else (4, 32))
    got = replay(prog, coeffs.center, coeffs.taps, src, geo)
    rp = RefProgram(ndim=ndim, radius=radius, shape="box", boundary=boundary,
                    boundary_value=0.25)
    rplan = RefPlan(spec=rp, block_shape=BLOCKS[ndim], par_time=steps)
    rlay = ref_common.PaddedLayout(
        halo=lay.halo, local_shape=lay.local_shape, rounded=lay.rounded,
        wrap_axes=lay.wrap_axes)
    rc = rp.default_coeffs(seed=0)
    _, rout = ref_common._padded_superstep_pallas(
        jnp.asarray(src.numpy()), jnp.zeros(src.shape, jnp.float32),
        rc.center, rc.taps, program=rp, plan=rplan, layout=rlay,
        global_shape=GRIDS[ndim], interpret=True)
    ix = _interior(lay)
    np.testing.assert_allclose(got[ix].numpy(), np.asarray(rout)[ix], **ULP)


# ---- the host geometry ---------------------------------------------------------


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("segment", [1, 3, 4, 20])
@pytest.mark.parametrize("steps", [1, 3])
def test_segments_and_columns_cover_written_once(ndim, segment, steps):
    prog = _program(ndim, "clamp", radius=2)
    _, lay = _layout(prog, steps, GRIDS[ndim])
    geo = streamed.carry_geometry(prog, steps, lay, batch=2,
                                  smem_limit=LIMIT,
                                  tile=(32,) if ndim == 2 else (4, 32),
                                  segment=segment)
    n = geo.written
    cover = np.zeros(n[0], int)
    for k in range(geo.segments):
        a, e = geo.segment_bounds(k)
        assert 0 <= a < e <= n[0] and e - a <= segment
        cover[a:e] += 1
    assert (cover == 1).all()
    for axis, (count, t) in enumerate(zip(geo.tiles, geo.tile)):
        assert (count - 1) * t < n[axis + 1] <= count * t
    assert geo.total == 2 * geo.segments * geo.tiles[0] * geo.tiles[1]
    # a segment shorter than 2h still walks all its planes
    h = geo.halo[0]
    a, e = geo.segment_bounds(geo.segments - 1)
    assert geo.iterations(a, e) * geo.rings.group >= e - a + 2 * h


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("radius,steps", [(1, 4), (2, 2), (3, 1), (4, 8)])
def test_stages_shrink_by_radius_and_overlap_by_halo(ndim, radius, steps):
    if ndim == 3 and radius * steps > 8:
        steps = 1              # a 3D deep halo of 32 fits no column tile
    prog = _program(ndim, "periodic", radius=radius)
    grid = (40, 200) if ndim == 2 else (40, 30, 200)
    _, lay = _layout(prog, steps, grid)
    geo = streamed.carry_geometry(prog, steps, lay, batch=1,
                                  smem_limit=LIMIT, segment=7)
    h = steps * radius
    assert geo.halo == (h, 0 if ndim == 2 else h, h)
    ry = 0 if ndim == 2 else radius
    for s in range(steps + 1):
        e1, e2 = geo.stage_extent(s)
        assert (e1, e2) == (geo.tile[0] + 2 * (h if ndim == 3 else 0)
                            - 2 * s * ry, geo.tile[1] + 2 * h - 2 * s * radius)
    assert geo.stage_extent(steps) == tuple(geo.tile)
    for k in range(geo.segments):
        a, e = geo.segment_bounds(k)
        for s in range(steps + 1):
            lo, hi = geo.stage_planes(a, e, s)
            assert (a - lo, hi - e) == ((steps - s) * radius,) * 2
        # neighbouring segments overlap by h on each side through stage 0
        lo, hi = geo.stage_planes(a, e, 0)
        assert (a - lo, hi - e) == (h, h)


def test_geometry_array_order():
    prog = _program(3, "clamp", radius=2)
    _, lay = _layout(prog, 2, GRIDS[3])
    geo = streamed.carry_geometry(prog, 2, lay, batch=3,
                                  smem_limit=LIMIT, tile=(4, 32), segment=5)
    a = geo.array()
    H = lay.halo
    assert len(a) == 33
    assert a[:3] == list(GRIDS[3]) and a[3:6] == list(lay.padded_shape)
    assert a[6:9] == [H] * 3 and a[12:15] == [H] * 3
    assert a[15:18] == list(GRIDS[3]) and a[18:21] == [0, 0, 0]
    assert a[21:24] == [2, 2, 2] and a[24:27] == [5, 4, 32]
    # the launcher sizes the rings itself and refuses a different count
    assert a[27:30] == [geo.rings.group, 2, geo.smem_bytes]
    assert geo.smem_bytes == geo.rings.bytes(prog.num_taps) == \
        streamed_smem_bytes(3, 2, prog.num_taps, 2, (4, 32))
    assert a[30:] == [1, 0, 0]           # a star: fixed offsets; the carry
    box = _program(3, "clamp", "box", radius=2)
    assert streamed.carry_geometry(box, 2, lay, batch=1,
                                   smem_limit=LIMIT).array()[30] == 0
    # pre-padded: a shard of a global grid, source index h of local 0,
    # every cell of the rounded grid written from output index 0
    shard = streamed.prepadded_geometry(box, 2, (12, 20, 40), (30, 30, 30),
                                        (5, 6, 7), batch=1, smem_limit=LIMIT)
    b = shard.array()
    assert b[:3] == [30, 30, 30] and b[3:6] == [12, 20, 40]
    assert b[6:9] == [4, 4, 4] and b[9:12] == [4, 12, 32]
    assert b[12:15] == [0, 0, 0] and b[15:18] == [4, 12, 32]
    assert b[18:21] == [5, 6, 7] and b[30:] == [0, 1, 0]
    with pytest.raises(ValueError, match="offsets"):
        streamed.prepadded_geometry(box, 2, (12, 20, 40), (30, 30, 30),
                                    (5, -1, 7), batch=1, smem_limit=LIMIT)


def test_two_d_geometry_has_a_dummy_y():
    prog = _program(2, "constant", radius=3)
    _, lay = _layout(prog, 2, GRIDS[2])
    geo = streamed.carry_geometry(prog, 2, lay, batch=1, smem_limit=LIMIT,
                                  tile=(64,))
    assert geo.true == (13, 1, 75) and geo.radii == (3, 0, 3)
    assert geo.tile == (1, 64) and geo.src_off == (lay.halo, 0, lay.halo)
    assert geo.rings.plane == (1, 64 + 12)
    assert streamed.streamed_taps(prog)[1:] == [
        (o[0], 0, o[1]) for o in prog.neighbor_taps]


def test_ring_layout_counts_planes_and_tables():
    """Ring s is clipped to stage s's region (r fewer cells per side per
    stage on each blocked axis, rows padded to 4 floats); each ring row has
    a row of tap offsets; the coefficients come last."""
    rings = streamed_rings(2, 4, 8, (224,))
    assert rings.plane == (1, 288) and rings.pitch == 288
    # a 2D group is always 4 row-planes, one per output of a thread; the
    # loaded ring holds one more group, the copy in flight
    assert rings.group == 4 and rings.depth == 12 and rings.depth0 == 16
    assert [rings.stage_plane(s) for s in (0, 1, 7)] == [
        (1, 288), (1, 280), (1, 232)]
    ntaps = 17
    cells = 16 * 288 + sum(12 * (288 - 8 * s) for s in range(1, 8))
    assert rings.bytes(ntaps) == 4 * cells + 4 * ntaps * (16 + 7 * 12 + 1)
    assert streamed_rings(2, 1, 4, (992,)).group == 4
    # 3D: groups of 2 planes; (24, 104) then (20, 100 -> 100) ...
    deep = streamed_rings(3, 2, 4, (8, 32))
    assert deep.group == 2 and (deep.depth0, deep.depth) == (8, 6)
    assert [deep.stage_plane(s) for s in range(4)] == [
        (24, 48), (20, 44), (16, 40), (12, 36)]
    assert streamed_smem_bytes(3, 2, 13, 4, (8, 32)) == \
        4 * (8 * 24 * 48 + 6 * (20 * 44 + 16 * 40 + 12 * 36)) + \
        4 * 13 * (8 + 3 * 6 + 1)
    pre = streamed_rings(3, 4, 1, (16, 96))
    assert pre.plane == (24, 104) and pre.group == 2
    assert (pre.depth, pre.depth0, pre.ring_planes) == (10, 12, 12)


#: the streamed picks at the main path's shapes
PICKS = {"2d_r4_paper": (448,), "3d_r2_paper": (32, 32),
         "3d_r4_paper": (32, 96), "2d_box_periodic_pod": (992,)}
#: the CTA tiles of the whole-window B3 and B4 at these shapes (PERF.md)
WINDOW_TILES = {"2d_r4_paper": (32, 32), "3d_r2_paper": (8, 8, 32),
                "3d_r4_paper": (8, 4, 32), "2d_box_periodic_pod": (64, 64)}


@pytest.mark.parametrize("name,variant", [
    ("2d_r4_paper", "temporal"), ("3d_r2_paper", "temporal"),
    ("3d_r4_paper", "pipelined"), ("2d_box_periodic_pod", "pipelined")])
def test_streamed_picks_of_the_paper_plans_fit(name, variant):
    """The main path's B3 and B4 shapes: the pick fits the card, has the
    least column cost of all the tiles that fit, and computes fewer cells
    per output than the whole-window kernel did."""
    works = {**stencil2d.workloads(), **stencil3d.workloads()}
    work = works[name]
    plan = work.plan()
    if name == "3d_r2_paper":
        plan = dataclasses.replace(plan, par_time=1)
    kernel = {"temporal": "temporal_superstep",
              "pipelined": "padded_pipelined"}[variant]
    tile = cuda.pick_tile(plan, kernel, LIMIT)
    assert len(tile) == plan.program.ndim - 1 and tile[-1] % 32 == 0
    assert tile == PICKS[name]
    assert plan.smem_bytes_for(tile, kernel) <= LIMIT
    steps = plan.kernel_steps(kernel)
    nd, r = plan.program.ndim, plan.program.halo_radius
    cost = streamed.column_cost(nd, r, steps, tile)
    assert cost == min(
        streamed.column_cost(nd, r, steps, t)
        for t in streamed._candidates(nd)
        if plan.smem_bytes_for(t, kernel) <= LIMIT)
    # the whole-window kernel at its tile grew every axis by the halo,
    # the streamed one only the blocked axes
    assert cost < streamed.column_cost(nd, r, steps, WINDOW_TILES[name])
    assert smem_diagnostics(plan, variant, H100_SXM,
                            grid_shape=work.grid_shape, steps=9) == []


def test_temporal_remainder_counts_as_the_window_kernel():
    """A temporal run launches B3 for its chunks and B1 for the
    remainder; RP105 counts each with its own formula."""
    prog = _program(2, "clamp", radius=2)
    plan = repro_torch.BlockPlan(spec=prog, block_shape=(16, 128),
                                 par_time=2)
    got = common.run_kernels(prog, plan, (37, 150), 11, "temporal")
    assert [(k, p.par_time) for k, p in got] == [
        ("temporal_superstep", 2), ("padded_superstep", 3)]
    assert plan.kernel_steps("temporal_superstep") == TEMPORAL_CHUNK * 2
    assert [(k, p.par_time) for k, p in common.run_kernels(
        prog, plan, variant="temporal")] == [
        ("temporal_superstep", 2), ("padded_superstep", 7)]
    per = repro_torch.StencilProgram(ndim=3, radius=2, boundary="periodic")
    pplan = repro_torch.BlockPlan(spec=per, block_shape=(8, 16, 128),
                                  par_time=1)
    deg = common.run_kernels(per, pplan, (9, 18, 140), 6, "temporal")
    assert [(k, p.par_time) for k, p in deg] == [("superstep", 4),
                                                 ("superstep", 2)]


#: the kernel each entry point launches, by variant (``kernels/cuda.py``)
_CARRY = {"plain": "padded_superstep", "temporal": "temporal_superstep",
          "pipelined": "padded_pipelined"}
_PREPADDED = {"plain": "superstep", "pipelined": "pipelined_superstep"}


@pytest.mark.parametrize("variant", ["plain", "temporal", "pipelined"])
@pytest.mark.parametrize("boundary,grid", [
    ("clamp", (37, 150)), ("periodic", (37, 150)),
    ("periodic", (3, 150))])          # the last is wrap-degenerate
@pytest.mark.parametrize("steps", [1, 8, 11])
def test_run_kernels_are_what_run_call_launches(monkeypatch, variant,
                                                boundary, grid, steps):
    """What RP105 sizes (``run_kernels``) is what ``run_call`` launches:
    every superstep call of a CPU run, recorded, names the same kernels
    with the same plans, and their count is the schedule's."""
    prog = _program(2, boundary, radius=1)
    plan = repro_torch.BlockPlan(spec=prog, block_shape=(8, 32), par_time=2)
    called = []
    real_carry, real_pre = common.padded_superstep, common.pad_superstep

    def carry(*a, plan, variant=None, **k):
        called.append((_CARRY[variant or "plain"], plan))
        return real_carry(*a, plan=plan, variant=variant, **k)

    def pre(*a, plan, variant=None, **k):
        called.append((_PREPADDED[variant or "plain"], plan))
        return real_pre(*a, plan=plan, variant=variant, **k)

    monkeypatch.setattr(common, "padded_superstep", carry)
    monkeypatch.setattr(common, "pad_superstep", pre)
    period = plan.par_time * (TEMPORAL_CHUNK if variant == "temporal"
                              else 1)
    full, rem = divmod(steps, period)
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        grid).astype(np.float32))
    c = prog.default_coeffs(seed=1)
    common.run_call(g, c.center, c.taps, full, program=prog, plan=plan,
                    true_shape=grid, rem=rem, variant=variant)
    degenerate = common.ring_schedule(prog, plan, grid, steps,
                                      variant=variant).fallback
    assert degenerate == (grid == (3, 150))
    assert tuple(dict.fromkeys(called)) == common.run_kernels(
        prog, plan, grid, steps, variant)
    sched = common.ring_schedule(prog, plan, grid, steps, variant=variant)
    assert len(called) == sum(n for *_, n in common.run_launches(sched))
    assert len(called) == (-(-steps // period) if degenerate
                           else full + (rem > 0))
