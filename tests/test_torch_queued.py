"""The register-queued superstep kernels' geometry and plane order, on the
CPU.

B1 (``padded_superstep``), B5 (``superstep``) and B6
(``pipelined_superstep``) stream a column tile plane by plane
(``csrc/queued_superstep.cu``) for stars within ``QUEUE_STEPS``: each
stage's streamed-axis neighbours in per-thread register queues and only a
centre plane per stage in shared memory (every other tap set runs the
streamed kernel, ``tests/test_torch_streamed.py``).  A CUDA kernel has no
CPU mode, so this file checks what surrounds it:

* the host geometry (``kernels/queued.py``, ``blocking.QueuedPlanes``):
  segments, tiles, the threads' strips, and the shared memory that the
  tile pick, RP105 and the launcher count;
* a torch replay of the kernel's schedule (a model kept here, not used by
  the package): the loader's ring slots ``ahead`` planes in front and
  across work items, the queues' pushes, the double-buffered centre
  planes, the ghost-cell copies, the ghost-plane rules.  Rings, queues
  and centre planes start as NaN and a stage's values outside its region
  are NaN, so a read of anything the kernel leaves unspecified shows.  On
  tiny grids it must equal ``common.padded_superstep_plain`` (B1) or
  ``common.superstep_plain`` (B5, B6) bit for bit, and so the JAX
  reference's padded superstep (interpret mode) at ``ULP``.
"""

import dataclasses
import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.blocking import BlockPlan as RefPlan
from repro.core.program import StencilProgram as RefProgram
from repro.kernels import common as ref_common

import repro_torch
from repro_torch.analysis.hw import H100_SXM
from repro_torch.configs import stencil2d, stencil3d
from repro_torch.core.blocking import (QUEUE_STEPS, QueuedPlanes,
                                       queue_path, queued_planes, round_up)
from repro_torch.core.codegen import boundary_pad
from repro_torch.kernels import common, cuda, queued, streamed
from repro_torch.lint.verify import smem_diagnostics

ULP = dict(atol=1e-6, rtol=1e-5)
LIMIT = H100_SXM.smem_optin
GRIDS = {2: (13, 75), 3: (9, 11, 70)}
BLOCKS = {2: (8, 32), 3: (4, 8, 32)}
NAN = float("nan")


def _program(ndim, boundary, shape="star", radius=2, dtype="float32"):
    return repro_torch.StencilProgram(ndim=ndim, radius=radius, shape=shape,
                                      boundary=boundary, boundary_value=0.25,
                                      dtype=dtype)


# ---- the torch replay of the kernel's schedule --------------------------------


def _clip(v, lo, hi):
    return max(lo, min(hi, v))


class _Replay:
    """One launch of ``geo`` run the way the kernel's CTAs run it:
    ``ctas`` CTAs (all resident for a persistent launch, else one per work
    item), each walking items ``lin = cta, cta + ctas, ...`` with its own
    loader, ring, queues and centre planes."""

    def __init__(self, program, center, taps, src, geo):
        self.p, self.geo = program, geo
        nd = program.ndim
        self.batched = src.ndim > nd
        s3 = src if self.batched else src[None]
        self.src = s3[:, :, None, :] if nd == 2 else s3
        self.dt = src.dtype
        self.out = torch.zeros((self.src.shape[0],) + geo.dst,
                               dtype=self.dt)
        self.coef = torch.cat([center.reshape(1), taps.reshape(-1)])
        self.offs = streamed.streamed_taps(program)
        planes = geo.planes
        self.E1, self.E2 = planes.extent
        self.D0, self.ahead = planes.depth0, planes.ahead
        self.bnd = program.boundary
        self.bval = float(program.boundary_value)

    # -- items and planes --

    def item(self, lin):
        g = self.geo
        tys, txs = g.tiles
        xi, yi = lin % txs, (lin // txs) % tys
        si = (lin // (txs * tys)) % g.segments
        b = lin // (txs * tys * g.segments)
        a, e = g.segment_bounds(si)
        return dict(b=b, a=a, e=e, y0=yi * g.tile[0], x0=xi * g.tile[1],
                    nload=e - a + 2 * g.halo[0])

    def load(self, it, k):
        """Stage-0 plane k of item ``it`` as ``issue_group`` fills it: the
        carry's mapping at global coordinates (``origin`` + local: a mesh
        shard's carry, the sharded instantiation; origin 0 on one
        device)."""
        g, E1, E2 = self.geo, self.E1, self.E2
        h0, h1, h2 = g.halo
        n0, n1, n2 = g.true
        oz, oy, ox = g.origin
        mapped = g.carry and self.bnd != "periodic"
        const = self.bnd == "constant"
        z = it["a"] - h0 + k
        if mapped and const and not 0 <= z + oz < n0:
            return torch.full((E1, E2), self.bval, dtype=self.dt)
        zs = _clip(z + oz, 0, n0 - 1) - oz if mapped else z
        pz = zs + g.src_off[0]
        gy = it["y0"] - h1 + torch.arange(E1)
        gx = it["x0"] - h2 + torch.arange(E2)
        row_fill = torch.zeros(E1, dtype=torch.bool)
        cell_fill = torch.zeros(E2, dtype=torch.bool)
        ys, xs = gy, gx
        if mapped:
            if const:
                row_fill = (gy + oy < 0) | (gy + oy >= n1)
                cell_fill = (gx + ox < 0) | (gx + ox >= n2)
            ys = (gy + oy).clamp(0, n1 - 1) - oy
            xs = (gx + ox).clamp(0, n2 - 1) - ox
        py, px = ys + g.src_off[1], xs + g.src_off[2]
        row_ok = (py >= 0) & (py < g.src[1]) & (0 <= pz < g.src[0])
        col_ok = (px >= 0) & (px < g.src[2])
        vals = self.src[it["b"], _clip(pz, 0, g.src[0] - 1)][
            py.clamp(0, g.src[1] - 1)[:, None],
            px.clamp(0, g.src[2] - 1)[None, :]]
        # cells past the source's end are not loaded: NaN shows a read
        plane = torch.where(row_ok[:, None] & col_ok[None, :], vals,
                            torch.tensor(NAN))
        plane = torch.where(row_ok[:, None] & cell_fill[None, :],
                            torch.tensor(self.bval), plane)
        return torch.where(row_fill[:, None], torch.tensor(self.bval), plane)

    # -- in-plane geometry of an item --

    def frame(self, it):
        g = self.geo
        gy0 = g.origin[1] + it["y0"] - g.halo[1]
        gx0 = g.origin[2] + it["x0"] - g.halo[2]
        gy = gy0 + torch.arange(self.E1)
        gx = gx0 + torch.arange(self.E2)
        outside = ((gy < 0) | (gy >= g.true[1]))[:, None] | \
            ((gx < 0) | (gx >= g.true[2]))[None, :]
        edge = bool(outside.any())
        return gy0, gx0, outside, edge

    def region(self, s):
        """Rows and columns of stage ``s``'s region (stage-0 coords)."""
        _, r1, r2 = self.geo.radii
        return (s * r1, self.E1 - s * r1), (s * r2, self.E2 - s * r2)

    def mask(self, vals, s):
        (ylo, yhi), (xlo, xhi) = self.region(s)
        out = torch.full_like(vals, NAN)
        out[ylo:yhi, xlo:xhi] = vals[ylo:yhi, xlo:xhi]
        return out

    def clamped(self, it, s, ylo, yhi, xlo, xhi):
        """Index maps (rows, cols) of the clamp mapping clipped into the
        region ``[ylo, yhi) x [xlo, xhi)``."""
        g = self.geo
        gy0, gx0, _, _ = self.frame(it)
        gy = gy0 + torch.arange(self.E1)
        gx = gx0 + torch.arange(self.E2)
        my = (gy.clamp(0, g.true[1] - 1) - gy0).clamp(ylo, yhi - 1)
        mx = (gx.clamp(0, g.true[2] - 1) - gx0).clamp(xlo, xhi - 1)
        return my, mx

    def store(self, it, p, vals):
        g = self.geo
        h0, h1, h2 = g.halo
        th = min(g.tile[0], g.written[1] - it["y0"])
        tw = min(g.tile[1], g.written[2] - it["x0"])
        y = it["y0"] + g.dst_off[1] + torch.arange(th)
        x = it["x0"] + g.dst_off[2] + torch.arange(tw)
        self.out[it["b"], p + g.dst_off[0], y[:, None], x[None, :]] = \
            vals[h1:h1 + th, h2:h2 + tw]

    def shifted(self, plane, dy, dx):
        """``plane`` read at offset (dy, dx), NaN past its extent."""
        E1, E2 = self.E1, self.E2
        out = torch.full((E1, E2), NAN, dtype=self.dt)
        ys = slice(max(0, -dy), min(E1, E1 - dy))
        xs = slice(max(0, -dx), min(E2, E2 - dx))
        yt = slice(max(0, dy), min(E1, E1 + dy))
        xt = slice(max(0, dx), min(E2, E2 + dx))
        out[ys, xs] = plane[yt, xt]
        return out

    # -- the launch --

    def run(self, ctas):
        g = self.geo
        for cta in range(ctas):
            lins = list(range(cta, g.total, ctas))
            if lins:
                self.queue_cta(lins)
        out = self.out[:, :, 0, :] if self.p.ndim == 2 else self.out
        return out if self.batched else out[0]

    def queue_cta(self, lins):
        g, D0, E1, E2 = self.geo, self.D0, self.E1, self.E2
        planes = g.planes
        T, r = g.steps, g.radius
        B, G, Q = planes.group, planes.groups, 3 * g.radius
        const, clamp = self.bnd == "constant", self.bnd == "clamp"
        ring = [torch.full((E1, E2), NAN, dtype=self.dt)
                for _ in range(D0)]
        cbuf = [[[torch.full((E1, E2), NAN, dtype=self.dt) for _ in range(B)]
                 for _ in range(2)] for _ in range(T - 1)]
        q = [[torch.full((E1, E2), NAN, dtype=self.dt) for _ in range(Q)]
             for _ in range(T)]
        in_regs = planes.stage0_in_registers
        groups = ((it, kg) for lin in lins for it in [self.item(lin)]
                  for kg in range(-(-it["nload"] // B)))
        issued = 0

        def issue():
            nonlocal issued
            nxt = next(groups, None)
            if nxt is not None:
                it, kg = nxt
                for j in range(B):
                    ring[(issued % G) * B + j] = self.load(it, kg * B + j)
                issued += 1

        for _ in range(self.ahead):
            issue()
        step = 0
        for lin in lins:
            it = self.item(lin)
            gy0, gx0, outside, edge = self.frame(it)
            for k in range(-(-it["nload"] // B)):
                z = it["a"] - g.halo[0] + k * B
                par = step & 1
                for s in range(1, T):
                    if k < 2 * (s + 1):
                        continue
                    for j in range(B):
                        cb = self.mask(q[s][2 * r + j], 1)
                        if const:
                            cb = self.mask(torch.where(
                                outside, torch.tensor(self.bval), cb), 1)
                        cbuf[s - 1][par][j] = cb
                assert issued > step          # the group has been issued
                if clamp and T > 1 and edge:
                    for s in range(1, T):
                        if k < 2 * (s + 1):
                            continue
                        (ylo, yhi), (xlo, xhi) = self.region(s)
                        my, mx = self.clamped(it, s, ylo, yhi, xlo, xhi)
                        ghost = outside.clone()
                        ghost[:ylo], ghost[yhi:] = False, False
                        ghost[:, :xlo], ghost[:, xhi:] = False, False
                        for j in range(B):
                            pl = cbuf[s - 1][par][j]
                            cbuf[s - 1][par][j] = torch.where(
                                ghost, pl[my[:, None], mx[None, :]], pl)
                issue()
                base = (step * B) % D0
                step += 1

                def loaded(d):
                    return ring[(base + d) % D0]

                if in_regs:
                    q[0] = q[0][B:] + [self.mask(loaded(j), 1)
                                       for j in range(B)]
                for s in range(1, T + 1):
                    if k < 2 * s:
                        continue
                    new = q[s][B:] + [None] * B if s < T else None
                    for j in range(B):
                        p = z - s * r + j
                        inp = loaded(j - r) if s == 1 else \
                            cbuf[s - 2][par][j]
                        acc = None
                        for kk, (dz, dy, dx) in enumerate(self.offs):
                            if dz == 0:
                                val = self.shifted(inp, dy, dx)
                            elif s > 1 or in_regs:
                                val = q[s - 1][r + j + dz]
                            else:              # stage 0 stays in the ring
                                val = loaded(j - r + dz)
                            term = self.coef[kk] * val
                            acc = term if acc is None else acc + term
                        if s == T:
                            if it["a"] <= p < it["e"]:
                                self.store(it, p, acc)
                            continue
                        acc = self.mask(acc, s)
                        gp = g.origin[0] + p
                        if const and not 0 <= gp < g.true[0]:
                            acc = self.mask(torch.full(
                                (E1, E2), self.bval, dtype=self.dt), s)
                        elif clamp and gp >= g.true[0]:
                            acc = new[Q - B + j - 1]
                        new[Q - B + j] = acc
                        if clamp and gp == 0:
                            for d in range(1, r + 1):
                                new[Q - B + j - d] = acc
                    if s < T:
                        q[s] = new


def replay(program, center, taps, src, geo, ctas=None):
    """The output of ``geo``'s launch (B1: the carry with only true cells
    written, the rest zero; B5, B6: the rounded grid)."""
    if ctas is None:
        ctas = 3 if geo.persistent else geo.total
    return _Replay(program, center, taps, src, geo).run(ctas)


# ---- B1, B5 and B6 cases -----------------------------------------------------


def _carry_case(ndim, boundary, shape, radius, steps, seed=0,
                dtype="float32", **geometry):
    prog = _program(ndim, boundary, shape, radius, dtype)
    plan = repro_torch.BlockPlan(spec=prog, block_shape=BLOCKS[ndim],
                                 par_time=steps)
    lay = common.ring_schedule(prog, plan, GRIDS[ndim], steps).layout
    rng = np.random.RandomState(seed)
    src = torch.from_numpy(rng.uniform(
        -1, 1, (2,) + lay.padded_shape).astype(np.float32)).to(
        getattr(torch, dtype))
    if lay.wrap_axes:
        common.refresh_wrap_halo_plain(src, lay)
    coeffs = prog.default_coeffs(seed=seed)
    geo = queued.carry_geometry(prog, steps, lay, batch=2, smem_limit=LIMIT,
                                **geometry)
    return prog, plan, lay, src, coeffs, geo


def _interior(lay):
    return (Ellipsis,) + tuple(slice(lay.halo, lay.halo + n)
                               for n in lay.local_shape)


#: (radius, steps) of the queue path: every radius at its deepest queue
#: (in 3D radius 4 at 1 step: ``QUEUE_STEPS``).
QUEUE_CASES = [(1, 4), (2, 3), (3, 1), (4, 2)]
#: tile/segment overrides: the pick; a segment shorter than 2h with a
#: ragged last one; ragged column tiles (x not dividing 75 / 70); small
#: tiles and segments (many work items, edge tiles on every side).
CORNERS = {
    "picked": {},
    "short-segment": {"segment": 3},
    "ragged-tile": {"tile": {2: (24,), 3: (3, 24)}},
    "small-tile": {"tile": {2: (32,), 3: (2, 32)}, "segment": 5},
}


def _corner(name, ndim):
    return {k: (v[ndim] if isinstance(v, dict) else v)
            for k, v in CORNERS[name].items()}


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("boundary", ["clamp", "constant", "periodic"])
@pytest.mark.parametrize("radius,steps", QUEUE_CASES)
@pytest.mark.parametrize("corner", list(CORNERS))
def test_queue_replay_equals_plain_superstep(ndim, boundary, radius, steps,
                                             corner):
    """B1's queue path, batch 2: bit for bit the plain version."""
    steps = min(steps, QUEUE_STEPS[ndim][radius])
    prog, plan, lay, src, coeffs, geo = _carry_case(
        ndim, boundary, "star", radius, steps, **_corner(corner, ndim))
    assert geo.carry and not geo.persistent
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
@pytest.mark.parametrize("radius,steps", [(1, 4), (3, 1)])
def test_queue_replay_in_16_bits_equals_plain_superstep(dtype, ndim,
                                                        boundary, radius,
                                                        steps):
    """B1's queue path on a 16-bit carry at the tile the 2-byte planes
    pick, batch 2: bit for bit the plain version (each multiply and add
    rounded to the grid's dtype on both sides)."""
    prog, plan, lay, src, coeffs, geo = _carry_case(
        ndim, boundary, "star", radius, steps, dtype=dtype)
    assert geo.itemsize == 2 and geo.pad in range(8, 16)
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
@pytest.mark.parametrize("radius,steps", [(1, 4), (2, 3), (4, 1)])
@pytest.mark.parametrize("where", sorted(SHARD_ORIGINS))
def test_sharded_carry_replay_equals_plain_superstep(ndim, boundary, radius,
                                                     steps, where):
    """B1 on a mesh shard's carry (the sharded instantiation: origin and
    the global extent in the geometry) against ``padded_superstep_plain``
    with the same ``offsets`` and ``global_shape``, batch 2, bit for bit;
    the ring is random, standing for exchanged cells and, past the global
    edge, for cells nothing wrote."""
    prog = _program(ndim, boundary, "star", radius)
    local = GRIDS[ndim]
    plan = repro_torch.BlockPlan(spec=prog, block_shape=local,
                                 par_time=steps)
    global_shape = tuple(3 * n for n in local)
    lay = common.ring_schedule(prog, plan, global_shape, steps,
                               decomp=(3,) * ndim).layout
    assert lay.local_shape == local
    offsets = tuple(SHARD_ORIGINS[where] * n for n in local)
    rng = np.random.RandomState(radius)
    src = torch.from_numpy(rng.uniform(
        -1, 1, (2,) + lay.padded_shape).astype(np.float32))
    coeffs = prog.default_coeffs(seed=radius)
    geo = queued.carry_geometry(prog, steps, lay, batch=2, smem_limit=LIMIT,
                                origin=offsets, true_shape=global_shape,
                                segment=5)
    assert geo.sharded and geo.array()[3 * 10 + 2] == 1
    got = replay(prog, coeffs.center, coeffs.taps, src, geo)
    want = common.padded_superstep_plain(
        src, torch.zeros_like(src), coeffs.center, coeffs.taps,
        program=prog, plan=plan, layout=lay, offsets=offsets,
        global_shape=global_shape)
    ix = _interior(lay)
    assert not torch.isnan(got[ix]).any()
    torch.testing.assert_close(got[ix], want[ix], rtol=0, atol=0)


def test_single_device_carry_is_not_sharded():
    prog = _program(2, "clamp")
    plan = repro_torch.BlockPlan(spec=prog, block_shape=BLOCKS[2],
                                 par_time=2)
    lay = common.ring_schedule(prog, plan, GRIDS[2], 2).layout
    geo = queued.carry_geometry(prog, 2, lay, batch=1, smem_limit=LIMIT)
    assert not geo.sharded and geo.origin == (0, 0, 0)
    # origin 0 and the local extent as the global one: still one device
    same = queued.carry_geometry(prog, 2, lay, batch=1, smem_limit=LIMIT,
                                 origin=(0, 0), true_shape=GRIDS[2])
    assert same == geo
    with pytest.raises(ValueError, match="inside the global grid"):
        queued.carry_geometry(prog, 2, lay, batch=1, smem_limit=LIMIT,
                              origin=(1, 0), true_shape=GRIDS[2])


def test_carry_geometry_takes_only_the_register_queues():
    """B1 runs tap sets without a register-queue form on the streamed
    kernel, so the queued carry geometry refuses them."""
    for shape, radius, steps in (("box", 1, 2), ("diamond", 2, 1),
                                 ("star", 1, 5)):
        with pytest.raises(ValueError, match="no register-queue form"):
            _carry_case(2, "clamp", shape, radius, steps)


def _prepadded_case(ndim, boundary, shape, radius, steps, offsets, seed=0,
                    persistent=True, **geometry):
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
    geo = queued.prepadded_geometry(prog, steps, padded.shape[-ndim:],
                                    true_shape, offsets, batch=2,
                                    smem_limit=LIMIT, persistent=persistent,
                                    **geometry)
    return prog, plan, padded, true_shape, coeffs, geo


#: B5's and B6's stars (the other tap sets run the streamed kernel's
#: pre-padded mode, ``tests/test_torch_streamed.py``).
PREPADDED = [("star", 2, 3), ("star", 4, 1)]


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("boundary", ["clamp", "constant", "periodic"])
@pytest.mark.parametrize("shape,radius,steps", PREPADDED)
@pytest.mark.parametrize("offsets", ["zero", "shard"])
@pytest.mark.parametrize("persistent", [True, False], ids=["B6", "B5"])
def test_prepadded_replay_equals_plain_superstep(ndim, boundary, shape,
                                                 radius, steps, offsets,
                                                 persistent):
    """B6 (persistent CTAs) and B5 (a one-shot grid), batch 2, ragged
    tiles and short segments: a single grid, or a shard at offsets 3 in a
    global grid 3 wider on each side (so the boundary acts past the
    shard's padding).  Bit for bit ``superstep_plain`` on the shard's true
    cells."""
    offs = (0,) * ndim if offsets == "zero" else (3,) * ndim
    prog, plan, padded, true_shape, coeffs, geo = _prepadded_case(
        ndim, boundary, shape, radius, steps, offs, segment=4,
        tile=(24,) if ndim == 2 else (3, 24), persistent=persistent)
    assert geo.persistent == persistent and not geo.carry
    got = replay(prog, coeffs.center, coeffs.taps, padded, geo)
    want = common.superstep_plain(padded, coeffs.center, coeffs.taps,
                                  program=prog, plan=plan,
                                  true_shape=true_shape, offsets=offs)
    ix = (Ellipsis,) + tuple(slice(0, s) for s in GRIDS[ndim])
    assert not torch.isnan(got[ix]).any()
    torch.testing.assert_close(got[ix], want[ix], rtol=0, atol=0)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("boundary", ["clamp", "constant", "periodic"])
def test_queue_replay_in_a_deep_ring_matches_jax_reference(ndim, boundary):
    """A temporal remainder (2 steps read at offset H - h of a ring twice
    as deep, so the x shift is not 4) against the reference's padded
    superstep in interpret mode."""
    steps, radius = 2, 1
    prog = _program(ndim, boundary, "star", radius)
    plan = repro_torch.BlockPlan(spec=prog, block_shape=BLOCKS[ndim],
                                 par_time=steps)
    lay = dataclasses.replace(
        common.ring_schedule(prog, plan, GRIDS[ndim], steps).layout,
        halo=2 * steps * radius + 1)
    src = torch.from_numpy(np.random.RandomState(1).uniform(
        -1, 1, (2,) + lay.padded_shape).astype(np.float32))
    if lay.wrap_axes:
        common.refresh_wrap_halo_plain(src, lay)
    coeffs = prog.default_coeffs(seed=0)
    geo = queued.carry_geometry(prog, steps, lay, batch=2, smem_limit=LIMIT,
                                segment=4)
    assert geo.pad != 4
    got = replay(prog, coeffs.center, coeffs.taps, src, geo)
    rp = RefProgram(ndim=ndim, radius=radius, shape="star",
                    boundary=boundary, boundary_value=0.25)
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


def test_geometry_array_order():
    prog = _program(3, "clamp", radius=2)
    _, _, lay, _, _, geo = _carry_case(3, "clamp", "star", 2, 2,
                                       tile=(4, 32), segment=5)
    a = geo.array()
    H = lay.halo
    assert len(a) == 36
    assert a[:3] == list(GRIDS[3]) and a[3:6] == list(lay.padded_shape)
    assert a[6:9] == [H] * 3 and a[12:15] == [H] * 3
    assert a[15:18] == list(GRIDS[3]) and a[18:21] == [0, 0, 0]
    assert a[21:24] == [2, 2, 2] and a[24:27] == [5, 4, 32]
    planes = geo.planes
    assert a[27:30] == [2, 2, planes.ahead] and planes.group == 2
    assert a[30:33] == [1, 0, 0]          # carry, one-shot
    # the launcher sizes its planes itself and refuses a different count
    assert a[33:] == [geo.smem_bytes, 0, 0]
    assert geo.smem_bytes == queued_planes(prog, 2, (4, 32)).bytes()
    star = _program(3, "clamp", radius=1)
    for persistent in (True, False):      # B6, B5
        shard = queued.prepadded_geometry(
            star, 2, (12, 20, 40), (30, 30, 30), (5, 6, 7), batch=1,
            smem_limit=LIMIT, persistent=persistent)
        b = shard.array()
        assert b[6:9] == [2, 2, 2] and b[12:15] == [0, 0, 0]
        assert b[18:21] == [5, 6, 7] and b[27:29] == [2, 1]
        assert b[30:33] == [0, int(persistent), 0]     # pre-padded
    with pytest.raises(ValueError, match="no register-queue form"):
        queued.prepadded_geometry(
            _program(3, "clamp", "box", radius=1), 2, (12, 20, 40),
            (30, 30, 30), (5, 6, 7), batch=1, smem_limit=LIMIT,
            persistent=False)


def test_two_d_geometry_has_a_dummy_y():
    prog = _program(2, "constant", radius=3)
    _, _, lay, _, _, geo = _carry_case(2, "constant", "star", 3, 1,
                                       tile=(64,))
    assert geo.true == (13, 1, 75) and geo.radii == (3, 0, 3)
    assert geo.tile == (1, 64) and geo.src_off == (lay.halo, 0, lay.halo)
    assert geo.planes.extent == (1, 70) and geo.strips[0] == 1


def test_planes_count_rings_tables_and_barriers():
    """The queued CTA loads groups of r planes and keeps the groups read
    behind the current one (r planes back, or 2r when stage 0's queue
    would pass QUEUE_REGS), the current one and 1..8 in flight (16 KB),
    and two groups of centre planes per later stage; rows a multiple of 4
    floats plus 12; a guard of 16 floats and an mbarrier per loaded
    group."""
    q = QueuedPlanes(ndim=3, radius=4, steps=2, tile=(16, 32))
    assert q.extent == (32, 48) and q.pitch == 60 and q.plane == 32 * 60
    # 2 x 12 queue values per cell pass QUEUE_REGS: stage 0 stays in the
    # ring, two groups behind the current one; a group of 30 KB in flight
    assert not q.stage0_in_registers and q.group == 4
    assert q.ahead == 1 and q.groups == 2 + 1 + 1 and q.depth0 == 16
    assert q.planes == 16 + 2 * 4
    assert q.bytes() == 4 * (24 * 32 * 60 + 16) + 8 * 4
    one = dataclasses.replace(q, steps=1, tile=(24, 40))
    assert one.stage0_in_registers and one.extent == (32, 48)
    assert one.groups == 1 + 1 + 1 and one.planes == 12
    # radius 1: groups of one plane of 24 x 52 floats (5 KB), 4 in
    # flight; 4 x 3 queue values per cell keep stage 0 in registers
    r1 = QueuedPlanes(ndim=3, radius=1, steps=4, tile=(16, 32))
    assert r1.group == 1 and r1.ahead == 4 and r1.stage0_in_registers
    assert r1.groups == 1 + 1 + 4 and r1.planes == 6 + 3 * 2
    assert r1.bytes() == 4 * (12 * 24 * 52 + 16) + 8 * 6
    two = QueuedPlanes(ndim=2, radius=4, steps=2, tile=(1008,))
    assert two.extent == (1, 1024) and two.pitch == 1036
    assert two.ahead == 1                # groups of 4 rows: 16.6 KB each
    small = QueuedPlanes(ndim=2, radius=4, steps=2, tile=(32,))
    assert small.ahead == 8              # 960-byte groups: 8 at most


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("radius,steps", QUEUE_CASES)
@pytest.mark.parametrize("pad", [4, 5, 6, 7])
def test_strips_cover_the_stage_one_region(ndim, radius, steps, pad):
    """The threads' 4-cell strips sit on 16-byte shared columns, cover
    the stage-1 region, read their x taps inside the row and fit the
    CTA's 256 threads at the picked tile."""
    steps = min(steps, QUEUE_STEPS[ndim][radius])
    prog = _program(ndim, "clamp", radius=radius)
    tile = queued.pick_queued_tile(prog, steps, LIMIT)
    planes = queued_planes(prog, steps, tile)
    rows, nx, first = planes.strips(pad)
    E1, E2 = planes.extent
    r = radius
    assert rows == (1 if ndim == 2 else E1 - 2 * r) and rows * nx <= 256
    assert 4 * first <= r + pad and 4 * (first + nx) >= E2 - r + pad
    assert 4 * first - 4 >= 0 and 4 * (first + nx) + 4 <= planes.pitch


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("radius,steps", [(1, 4), (2, 3), (3, 2), (4, 2)])
@pytest.mark.parametrize("pad", range(8, 16))
def test_strips_cover_the_stage_one_region_in_16_bits(ndim, radius, steps,
                                                       pad):
    """At 2 bytes a cell the x shift is 8..15 (16-byte copies are 8
    cells): the strips still cover the stage-1 region inside the row and
    fit the CTA at the picked tile, for every queue of a 16-bit grid
    (the float32 table, radius 4 included)."""
    steps = min(steps, QUEUE_STEPS[ndim][radius])
    prog = _program(ndim, "clamp", radius=radius, dtype="bfloat16")
    tile = queued.pick_queued_tile(prog, steps, LIMIT)
    planes = queued_planes(prog, steps, tile)
    assert planes.itemsize == 2 and pad in planes.pads
    rows, nx, first = planes.strips(pad)
    E1, E2 = planes.extent
    r = radius
    assert rows == (1 if ndim == 2 else E1 - 2 * r) and rows * nx <= 256
    assert 4 * first <= r + pad and 4 * (first + nx) >= E2 - r + pad
    assert 4 * first - 4 >= 0 and 4 * (first + nx) + 4 <= planes.pitch


#: The kernels that run the register queues for stars (B1, B5, B6).
QUEUED = ("padded_superstep", "superstep", "pipelined_superstep")


def test_paper_picks_fit_two_ctas_per_sm():
    """B1, B5 and B6 at the main path's shapes: the register queues
    (stars) with a tile that leaves room for two CTAs per SM; at the
    periodic box all three run the streamed kernel at B4's tile."""
    works = {**stencil2d.workloads(), **stencil3d.workloads()}
    for name in ("2d_r4_paper", "3d_r4_paper", "3d_r2_paper"):
        plan = works[name].plan()
        for kernel in QUEUED:
            tile = cuda.pick_tile(plan, kernel, LIMIT)
            need = plan.smem_bytes_for(tile, kernel)
            assert queue_path(plan.program, plan.par_time)
            assert plan.body(kernel) == "queue"
            assert need <= LIMIT // 2 - queued.CTA_RESERVED
            assert queued_planes(plan.program, plan.par_time,
                                 tile).threads_fit
    box = works["2d_box_periodic_pod"].plan()
    assert not queue_path(box.program, box.par_time)
    for kernel in QUEUED:
        assert box.body(kernel) == "streamed"
        assert cuda.pick_tile(box, kernel, LIMIT) == \
            streamed.pick_streamed_tile(box.program, box.par_time, LIMIT)
        assert box.smem_bytes_for((992,), kernel) == \
            box.smem_bytes_for((992,), "padded_pipelined")


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_16_bit_paper_picks_fit_two_ctas_per_sm(dtype):
    """The radius-4 paper stars in 16 bits run B1, B5 and B6 on the
    register queues, like float32, at a tile that leaves room for two
    CTAs per SM and whose strips fit the CTA's threads."""
    works = {**stencil2d.workloads(), **stencil3d.workloads()}
    for name in ("2d_r4_paper", "3d_r4_paper"):
        work = works[name]
        prog = dataclasses.replace(work.spec, dtype=dtype)
        plan = dataclasses.replace(work.plan(), spec=prog)
        assert plan.itemsize == 2
        for kernel in QUEUED:
            tile = cuda.pick_tile(plan, kernel, LIMIT)
            assert plan.body(kernel) == "queue"
            assert plan.smem_bytes_for(tile, kernel) <= \
                LIMIT // 2 - queued.CTA_RESERVED
            assert queued_planes(prog, plan.par_time, tile).threads_fit


def _old_window_fits(plan, kernel):
    """The whole-window B1/B5/B6 design at its smallest tile (1, 4, 32)
    / (4, 32): a window, a second for the ping-pong, B6 one more for its
    prefetch, and the tables."""
    steps, nd = plan.par_time, plan.program.ndim
    halo = steps * plan.program.halo_radius
    tile = (1, 4, 32) if nd == 3 else (4, 32)
    windows = (2 if steps > 1 else 1) + (kernel == "pipelined_superstep")
    need = 4 * windows * math.prod(t + 2 * halo for t in tile) + \
        8 * plan.program.num_taps
    return need <= LIMIT


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("shape", ["star", "box", "diamond"])
def test_every_plan_the_window_kernels_took_still_fits(ndim, shape):
    """No plan that compiled with the whole-window B1, B5 or B6 becomes
    RP105: every radius 1..4 and fused steps 1..32 whose old window fitted
    the card fits the body the kernel runs now (the register queues or
    the streamed kernel) at its smallest tile, and the pick finds a
    tile."""
    taken = 0
    for radius, steps in itertools.product(range(1, 5), range(1, 33)):
        prog = _program(ndim, "clamp", shape, radius)
        plan = repro_torch.BlockPlan(spec=prog, block_shape=BLOCKS[ndim],
                                     par_time=steps)
        for kernel in QUEUED:
            if not _old_window_fits(plan, kernel):
                continue
            taken += 1
            small = cuda.smallest_tile(plan, kernel)
            assert plan.smem_bytes_for(small, kernel) <= LIMIT
            tile = cuda.pick_tile(plan, kernel, LIMIT)
            assert plan.smem_bytes_for(tile, kernel) <= LIMIT
    assert taken > 30


def test_temporal_remainders_of_the_paper_plans_run():
    """A temporal run's B1 remainder may be up to 4*par_time - 1 steps:
    at the paper plans every remainder fits, 3d_r4_paper's 3-step
    remainder included (the whole window refused it)."""
    works = {**stencil2d.workloads(), **stencil3d.workloads()}
    for name in ("2d_r4_paper", "3d_r2_paper", "3d_r4_paper"):
        work = works[name]
        plan = work.plan()
        for steps in range(1, 4 * plan.par_time):
            found = smem_diagnostics(plan, "temporal", H100_SXM,
                                     grid_shape=work.grid_shape,
                                     steps=4 * plan.par_time + steps)
            assert found == [], (name, steps)
