"""The run driver's pad-in (``kernels/common.run_call``): one copy of each
grid into the padded carry, and zeros only outside the true interior.

* at every launch the source and destination hold, bit for bit, what the
  zero-filled construction holds (``new_zeros``, the interior copy,
  ``zeros_like``), with the uninitialised allocations poisoned with NaN so
  that a cell left unwritten would show;
* a batch given as a list of grids equals its stacked tensor and the
  unbatched runs, at 0, through the front door;
* ``run_call.copy_bytes`` counts four grid-sizes a row (a read and a write
  in, the same out) and the ring and slack of both buffers, which the
  fills cover once;
* the front door checks a list as it checks a stacked batch.

Plain versions on the CPU; the card's counterpart is
``test_served_chunk_of_four_equals_four_runs`` in
``tests/test_torch_cuda.py``.
"""

import math

import pytest
import torch

import repro_torch
from repro_torch import obs
from repro_torch.core.blocking import TEMPORAL_CHUNK
from repro_torch.kernels import common
from repro_torch.lint.diagnostics import DiagnosticError

BLOCKS = {2: (16, 128), 3: (8, 16, 128)}
#: not multiples of the blocks (so there is slack), and wide enough that a
#: periodic temporal ring refreshes in place
GRIDS = {2: (37, 150), 3: (20, 24, 140)}
#: two full launches and a remainder under each variant
STEPS = {"plain": 5, "pipelined": 5, "temporal": 2 * 2 * TEMPORAL_CHUNK + 3}

BOUNDARIES = ["clamp", "constant", "periodic"]
VARIANTS = ["plain", "pipelined", "temporal"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Intra-op threads: one.  These CPU tensors are small, and the test
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _obs_isolation(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_OBS", raising=False)
    obs.reset()
    yield
    obs.reset()


def _config(ndim, boundary):
    prog = repro_torch.StencilProgram(ndim=ndim, radius=1, shape="star",
                                      boundary=boundary, boundary_value=0.25)
    plan = repro_torch.BlockPlan(spec=prog, block_shape=BLOCKS[ndim],
                                 par_time=2)
    return prog, plan, prog.default_coeffs(seed=ndim)


def _grids(ndim, n, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.rand(GRIDS[ndim], generator=gen) * 2 - 1
            for _ in range(n)]


def _bits(t):
    return t.contiguous().view(torch.int32)


def _outside(layout):
    """The padded cells outside the true interior, as a mask."""
    mask = torch.ones(layout.padded_shape, dtype=torch.bool)
    mask[tuple(slice(layout.halo, layout.halo + n)
               for n in layout.local_shape)] = False
    return mask


def _poison(monkeypatch):
    """Uninitialised allocations come back full of NaN."""
    new_empty, empty_like = torch.Tensor.new_empty, torch.empty_like
    monkeypatch.setattr(torch.Tensor, "new_empty", lambda self, *a, **k:
                        new_empty(self, *a, **k).fill_(math.nan))
    monkeypatch.setattr(torch, "empty_like", lambda *a, **k:
                        empty_like(*a, **k).fill_(math.nan))


def _run(prog, plan, coeffs, grid, variant):
    period = plan.par_time * (TEMPORAL_CHUNK if variant == "temporal"
                              else 1)
    full, rem = divmod(STEPS[variant], period)
    return common.run_call(grid, coeffs.center, coeffs.taps, full,
                           program=prog, plan=plan,
                           true_shape=GRIDS[prog.ndim], rem=rem,
                           variant=variant)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_carry_buffers_equal_the_zero_filled_construction(
        monkeypatch, boundary, ndim, batch, variant):
    prog, plan, coeffs = _config(ndim, boundary)
    rows = _grids(ndim, batch or 1)
    grid = rows[0] if batch is None else rows     # a batch as a list
    launches = []
    launch = common.padded_superstep

    def spy(src, dst, center, taps, **kw):
        before = (src.clone(), dst.clone())
        launch(src, dst, center, taps, **kw)
        launches.append((before, dst.clone(), kw))
        return dst

    _poison(monkeypatch)
    monkeypatch.setattr(common, "padded_superstep", spy)
    out = _run(prog, plan, coeffs, grid, variant)
    monkeypatch.undo()

    # the zero-filled construction, replayed launch by launch
    kw = launches[0][2]
    layout = kw["layout"]
    assert not common.ring_schedule(prog, plan, GRIDS[ndim], STEPS[variant],
                                    variant=variant).fallback
    interior = (Ellipsis,) + tuple(slice(layout.halo, layout.halo + n)
                                   for n in layout.local_shape)
    stacked = rows[0] if batch is None else torch.stack(rows)
    src = stacked.new_zeros(stacked.shape[:stacked.ndim - ndim]
                            + layout.padded_shape)
    src[interior] = stacked
    dst = torch.zeros_like(src)
    outside = _outside(layout)
    assert len(launches) == 3
    for i, ((src_at, dst_at), dst_after, kw) in enumerate(launches):
        if layout.wrap_axes:
            common.refresh_wrap_halo_plain(src, layout)
        assert torch.equal(_bits(src_at), _bits(src)), i
        # the first launch's destination interior is unwritten: it is
        # written before anything reads it
        if i == 0:
            assert torch.equal(_bits(dst_at[..., outside]),
                               _bits(dst[..., outside]))
            assert torch.isnan(dst_at[interior]).all()
        else:
            assert torch.equal(_bits(dst_at), _bits(dst)), i
        launch(src, dst, coeffs.center, coeffs.taps, **kw)
        assert torch.equal(_bits(dst_after), _bits(dst)), i
        src, dst = dst, src
    assert torch.equal(_bits(out), _bits(src[interior]))
    assert not torch.isnan(out).any()


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_list_batch_equals_its_stack_and_unbatched_runs(boundary, ndim,
                                                        variant):
    prog, plan, coeffs = _config(ndim, boundary)
    steps = STEPS[variant]
    stencil = repro_torch.stencil(prog, coeffs=coeffs)
    batched = stencil.compile(GRIDS[ndim], steps=steps, batch=3, plan=plan,
                              variant=variant, device="cpu")
    single = stencil.compile(GRIDS[ndim], steps=steps, plan=plan,
                             variant=variant, device="cpu")
    rows = _grids(ndim, 3, seed=ndim)
    kept = [r.clone() for r in rows]
    got = batched.run(rows)
    assert all(torch.equal(r, k) for r, k in zip(rows, kept))  # not written
    assert got.shape == (3,) + GRIDS[ndim] and got.is_contiguous()
    assert torch.equal(_bits(got), _bits(batched.run(torch.stack(rows))))
    assert torch.equal(_bits(got), _bits(batched.run(tuple(rows))))
    for r, g in zip(rows, got):
        assert torch.equal(_bits(g), _bits(single.run(r)))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_copy_bytes_count_four_grids_a_row_and_the_outside(
        monkeypatch, boundary, ndim, batch, variant):
    prog, plan, coeffs = _config(ndim, boundary)
    rows = _grids(ndim, batch or 1)
    grid = rows[0] if batch is None else rows
    zeroed = []
    zero_ = torch.Tensor.zero_

    def count_zeroed(self):
        zeroed.append(self.numel())
        return zero_(self)

    monkeypatch.setattr(torch.Tensor, "zero_", count_zeroed)
    with obs.profile() as rec:
        _run(prog, plan, coeffs, grid, variant)
    monkeypatch.undo()
    layout = common.ring_schedule(prog, plan, GRIDS[ndim], STEPS[variant],
                                  variant=variant).layout
    b = batch or 1
    n = math.prod(GRIDS[ndim])
    outside = b * (math.prod(layout.padded_shape) - n)
    # two buffers, a slab below and one above the interior on each axis,
    # which together cover the outside once
    assert len(zeroed) == 2 * 2 * ndim and sum(zeroed) == 2 * outside
    assert rec.counter("run_call.copy_bytes") == 4 * (4 * b * n
                                                      + 2 * outside)


def test_wrap_degenerate_run_stacks_a_list():
    """The re-pad fallback takes one tensor: a list is stacked first."""
    prog = repro_torch.StencilProgram(ndim=2, radius=2, shape="box",
                                      boundary="periodic")
    plan = repro_torch.BlockPlan(spec=prog, block_shape=(16, 128),
                                 par_time=2)
    shape = (17, 140)     # 32 - 17 + 4 > 17: the ring cannot wrap in place
    assert common.ring_schedule(prog, plan, shape, 5).fallback
    coeffs = prog.default_coeffs(seed=1)
    gen = torch.Generator().manual_seed(5)
    rows = [torch.rand(shape, generator=gen) for _ in range(2)]

    def run(grid):
        return common.run_call(grid, coeffs.center, coeffs.taps, 2,
                               program=prog, plan=plan, true_shape=shape,
                               rem=1)

    assert torch.equal(_bits(run(rows)), _bits(run(torch.stack(rows))))


@pytest.mark.parametrize("case,batch,error,code", [
    ("count", 3, DiagnosticError, "RP101"),
    ("shapes", 3, DiagnosticError, "RP101"),
    ("empty", 3, DiagnosticError, "RP101"),
    ("unbatched", None, DiagnosticError, "RP103"),
    ("dtype", 3, DiagnosticError, "RP109"),
    ("type", 3, TypeError, "torch.Tensor"),
])
def test_front_door_checks_a_list_as_a_stacked_batch(case, batch, error,
                                                     code):
    prog, plan, _ = _config(2, "clamp")
    cs = repro_torch.stencil(prog).compile(GRIDS[2], steps=2, batch=batch,
                                           plan=plan, device="cpu")
    rows = _grids(2, 3)
    grid = {"count": rows[:2],
            "shapes": rows[:2] + [rows[2][:, :-1]],
            "empty": [],
            "unbatched": rows,
            "dtype": rows[:2] + [rows[2].double()],
            "type": rows[:2] + [rows[2].numpy()]}[case]
    with pytest.raises(error, match=code):
        cs.run(grid)


def test_run_driver_refuses_a_list_of_other_shapes():
    """Rows of another shape would broadcast into the carry; the driver
    refuses them, and an empty list, before it allocates."""
    prog, plan, coeffs = _config(2, "clamp")
    rows = _grids(2, 2)
    for grid in ([rows[0], rows[1][:1]], []):
        with pytest.raises(ValueError, match="true shape|needs a grid"):
            common.run_call(grid, coeffs.center, coeffs.taps, 1,
                            program=prog, plan=plan, true_shape=GRIDS[2],
                            rem=0)
