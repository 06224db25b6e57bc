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
from repro_torch.core.reference import program_nsteps
from repro_torch.kernels import common, cuda

pytestmark = pytest.mark.gpu

ULP = dict(atol=1e-6, rtol=1e-5)
BLOCKS = {2: (16, 128), 3: (8, 16, 128)}
GRIDS = {2: (37, 150), 3: (20, 18, 140)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _config(ndim, boundary, shape="box", par_time=2):
    prog = repro_torch.StencilProgram(ndim=ndim, radius=2, shape=shape,
                                      boundary=boundary, boundary_value=0.25)
    plan = repro_torch.BlockPlan(spec=prog, block_shape=BLOCKS[ndim],
                                 par_time=par_time)
    layout = common.ring_schedule(prog, plan, GRIDS[ndim], par_time).layout
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
    a wrap launch per axis and one superstep launch."""
    prog, plan, _ = _config(2, "periodic")
    cs = repro_torch.stencil(prog).compile(GRIDS[2], steps=5, plan=plan)
    g = torch.rand(GRIDS[2], device=cuda_device)
    cuda.reset_launches()
    cs.run(g)
    torch.cuda.synchronize()
    assert cuda.launches() == {"padded_superstep": 3, "wrap_halo": 6}


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


def test_wrap_degenerate_layout_refuses_the_card(cuda_device):
    prog = repro_torch.StencilProgram(ndim=3, radius=2, boundary="periodic")
    plan = repro_torch.BlockPlan(spec=prog, block_shape=BLOCKS[3],
                                 par_time=2)
    cs = repro_torch.stencil(prog).compile((9, 18, 140), steps=3, plan=plan)
    with pytest.raises(NotImplementedError, match="ROADMAP B5"):
        cs.run(torch.zeros((9, 18, 140), device=cuda_device))
