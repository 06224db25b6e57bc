"""The slice as a whole: ``repro_torch.stencil(...).compile(...).run()``
against ``repro.stencil(...).compile(...).run()`` with the same pinned
``BlockPlan``, the front door's rejections, and import hygiene.

The port runs on the CPU here (``device="cpu"``: the plain versions of
the kernels); the reference runs its Pallas kernels in interpret mode.
"""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro
from repro.core import reference as ref
from repro.core.blocking import BlockPlan as RefPlan
from repro.core.program import StencilProgram as RefProgram

import repro_torch
from repro_torch import convert
from repro_torch.kernels import common, ops
from repro_torch.lint.diagnostics import DiagnosticError

TOL = dict(atol=5e-4, rtol=5e-4)
ULP = dict(atol=1e-6, rtol=1e-5)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKS = {2: (16, 128), 3: (8, 16, 128)}
GRIDS = {2: (37, 150), 3: (20, 18, 140)}


def _both(ndim, boundary, radius=2, shape="star", par_time=2, seed=0):
    """The same configuration in both packages."""
    rp = RefProgram(ndim=ndim, radius=radius, shape=shape, boundary=boundary,
                    boundary_value=0.25)
    rplan = RefPlan(spec=rp, block_shape=BLOCKS[ndim], par_time=par_time)
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
@pytest.mark.parametrize("batch", [None, 2])
def test_front_door_matches_reference(ndim, boundary, batch):
    """steps = 1 full superstep + a remainder of 1 (and, unbatched, 4
    supersteps + 1 through ``run(steps=)``), box taps so every axis pair
    is displaced."""
    rp, rplan, rc, tp, tplan, tc = _both(ndim, boundary, shape="box",
                                         seed=ndim)
    shape = GRIDS[ndim]
    lead = () if batch is None else (batch,)
    g = _grid(lead + shape, seed=ndim)
    rcs = repro.stencil(rp, rc).compile(shape, steps=3, batch=batch,
                                        plan=rplan)
    tcs = repro_torch.stencil(tp, tc).compile(shape, steps=3, batch=batch,
                                              plan=tplan, device="cpu")
    got = tcs.run(torch.from_numpy(g))
    assert got.shape == lead + shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(rcs.run(g)), **ULP)
    one = g if batch is None else g[0]
    np.testing.assert_allclose(got.numpy() if batch is None
                               else got.numpy()[0],
                               ref.numpy_program_nsteps(rp, rc, one, 3),
                               **TOL)
    if batch is None:
        np.testing.assert_allclose(
            tcs.run(torch.from_numpy(g), steps=9).numpy(),
            np.asarray(rcs.run(g, steps=9)), **ULP)


def test_wrap_degenerate_periodic_matches_reference():
    """A periodic axis smaller than the round-up slack takes the re-pad
    fallback on both sides."""
    rp, rplan, rc, tp, tplan, tc = _both(3, "periodic")
    shape = (9, 18, 140)
    assert common.ring_schedule(tp, tplan, shape, 4).fallback
    g = _grid(shape, seed=3)
    got = repro_torch.stencil(tp, tc).compile(
        shape, steps=4, plan=tplan, device="cpu").run(torch.from_numpy(g))
    want = repro.stencil(rp, rc).compile(shape, steps=4, plan=rplan).run(g)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ULP)


def test_radius_four_star_matches_oracle():
    """The paper's radius through the remainder path: par_time 3, 7 steps
    (two full supersteps and a remainder of 1)."""
    rp, rplan, rc, tp, tplan, tc = _both(2, "clamp", radius=4, par_time=3)
    g = _grid(GRIDS[2], seed=4)
    got = repro_torch.stencil(tp, tc).compile(
        GRIDS[2], steps=7, plan=tplan, device="cpu").run(torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(),
                               ref.numpy_program_nsteps(rp, rc, g, 7), **TOL)


def test_caller_grid_is_never_written():
    _, _, _, tp, tplan, tc = _both(2, "periodic")
    g = torch.from_numpy(_grid(GRIDS[2]))
    keep = g.clone()
    cs = repro_torch.stencil(tp, tc).compile(GRIDS[2], steps=4, plan=tplan,
                                             device="cpu")
    a = cs.run(g)
    b = cs.run(g)
    assert torch.equal(g, keep) and torch.equal(a, b)
    assert a.data_ptr() != g.data_ptr() and a.is_contiguous()
    assert ops._stencil_run(g, tp, tc, tplan, 0) is g


def _compile(tp, tplan, **kw):
    args = dict(steps=2, plan=tplan, device="cpu")
    args.update(kw)
    shape = args.pop("grid_shape", GRIDS[tp.ndim])
    return repro_torch.stencil(tp).compile(shape, **args)


@pytest.mark.parametrize("kwargs,code", [
    (dict(grid_shape=(37,)), "RP101"),
    (dict(grid_shape=(37.5, 150)), "RP101"),
    (dict(grid_shape=(0, 150)), "RP101"),
    (dict(steps=0), "RP102"),
    (dict(steps=2.5), "RP102"),
    (dict(batch=0), "RP103"),
    (dict(batch="2"), "RP103"),
    (dict(devices=2), "RP110"),
    (dict(devices=(2, 1)), "RP110"),
    (dict(devices="x"), "RP110"),
    (dict(plan="fastest"), "RP112"),
    (dict(plan=None), "RP112"),
    (dict(plan=(16, 128)), "RP112"),
])
def test_front_door_rejections(kwargs, code, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_FORCE_DEVICE_COUNT", raising=False)
    _, _, _, tp, tplan, _ = _both(2, "clamp")
    with pytest.raises(DiagnosticError, match=code) as info:
        _compile(tp, tplan, **kwargs)
    assert [d.code for d in info.value.diagnostics] == [code]


@pytest.mark.parametrize("devices", [2, (2, 1)])
def test_mesh_request_names_the_device_variable(devices, monkeypatch):
    """Without ``REPRO_TORCH_FORCE_DEVICE_COUNT`` the CPU is one device, so
    a mesh is RP110 and its hint names the variable; with it the same
    call runs, equal to the single-device run."""
    monkeypatch.delenv("REPRO_TORCH_FORCE_DEVICE_COUNT", raising=False)
    _, _, _, tp, tplan, _ = _both(2, "clamp")
    with pytest.raises(DiagnosticError) as info:
        _compile(tp, tplan, devices=devices)
    (d,) = info.value.diagnostics
    assert d.code == "RP110" and "REPRO_TORCH_FORCE_DEVICE_COUNT=2" in d.hint
    monkeypatch.setenv("REPRO_TORCH_FORCE_DEVICE_COUNT", "2")
    grid = (64, 256)            # a split of 2 tiles by the block
    cs = _compile(tp, tplan, devices=devices, grid_shape=grid)
    assert cs.decomp in ((2, 1), (1, 2)) and cs.describe() == \
        "mesh " + "x".join(map(str, cs.decomp))
    g = torch.rand(grid)
    torch.testing.assert_close(
        cs.run(g), _compile(tp, tplan, grid_shape=grid).run(g), rtol=0,
        atol=0)


def test_rejections_follow_reference_order_and_text():
    """grid before steps before batch before placement before plan, with
    the reference's message for the same mistake."""
    rp, rplan, _, tp, tplan, _ = _both(2, "clamp")
    bad = dict(steps=0, batch=0, plan="nope")
    for pkg, prog, plan in ((repro, rp, rplan), (repro_torch, tp, tplan)):
        with pytest.raises(ValueError, match="RP101") as info:
            pkg.stencil(prog).compile((37,), **bad)
        if pkg is repro:
            want = str(info.value)
        else:
            assert str(info.value) == want
    with pytest.raises(DiagnosticError, match="RP102"):
        _compile(tp, tplan, steps=0, batch=0, plan="nope")
    with pytest.raises(DiagnosticError, match="RP103"):
        _compile(tp, tplan, batch=0, plan="nope")
    with pytest.raises(DiagnosticError, match='"auto", "model", or a '
                                              'BlockPlan'):
        _compile(tp, tplan, plan="nope")


def test_variant_and_rank_and_dtype_rejections():
    """Every variant compiles to its cuda sibling; an unknown variant, a
    wrong block rank and a wrong dtype are refused."""
    _, _, _, tp, tplan, _ = _both(2, "clamp")
    for v in ("pipelined", "temporal"):
        cs = _compile(tp, tplan, variant=v)
        assert (cs.variant, cs.backend) == (v, f"cuda-{v}")
        named = _compile(tp, tplan, backend=f"cuda-{v}")
        assert (named.variant, named.backend) == (v, f"cuda-{v}")
        assert _compile(tp, tplan, backend=f"cuda-{v}",
                        variant="auto").variant == v
    assert _compile(tp, tplan, backend="cuda-temporal",
                    variant="plain").backend == "cuda"
    with pytest.raises(ValueError, match="unknown kernel variant"):
        _compile(tp, tplan, variant="fast")
    with pytest.raises(KeyError, match="unknown backend"):
        _compile(tp, tplan, backend="pallas-tpu")
    assert _compile(tp, tplan, variant="auto").variant == "plain"
    with pytest.raises(DiagnosticError, match="RP111"):
        _compile(tp, dataclasses.replace(tplan, block_shape=(16,)))
    p64 = dataclasses.replace(tp, dtype="float64")
    with pytest.raises(DiagnosticError, match="RP109"):
        _compile(p64, dataclasses.replace(tplan, spec=p64))


def test_run_rejections():
    _, _, _, tp, tplan, _ = _both(2, "clamp")
    cs = _compile(tp, tplan)
    g = torch.zeros(GRIDS[2])
    with pytest.raises(DiagnosticError, match="RP103"):
        cs.run(g[None].repeat(2, 1, 1))
    with pytest.raises(DiagnosticError, match="RP101"):
        cs.run(torch.zeros(8, 8))
    with pytest.raises(DiagnosticError, match="RP102"):
        cs.run(g, steps=-1)
    with pytest.raises(DiagnosticError, match="RP109"):
        cs.run(g.double())
    with pytest.raises(DiagnosticError, match="RP110"):
        cs.run(g.to("meta"))
    with pytest.raises(TypeError, match="torch.Tensor"):
        cs.run(g.numpy())
    bcs = _compile(tp, tplan, batch=2)
    with pytest.raises(DiagnosticError, match="RP103"):
        bcs.run(g)


def test_compile_defaults_to_cuda_and_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, _, tp, tplan, _ = _both(2, "clamp")
    with pytest.raises(DiagnosticError, match="RP110") as info:
        repro_torch.stencil(tp).compile(GRIDS[2], steps=2, plan=tplan)
    assert "device='cpu'" in str(info.value)


def test_import_does_not_load_jax_or_the_reference():
    code = ("import sys, repro_torch, repro_torch.convert, "
            "repro_torch.kernels.ops, repro_torch.configs.stencil3d, "
            "repro_torch.backends, repro_torch.kernels.stencil2d, "
            "repro_torch.kernels.stencil3d, repro_torch.lint.verify, "
            "repro_torch.tuning, repro_torch.tuning.cli, "
            "repro_torch.core.perf_model, repro_torch.obs, "
            "repro_torch.obs.report, repro_torch.launch.stencil_serve, "
            "repro_torch.lint, repro_torch.lint.dataflow, "
            "repro_torch.lint.sanitize, repro_torch.lint.__main__, "
            "repro_torch.models, repro_torch.models.transformer, "
            "repro_torch.runtime.trainer, repro_torch.launch.serve, "
            "repro_torch.configs; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_import_no_jax_or_reference():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "src",
                                                  "repro_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 22
    for path in files:
        tree = ast.parse(open(path, encoding="utf-8").read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    f"{path}:{node.lineno} imports {m}"

