"""The port's examples (``examples/*_torch.py``) on the CPU against the JAX
package's examples on the same inputs.

Each example runs with ``--device cpu`` (the plain versions of the
kernels) at its own sizes, which are small, and what it returns is held
to the same computation through ``repro``: the quickstart's grids and the
wave's energies and field at the repo's ULP (atol 1e-6, rtol 1e-5; the
input grid carried across with numpy, the wave's coefficients from the
JAX example's own ``laplacian_coeffs``); the served model's every decode
call at atol 1e-3, rtol 1e-4 with the weights of the JAX example's
``PRNGKey(0)`` init carried across (a random-init model echoes its
input, so the tokens alone prove little); the training run's first
``ce`` against the reference model's loss on the same batch and weights.
No example, and no module of ``repro_torch``, imports ``jax`` or
``repro``.
"""

import ast
import dataclasses
import functools
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.configs import ARCHS as REF_ARCHS
from repro.core.blocking import BlockPlan as RefBlockPlan
from repro.launch import serve as ref_serve
from repro.models import common as ref_common
from repro.models import transformer as ref_transformer
from repro.runtime import trainer as ref_trainer

from repro_torch import convert
from repro_torch.kernels import cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
PORTED = ("quickstart", "wave3d", "serve_lm", "train_lm")
ULP = dict(atol=1e-6, rtol=1e-5)
MODEL_TOL = dict(atol=1e-3, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _example(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _ref_program(prog):
    return repro.StencilProgram(**dataclasses.asdict(prog))


# ---- quickstart -------------------------------------------------------------

def test_quickstart_equals_the_jax_front_door(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(tmp_path / "p.json"))
    ex = _example("quickstart_torch")
    got = ex.main(["--device", "cpu"])
    plan = got["plan"]
    rp = _ref_program(plan.spec)
    rplan = RefBlockPlan(spec=rp, block_shape=plan.block_shape,
                         par_time=plan.par_time)
    grid = jnp.asarray(_np(got["grid"]))
    shape = tuple(grid.shape)
    sten = repro.stencil(rp)
    want = sten.compile(shape, steps=8, plan=rplan, variant="plain").run(grid)
    np.testing.assert_allclose(_np(got["out"]), np.asarray(want), **ULP)
    want_t = sten.compile(shape, steps=8, plan=rplan,
                          variant="temporal").run(grid)
    np.testing.assert_allclose(_np(got["temporal"]), np.asarray(want_t),
                               **ULP)
    want_b = sten.compile(shape, steps=8, plan=rplan, batch=2).run(
        jnp.stack([grid, grid]))
    np.testing.assert_allclose(_np(got["batched"]), np.asarray(want_b),
                               **ULP)
    # the second compile of the same (program, grid, card, backend) is a
    # hit of the plan cache
    assert ex.main(["--device", "cpu"])["plan"] == plan
    assert (tmp_path / "p.json").exists()


# ---- wave3d -----------------------------------------------------------------

def test_wave3d_equals_the_jax_front_door():
    ex, ref_ex = _example("wave3d_torch"), _example("wave3d")
    got = ex.main(["--device", "cpu"])
    spec = repro.StencilProgram(ndim=3, radius=4, shape="star",
                                coeff_sharing="distance")
    rc = ref_ex.laplacian_coeffs(spec, 0.05)
    np.testing.assert_array_equal(_np(got["coeffs"].center),
                                  np.asarray(rc.center))
    np.testing.assert_array_equal(_np(got["coeffs"].taps),
                                  np.asarray(rc.taps))
    shape = (32, 48, 256)
    plan = RefBlockPlan(spec=spec, block_shape=(8, 16, 128), par_time=2)
    cs = repro.stencil(spec, coeffs=rc).compile(shape, steps=2, plan=plan)
    # each energy against the JAX run's field summed in float64: XLA's
    # float32 sum of the 393216 squares wanders by about 1e-5 of it
    # (the torch sum, pairwise, by about 1e-7)
    def energy(field):
        return float(np.sum(np.asarray(field, np.float64) ** 2))

    u = jnp.asarray(_np(got["u0"]))
    assert got["e0"] == pytest.approx(energy(u), rel=1e-5)
    energies = []
    for _ in range(4):
        u = cs.run(u)
        energies.append(energy(u))
    np.testing.assert_allclose(got["energies"], energies, rtol=1e-5)
    np.testing.assert_allclose(_np(got["u"]), np.asarray(u), **ULP)
    assert all(e <= got["e0"] * 1.01 for e in got["energies"])


# ---- serve_lm ---------------------------------------------------------------

def _recorded(engine, calls):
    """Wrap ``engine.decode`` to record each call's inputs and logits."""
    decode = engine.decode

    def record(*args):
        *_, toks, pos = args
        logits, caches = decode(*args)
        calls.append((np.asarray(toks).copy(), np.asarray(pos).copy(),
                      np.asarray(logits, dtype=np.float64)))
        return logits, caches

    engine.decode = record


def test_serve_lm_equals_the_jax_engine_call_for_call():
    ex = _example("serve_lm_torch")
    # the JAX example's recipe: its config, PRNGKey(0) weights, engine
    # and requests
    ref_cfg = REF_ARCHS["rwkv6-7b"].reduced(d_model=128, vocab=1024)
    ref_model = ref_transformer.build(ref_cfg)
    params, _ = ref_common.split_params(ref_model.init(
        jax.random.PRNGKey(0)))
    ref_engine = ref_serve.ServeEngine(ref_cfg, params, batch=4,
                                       cache_len=128)
    ref_engine.decode = jax.jit(ref_trainer.make_decode_step(ref_model))
    rng = np.random.RandomState(0)
    ref_reqs = [ref_serve.Request(rid=i, prompt=rng.randint(
        0, ref_cfg.vocab, size=(12,)), max_new=24) for i in range(10)]

    cfg = ex.config()
    assert convert.arch_from_fields(**dataclasses.asdict(ref_cfg)) == cfg
    model = ex.transformer.build(cfg, device="cpu", seed=0)
    model.load_state_dict(convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), "cpu"))
    engine = ex.engine(model)
    reqs = ex.requests(cfg)
    assert [r.prompt.tolist() for r in reqs] \
        == [r.prompt.tolist() for r in ref_reqs]
    calls, ref_calls = [], []
    _recorded(engine, calls)
    _recorded(ref_engine, ref_calls)
    stats = engine.run(reqs)
    ref_stats = ref_engine.run(ref_reqs)
    # 10 prompts of 12 fed token by token, then 3 waves of 24 decodes
    assert len(calls) == len(ref_calls) == 10 * 12 + 3 * 24
    for (t, p, logits), (rt, rp, want) in zip(calls, ref_calls):
        assert np.array_equal(t, rt) and np.array_equal(p, rp)
        np.testing.assert_allclose(logits, want, **MODEL_TOL)
    assert [r.generated for r in reqs] == [r.generated for r in ref_reqs]
    assert stats["tokens"] == ref_stats["tokens"] == 240


def test_serve_lm_main_serves_every_request_on_the_cpu():
    got = _example("serve_lm_torch").main(["--device", "cpu"])
    assert got["stats"]["tokens"] == 240
    assert all(r.done and len(r.generated) == 24 for r in got["requests"])


# ---- train_lm ---------------------------------------------------------------

def test_train_lm_first_step_equals_the_reference_loss(monkeypatch):
    """``--steps 3 --batch 2 --seq 32`` with the weights of the JAX
    example's ``build_run`` (``PRNGKey(0)``) carried into the port's run:
    the first step's ``ce`` against the reference model's loss on the
    same batch."""
    ex = _example("train_lm_torch")
    ref_cfg = dataclasses.replace(
        REF_ARCHS["starcoder2-7b"].reduced(d_model=512, vocab=32768),
        n_layers=8, d_ff=2048, compute_dtype="float32")
    cfg = ex.config()
    assert convert.arch_from_fields(**dataclasses.asdict(ref_cfg)) == cfg
    ref_model = ref_transformer.build(ref_cfg)
    params, _ = ref_common.split_params(ref_model.init(
        jax.random.PRNGKey(0)))
    tree = jax.tree.map(np.asarray, params)
    build_run = ex.build_run

    def carried(c, **kw):
        run = build_run(c, **kw)
        run.model.load_state_dict(convert.lm_params_from_numpy(
            c, tree, train=True))
        return run

    monkeypatch.setattr(ex, "build_run", carried)
    got = ex.main(["--steps", "3", "--batch", "2", "--seq", "32",
                   "--device", "cpu"])
    batch0 = {k: jnp.asarray(v) for k, v in ex.SyntheticLM(
        vocab=cfg.vocab, seq_len=32, global_batch=2, seed=0).batch(
            0).items()}
    _, metrics = jax.jit(ref_model.loss)(params, batch0)
    assert got["first_ce"] == pytest.approx(float(metrics["ce"]),
                                            rel=1e-5, abs=1e-4)
    assert got["params"] == ref_common.param_count(params)
    assert got["checkpoints"] == [3]
    assert np.isfinite(got["ce"]) and got["ce"] < got["first_ce"]


def test_train_lm_main_checks_the_loss_on_the_cpu(capsys):
    got = _example("train_lm_torch").main(
        ["--steps", "3", "--batch", "2", "--seq", "32", "--device", "cpu"])
    assert got["ce"] < 0.7 * got["first_ce"]
    assert "[train_lm] ce:" in capsys.readouterr().out


# ---- the card by default, and no jax --------------------------------------

@pytest.mark.parametrize("name", PORTED)
def test_example_runs_on_the_card_by_default(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    launches = dict(cuda.launches())
    with pytest.raises(Exception, match="RP110"):
        _example(f"{name}_torch").main(
            ["--steps", "1"] if name == "train_lm" else [])
    assert cuda.launches() == launches


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield node.lineno, [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            yield node.lineno, [node.module or ""]


@pytest.mark.parametrize("name", PORTED)
def test_example_imports_only_torch_numpy_and_the_port(name):
    path = os.path.join(EXAMPLES, f"{name}_torch.py")
    third = set()
    for line, mods in _imports(path):
        for m in mods:
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path}:{line} imports {m}"
            if top not in sys.stdlib_module_names:
                third.add(top)
    assert third <= {"torch", "numpy", "repro_torch"}, third


def test_the_port_and_its_examples_import_without_jax():
    """Every module of ``repro_torch`` (its ``__main__`` entry points,
    which run their CLI when imported, aside) and every
    ``examples/*_torch.py`` imports in a process where ``import jax`` and
    ``import repro`` fail."""
    mods = []
    src = os.path.join(ROOT, "src")
    for dirpath, _, names in os.walk(os.path.join(src, "repro_torch")):
        for n in sorted(names):
            if n.endswith(".py") and n != "__main__.py":
                rel = os.path.relpath(os.path.join(dirpath, n), src)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(
                    ".__init__"))
    assert len(mods) > 60
    code = (
        "import importlib, importlib.util, sys\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"for n in {[f'{p}_torch' for p in PORTED]!r}:\n"
        f"    s = importlib.util.spec_from_file_location(n, {EXAMPLES!r} "
        "+ '/' + n + '.py')\n"
        "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
        "bad = sorted(m for m in sys.modules if sys.modules[m] is not None "
        "and m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=src)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
