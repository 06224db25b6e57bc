"""The port's training substrate against the JAX package, on the CPU:
the schedule, AdamW, the global norm, gradient compression, the data
pipeline, checkpoints, the watchdog and restart loop, and the launcher
(``build_run``, ``train_loop``, ``main``).

The same inputs, drawn with numpy, go through the reference (``repro``,
``JAX_PLATFORMS=cpu``) and the port (``repro_torch``, CPU tensors).
Tolerances: the schedule, AdamW on the same trees and the global norm
at rtol 1e-6 (float32 both ways: one rounding of ``pow``, ``cos`` or a
summation order apart), compression and the data pipeline at 0, the
launcher's runs from the same parameters at atol 2e-5 (the reference's
own, ``tests/test_train_loop.py``).  The whole models' training steps
are held to the reference in ``tests/test_torch_train_lm.py``.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.configs import ARCHS as REF_ARCHS
from repro.data import MemmapCorpus as RefMemmapCorpus
from repro.data import Prefetcher as RefPrefetcher
from repro.data import SyntheticLM as RefSyntheticLM
from repro.launch import train as ref_train
from repro.models import common as ref_common
from repro.optim import AdamW as RefAdamW
from repro.optim import GradCompression as RefGradCompression
from repro.optim import WarmupCosine as RefWarmupCosine
from repro.optim import global_norm as ref_global_norm
from repro.runtime import fault as ref_fault

from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data import MemmapCorpus, Prefetcher, SyntheticLM
from repro_torch.launch import train
from repro_torch.lint.diagnostics import DiagnosticError
from repro_torch.optim import (AdamW, AdamWState, GradCompression,
                               WarmupCosine, global_norm)
from repro_torch.runtime import fault

F32_TOL = dict(atol=0, rtol=1e-6)
RUN_ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Intra-op threads: one.  These CPU tensors are small, and the test
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, **tol):
    got = got.double().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **tol)


# ---- schedule, AdamW, norm, compression -------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(peak_lr=1e-3, warmup_steps=10,
                                         total_steps=200, floor_ratio=0.0)])
def test_warmup_cosine_matches_the_reference(kw):
    port, ref = WarmupCosine(**kw), RefWarmupCosine(**kw)
    for step in range(301):
        got = port(step)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        _close(got, ref(step), **F32_TOL)


#: the reference's tree: a unit leaf stacked over two units, its tail
#: counterpart, a 3-D expert leaf and a bias; the port's names split the
#: stacked leaf per unit, as the model's layers do
SHAPES = {"units_scale": (2, 24), "tail_scale": (24,), "w": (24, 16),
          "experts": (3, 8, 16), "b": (16,)}


def _trees(seed, dtype=np.float32, scale=1.0):
    r = np.random.default_rng(seed)
    return {n: (r.standard_normal(s) * scale).astype(dtype)
            for n, s in SHAPES.items()}


def _split(tree):
    """The port's names: ``units_scale`` as ``u0``, ``u1``."""
    out = {n: v for n, v in tree.items() if n != "units_scale"}
    out["u0"], out["u1"] = tree["units_scale"][0], tree["units_scale"][1]
    return out


def _t(tree, dtype=None):
    return {n: torch.tensor(np.asarray(v, np.float32)).to(
        dtype or torch.float32) for n, v in tree.items()}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_update_matches_the_reference(moments, clip):
    """Three updates of the same params by the same grads (large enough
    to clip at 1.0), moments in ``moments``; the stacked unit scale is
    decayed in the reference (2-D), so its per-unit halves are decayed in
    the port by ``decay``, and the 1-D tail scale and bias are not."""
    sched = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)
    ref = RefAdamW(schedule=RefWarmupCosine(**sched), clip_norm=clip,
                   moment_dtype=moments)
    port = AdamW(schedule=WarmupCosine(**sched), clip_norm=clip,
                 moment_dtype=moments)
    params = _trees(0)
    ref_p = {n: jnp.asarray(v) for n, v in params.items()}
    ref_state = ref.init(ref_p)
    port_p = _t(_split(params))
    state = port.init(port_p)
    decay = {n: n in ("u0", "u1", "w", "experts") for n in port_p}
    for k in range(3):
        grads = _trees(10 + k, scale=3.0)
        ref_p, ref_state, ref_m = ref.update(
            {n: jnp.asarray(v) for n, v in grads.items()}, ref_state, ref_p)
        port_p, state, m = port.update(_t(_split(grads)), state, port_p,
                                       decay=decay)
        _close(m["grad_norm"], ref_m["grad_norm"], **F32_TOL)
        _close(m["lr"], ref_m["lr"], **F32_TOL)
    assert int(state.step) == int(ref_state.step) == 3
    for tree, want in ((port_p, ref_p), (state.mu, ref_state.mu),
                       (state.nu, ref_state.nu)):
        want = _split({n: np.asarray(v, np.float32)
                       for n, v in want.items()})
        for n, v in tree.items():
            assert v.shape == want[n].shape, n
            _close(v.float(), want[n], atol=1e-7, rtol=1e-6)
        if tree is not port_p:
            assert {v.dtype for v in tree.values()} == {
                getattr(torch, moments)}


def test_adamw_default_decay_is_by_the_tensors_ndim():
    port = AdamW(schedule=WarmupCosine(peak_lr=1e-2, warmup_steps=1))
    p = {"w": torch.ones(4, 4), "b": torch.ones(4)}
    state = port.init(p)
    zeros = {n: torch.zeros_like(v) for n, v in p.items()}
    port.update(zeros, state, p)
    assert bool((p["w"] < 1).all()) and bool((p["b"] == 1).all())


def test_global_norm_matches_the_reference():
    tree = _trees(3)
    _close(global_norm(_t(tree)),
           ref_global_norm({n: jnp.asarray(v) for n, v in tree.items()}),
           **F32_TOL)
    bf = _t(tree, torch.bfloat16)
    _close(global_norm(bf), ref_global_norm(
        {n: jnp.asarray(v.float().numpy(), jnp.bfloat16)
         for n, v in bf.items()}), **F32_TOL)


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_compression_with_error_feedback_matches_the_reference(mode):
    """Three steps of error feedback, equal at 0; the stacked unit leaf
    shares one int8 scale, as the port's ``leaves`` says."""
    ref, port = RefGradCompression(mode), GradCompression(mode)
    assert port.wire_bytes_ratio() == ref.wire_bytes_ratio()
    params = _trees(0)
    ref_err = ref.init_error({n: jnp.asarray(v) for n, v in params.items()})
    err = port.init_error(_t(_split(params)))
    assert (err is None) == (ref_err is None) == (mode == "none")
    leaves = {n: "units_scale" if n in ("u0", "u1") else n
              for n in _split(params)}
    for k in range(3):
        grads = _trees(20 + k, scale=0.01)
        want, ref_err = ref.compress(
            {n: jnp.asarray(v) for n, v in grads.items()}, ref_err)
        got, err = port.compress(_t(_split(grads)), err, leaves)
        want = _split({n: np.asarray(v) for n, v in want.items()})
        for n, v in got.items():
            _close(v, want[n], atol=0, rtol=0)
        if mode != "none":
            want_e = _split({n: np.asarray(v) for n, v in ref_err.items()})
            for n, v in err.items():
                _close(v, want_e[n], atol=0, rtol=0)


# ---- data ------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(vocab=97, seq_len=16, global_batch=4, seed=3),
    dict(vocab=50, seq_len=8, global_batch=2, frontend=(4, 16)),
    dict(vocab=2048, seq_len=8, global_batch=2, num_codebooks=4, seed=7),
    dict(vocab=262144, seq_len=64, global_batch=3, seed=11)])
def test_synthetic_lm_is_bit_equal_to_the_reference(kw):
    port, ref = SyntheticLM(**kw), RefSyntheticLM(**kw)
    for step in (0, 1, 5, 1000):
        a, b = port.batch(step), ref.batch(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    for a, b, _ in zip(port, ref, range(3)):
        assert np.array_equal(a["tokens"], b["tokens"])


def test_memmap_corpus_matches_the_reference(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(0).integers(0, 500, 4096).astype(np.int32).tofile(
        path)
    port = MemmapCorpus(path, vocab=500, seq_len=32, global_batch=4, seed=2)
    ref = RefMemmapCorpus(path, vocab=500, seq_len=32, global_batch=4,
                          seed=2)
    for step in (0, 3, 9):
        a, b = port.batch(step), ref.batch(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_prefetcher_order_and_resume():
    src = SyntheticLM(vocab=101, seq_len=8, global_batch=2, seed=1)
    pf, ref = Prefetcher(src, start_step=5, depth=2), RefPrefetcher(
        RefSyntheticLM(vocab=101, seq_len=8, global_batch=2, seed=1),
        start_step=5, depth=2)
    try:
        for _ in range(4):
            (s, a), (t, b) = pf.next(), ref.next()
            assert s == t and np.array_equal(a["tokens"], b["tokens"])
        assert s == 8
    finally:
        pf.close()
        ref.close()
    assert not pf._thread.is_alive()
    on = Prefetcher(src, start_step=6, depth=1)
    try:
        step, batch = on.next()
        assert step == 6 and isinstance(batch["tokens"], np.ndarray)
        assert np.array_equal(batch["labels"], src.batch(6)["labels"])
    finally:
        on.close()


# ---- checkpoints -------------------------------------------------------------------

def _state_tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(4, 8, generator=g),
                       "layers.0.b": torch.randn(3, generator=g)},
            "opt": AdamWState(torch.tensor(7, dtype=torch.int32),
                              {"w": torch.randn(4, 8, generator=g).to(
                                  torch.bfloat16)},
                              {"w": torch.rand(4, 8, generator=g).to(
                                  torch.bfloat16)}),
            "units": (torch.ones(3), torch.zeros(3, dtype=torch.int64))}


def _leaves(tree):
    from repro_torch.checkpoint.manager import _leaves as leaves
    return list(leaves(tree))


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = _state_tree(0)
    mgr.save(12, tree)
    assert mgr.latest_step() == 12
    got = mgr.restore(12, _state_tree(1))
    assert isinstance(got["opt"], AdamWState)
    assert isinstance(got["units"], tuple)
    for (k, a), (j, b) in zip(_leaves(tree), _leaves(got)):
        assert k == j and a.dtype == b.dtype and b.device.type == "cpu"
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b), k
    assert mgr.restore(12, tree, device="cpu")["opt"].step.item() == 7


def test_checkpoint_layout_is_the_references(tmp_path):
    """The reference restores the port's float leaves, and the port the
    reference's checkpoint (``step_%08d/tree.npz`` and ``meta.json``)."""
    tree = {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "opt": {"step": np.asarray(7, np.int32)}}
    CheckpointManager(str(tmp_path / "a")).save(3, tree)
    got = RefCheckpointManager(str(tmp_path / "a")).restore(3, tree)
    assert np.array_equal(got["params"]["w"], tree["params"]["w"])
    RefCheckpointManager(str(tmp_path / "b")).save(4, tree)
    assert sorted(os.listdir(tmp_path / "b" / "step_00000004")) == \
        sorted(os.listdir(tmp_path / "a" / "step_00000003"))
    got = CheckpointManager(str(tmp_path / "b")).restore(4, tree)
    assert np.array_equal(got["params"]["w"].numpy(), tree["params"]["w"])


def test_checkpoint_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state_tree(s))
    assert mgr.steps() == [3, 4]


def test_async_save_snapshots_before_it_returns(tmp_path):
    """A CPU leaf changed in place right after an async save is saved as
    it was at the call."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = _state_tree(5)
    want = tree["params"]["w"].clone()
    mgr.save(5, tree, blocking=False)
    tree["params"]["w"].add_(1.0)
    mgr.wait()
    assert mgr.latest_step() == 5
    assert torch.equal(mgr.restore(5, tree)["params"]["w"], want)


def test_async_save_error_surfaces_at_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), keep=3)

    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", fail)
    mgr.save(1, _state_tree(0), blocking=False)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                        # the error is raised once
    assert mgr.latest_step() is None


def test_partial_tmp_dirs_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _state_tree(1))
    # a crashed writer leaves a tmp dir and a step dir without meta
    os.makedirs(tmp_path / "step_00000002.tmp")
    os.makedirs(tmp_path / "step_00000003")
    assert mgr.latest_step() == 1


# ---- watchdog, restarts --------------------------------------------------------------

def test_watchdog_flags_the_references_outliers():
    times = [0.1] * 10 + [0.9] + [0.1] * 5 + [0.5, 0.31, 0.29]
    port, ref = fault.StepWatchdog(warmup_steps=3), ref_fault.StepWatchdog(
        warmup_steps=3)
    flags = [(port.observe(i, t), ref.observe(i, t))
             for i, t in enumerate(times)]
    assert all(a == b for a, b in flags)
    assert port.straggler_steps == ref.straggler_steps == [10, 16, 17]
    assert port.median == ref.median


@pytest.mark.parametrize("impl", [fault, ref_fault])
def test_restart_loop_recovers_like_the_reference(impl):
    saved, crashes, log = {}, {"left": 2}, []

    def step_fn(step, state):
        if step == 7 and crashes["left"] > 0:
            crashes["left"] -= 1
            raise impl.SimulatedPreemption("node lost")
        log.append(step)
        return {"x": state["x"] + 1}

    # no step is a straggler: a save the watchdog made on a slow step
    # would move the point the restarts resume from
    report = impl.run_with_restarts(
        lambda: (0, {"x": 0}), step_fn,
        lambda step, state: saved.update(ckpt=(step, dict(state))),
        lambda: saved.get("ckpt"), total_steps=12, checkpoint_every=5,
        max_restarts=5, watchdog=impl.StepWatchdog(threshold=float("inf")))
    assert (report.restarts, report.completed_steps) == (2, 12)
    assert saved["ckpt"][0] == 12
    assert log.count(5) == 3 and log.count(6) == 3 and log.count(11) == 1
    with pytest.raises(impl.SimulatedPreemption):
        impl.run_with_restarts(
            lambda: (0, {}), lambda s, st: (_ for _ in ()).throw(
                impl.SimulatedPreemption("always")),
            lambda *a: None, lambda: None, total_steps=3, max_restarts=2)


# ---- the launcher ---------------------------------------------------------------------

def _tiny_cfg():
    cfg = get_arch("starcoder2-7b").reduced(d_model=64, vocab=128)
    return dataclasses.replace(cfg, n_layers=2)


def test_loss_decreases():
    cfg = _tiny_cfg()
    run = train.build_run(cfg, steps=60, lr=3e-3, device="cpu")
    data = SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=0)
    batch0 = {k: torch.as_tensor(v) for k, v in data.batch(0).items()}
    run.opt_state, run.comp_error, first = run.train_step(
        run.opt_state, run.comp_error, batch0)
    metrics = train.train_loop(run, data, 60, quiet=True)
    assert metrics["ce"] < float(first["ce"]) * 0.9


def test_resume_reproduces_uninterrupted_run(tmp_path):
    cfg = _tiny_cfg()
    data = SyntheticLM(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=2)
    kw = dict(steps=30, lr=1e-3, seed=3, device="cpu", compression="int8")
    run_a = train.build_run(cfg, **kw)
    train.train_loop(run_a, data, 30, quiet=True)
    # no step is a straggler: a save the watchdog made on a slow step
    # would add a checkpoint to the ones asserted below
    run_b = train.build_run(cfg, ckpt_dir=str(tmp_path), **kw)
    run_b.watchdog = fault.StepWatchdog(threshold=float("inf"))
    train.train_loop(run_b, data, 15, checkpoint_every=5, quiet=True)
    run_c = train.build_run(cfg, ckpt_dir=str(tmp_path), **kw)
    run_c.watchdog = fault.StepWatchdog(threshold=float("inf"))
    train.train_loop(run_c, data, 30, checkpoint_every=50, quiet=True)
    assert run_c.ckpt.steps() == [10, 15, 30]
    assert int(run_c.opt_state.step) == 30
    for n, p in run_a.params.items():
        _close(run_c.params[n].detach(), p.detach().numpy(), atol=1e-5,
               rtol=0)


def _ref_params_for(cfg):
    """``cfg`` as the reference's config, and its params tree drawn with
    numpy (N(0, 1/fan_in) dense weights, N(0, 1) embeddings, norm scales
    and biases about their init)."""
    from repro.models import transformer as ref_transformer
    ref_cfg = dataclasses.replace(REF_ARCHS[cfg.name].reduced(
        d_model=cfg.d_model, vocab=cfg.vocab), n_layers=cfg.n_layers)
    assert convert.arch_from_fields(**dataclasses.asdict(ref_cfg)) == cfg
    with ref_common.abstract_init():
        tree = ref_common.split_params(ref_transformer.build(ref_cfg).init(
            jax.random.PRNGKey(0)))[0]
    r = np.random.default_rng(4)

    def draw(path, sds):
        x = r.standard_normal(sds.shape)
        name = str(getattr(path[-1], "key", ""))
        if name in ("scale", "bias"):
            x = (1.0 if name == "scale" and cfg.norm == "layer" else 0.0) \
                + x * 0.1
        elif name != "embed":
            x = x / np.sqrt(sds.shape[-2])
        return np.asarray(x, np.float32)

    return ref_cfg, jax.tree_util.tree_map_with_path(draw, tree)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_loop_matches_the_reference_from_the_same_params(accum):
    """``build_run`` and ``train_loop`` of both packages, both runs given
    the same parameters and AdamW state at step 3 (from zero moments the
    first update turns a near-zero gradient's rounding into a whole ±lr):
    4 steps of the same stream, the parameters at atol 2e-5."""
    cfg = _tiny_cfg()
    ref_cfg, params = _ref_params_for(cfg)
    r = np.random.default_rng(8)
    mu, nu = (jax.tree.map(lambda v: np.asarray(
        r.standard_normal(v.shape) * s, np.float32), params)
        for s in (1e-3, 1e-5))
    nu = jax.tree.map(np.abs, nu)
    kw = dict(steps=4, lr=1e-3, accum=accum)
    ref_run = ref_train.build_run(ref_cfg, **kw)
    ref_run.params = jax.tree.map(jnp.asarray, params)
    ref_run.opt_state = ref_run.opt_state._replace(
        step=jnp.asarray(3, jnp.int32), mu=jax.tree.map(jnp.asarray, mu),
        nu=jax.tree.map(jnp.asarray, nu))
    run = train.build_run(cfg, device="cpu", **kw)
    run.model.load_state_dict(convert.lm_params_from_numpy(cfg, params,
                                                           train=True))
    run.load_state_tree({"params": run.params,
                         "opt": convert.adamw_state_from_numpy(
                             cfg, (3, mu, nu))})
    data = dict(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=6)
    want = ref_train.train_loop(ref_run, RefSyntheticLM(**data), 4,
                                quiet=True)
    got = train.train_loop(run, SyntheticLM(**data), 4, quiet=True)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], atol=1e-5, rtol=1e-5)
    wants = convert.lm_params_from_numpy(cfg, jax.tree.map(
        np.asarray, ref_run.params), train=True)
    for n, p in run.params.items():
        _close(p.detach(), wants[n].numpy(), atol=RUN_ATOL, rtol=0)


def test_a_mesh_is_refused_and_named():
    with pytest.raises(ValueError, match="partitioner.*shardings_from_specs"):
        train.build_run(_tiny_cfg(), steps=1, device="cpu", mesh=object())
    run = train.build_run(_tiny_cfg(), steps=1, device="cpu")
    with pytest.raises(ValueError, match="partitioner.*shardings_from_specs"):
        train.train_loop(run, None, 1, rules=object())


def test_the_training_build_is_required():
    from repro_torch.models import transformer
    from repro_torch.runtime.trainer import make_train_step
    model = transformer.build(_tiny_cfg(), device="cpu")
    with pytest.raises(ValueError, match="train=True"):
        make_train_step(model, AdamW())


def test_main_trains_on_the_cpu_when_asked(capsys, tmp_path):
    metrics = train.main(["--arch", "rwkv6-7b", "--reduced", "--device",
                          "cpu", "--steps", "3", "--batch", "2", "--seq",
                          "16", "--compression", "bf16", "--ckpt-dir",
                          str(tmp_path)])
    out = capsys.readouterr().out
    assert "device=cpu" in out and "[train] done" in out
    assert all(np.isfinite(v) for v in metrics.values())
    assert CheckpointManager(str(tmp_path)).latest_step() == 3


def test_no_gpu_raises_rp110(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: train.build_run(_tiny_cfg(), steps=1),
                 lambda: train.main(["--arch", "gemma3-4b", "--reduced"])):
        with pytest.raises(DiagnosticError, match="RP110"):
            call()
