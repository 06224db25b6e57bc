"""The LM training step of the port against the JAX package, on the CPU,
for all ten reduced architectures.

Both sides start from the same parameters (the reference's params tree
drawn with numpy, carried across by ``convert.lm_params_from_numpy(...,
train=True)``), the same AdamW moments at step 3 (``convert.
adamw_state_from_numpy``) and the same batch (``SyntheticLM``, a few
labels set to -100).  Tolerances (float32 compute):

* ``LMModel.loss`` and its metrics at atol = rtol = 1e-5 (``LOSS_TOL``);
* each gradient leaf within 1e-4 of that leaf's max |g| (``GRAD_SHARE``),
  compared before any update: AdamW's first step would turn a near-zero
  gradient's sign into a whole ±lr;
* a whole step (``make_train_step``) with ``accum=1``, ``accum=2`` and
  ``int8`` compression: parameters at atol 2e-5 with lr 1e-3 (the
  reference's own accumulation tolerance, ``tests/test_train_loop.py``),
  the moments within 1e-4 of each leaf's max (a bfloat16 moment one
  bfloat16 ulp, rtol 2^-7, more), the step equal.  Under ``int8`` the
  new compression error carries the gradient's own (``GRAD_SHARE`` of
  the leaf's max |g + e|, 127 quanta), and one scale covers each
  reference leaf, all units of a pattern position.  A gradient within
  ``GRAD_SHARE`` of the reference's rounds to the next quantum where the
  reference's quantizer input lies within ``TIE_BAND`` of a rounding tie
  (x.5 quanta; ``127 * GRAD_SHARE`` is 0.0127): those elements
  (``_near_ties``, about ``2 * TIE_BAND`` of a leaf, held under 10%)
  are held to one quantum of the error and left out of the other
  comparisons.

In bfloat16 compute, the main path's, the loss and metrics hold at rtol
1e-3 (``BF16_LOSS_TOL``) and each gradient leaf's relative L2 distance
from the reference's within twice the reference's own distance between
its bfloat16 and float32 gradients of the leaf (``BF16_NOISE``).

Port-only checks hold at 0: remat ``none``, ``unit`` and ``layer``; the
training build's forward against the serving build's in bfloat16
compute; ``.grad`` accumulation of ``loss / accum`` against the divided
per-microbatch gradients.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.data import SyntheticLM
from repro.models import common as ref_common
from repro.models import transformer as ref_transformer
from repro.optim import AdamW as RefAdamW
from repro.optim import AdamWState as RefAdamWState
from repro.optim import GradCompression as RefGradCompression
from repro.optim import WarmupCosine as RefWarmupCosine
from repro.runtime import trainer as ref_trainer

from repro_torch import convert
from repro_torch.models import transformer
from repro_torch.optim import AdamW, GradCompression, WarmupCosine
from repro_torch.runtime.trainer import make_train_step

LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
#: bfloat16 compute: the loss and metrics (about five times the largest
#: reading, granite-moe's 1.8e-4), and the factor on the reference's own
#: bfloat16-to-float32 distance of a gradient leaf (the largest reading
#: 1.47, grok-1's ``wi_gate``)
BF16_LOSS_TOL = dict(atol=0, rtol=1e-3)
BF16_NOISE = 2.0
GRAD_SHARE = 1e-4
PARAM_ATOL = 2e-5
MOMENT_SHARE = 1e-4
BF16_RTOL = 2.0 ** -7
TIE_BAND = 0.02
LR = 1e-3
ALL = tuple(sorted(REF_ARCHS))
METRICS = ("ce", "lb_loss", "z_loss", "tokens")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Intra-op threads: one.  These CPU tensors are small, and the test
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: leaves drawn N(centre, 0.1^2) (norm scales and biases, mixes, the
#: decay and SSM constants); ``dt_bias`` as the reference draws it
_AROUND = {"scale": 0.0, "bias": 0.0, "q_scale": 0.0, "k_scale": 0.0,
           "q_norm": 0.0, "kv_norm": 0.0, "conv_b": 0.0, "mu_x": 0.5,
           "mu": 0.5, "mu_k": 0.5, "mu_r": 0.5, "w0": -0.6, "u": 0.0,
           "ln_scale": 1.0, "ln_bias": 0.0, "d": 1.0}


def _abstract(ref_model):
    with ref_common.abstract_init():
        return ref_common.split_params(ref_model.init(
            jax.random.PRNGKey(0)))[0]


def _ref_params(ref_model, seed=0):
    """The reference's params tree drawn with numpy (as
    ``tests/test_torch_lm.py`` draws it): dense weights N(0, 1/fan_in),
    embeddings N(0, 1), the leaves of ``_AROUND`` about their centre."""
    r = np.random.default_rng(seed)

    def draw(path, sds):
        name = str(getattr(path[-1], "key", ""))
        x = r.standard_normal(sds.shape)
        if name in _AROUND:
            x = _AROUND[name] + x * 0.1
        elif name == "a_log":
            x = np.log(np.arange(1, sds.shape[-1] + 1)) + x * 0.1
        elif name == "dt_bias":
            x = np.log(np.expm1(np.exp(r.uniform(np.log(1e-3),
                                                 np.log(1e-1), sds.shape))))
        elif name != "embed":
            x = x / np.sqrt(sds.shape[-2])
        return jnp.asarray(x.astype(np.float32), sds.dtype)

    return jax.tree_util.tree_map_with_path(draw, _abstract(ref_model))


def _ref_state(ref_model, cfg, seed=1):
    """An AdamW state at step 3 (moments in ``moment_dtype``: ``mu`` about
    1e-3, ``nu`` positive about 1e-5) and a compression error about
    1e-4, as the reference's trees."""
    r = np.random.default_rng(seed)
    dt = jnp.dtype(cfg.moment_dtype)
    tree = _abstract(ref_model)

    def draw(scale, positive=False):
        def one(sds):
            x = r.standard_normal(sds.shape) * scale
            return jnp.asarray(np.abs(x) if positive else x, dt)
        return jax.tree.map(one, tree)

    err = jax.tree.map(lambda s: jnp.asarray(
        r.standard_normal(s.shape) * 1e-4, jnp.float32), tree)
    return RefAdamWState(jnp.asarray(3, jnp.int32), draw(1e-3),
                         draw(1e-5, positive=True)), err


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _case(name, **over):
    """(reference config, reference model, its params, port config)."""
    ref_cfg = dataclasses.replace(REF_ARCHS[name].reduced(), **over)
    ref_model = ref_transformer.build(ref_cfg)
    cfg = convert.arch_from_fields(**dataclasses.asdict(ref_cfg))
    return ref_cfg, ref_model, _ref_params(ref_model), cfg


def _model(name, train=True, **over):
    """A port model holding ``_case(name, **over)``'s parameters."""
    _, _, params, cfg = _case(name, **over)
    model = transformer.build(cfg, device="cpu", seed=1, train=train)
    model.load_state_dict(convert.lm_params_from_numpy(
        cfg, _np(params), "cpu", train=train))
    return model


def _batch(cfg, B=4, S=32, seed=5):
    """A ``SyntheticLM`` batch (llava with its frontend embeddings,
    musicgen with ``(B, S, K)`` tokens), the first labels ignored."""
    data = SyntheticLM(vocab=cfg.vocab, seq_len=S, global_batch=B,
                       seed=seed, num_codebooks=cfg.num_codebooks,
                       frontend=(cfg.img_tokens, cfg.frontend_dim)
                       if cfg.frontend_dim else None)
    batch = data.batch(0)
    batch["labels"] = batch["labels"].copy()
    batch["labels"][0, :3] = -100
    return batch


def _port(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _within_share(got: torch.Tensor, want, share, what):
    want = np.asarray(want, dtype=np.float64)
    err = np.abs(got.double().numpy() - want).max(initial=0.0)
    limit = share * np.abs(want).max(initial=0.0)
    assert err <= limit, f"{what}: {err} > {limit}"


def _close(got: torch.Tensor, want, what, **tol):
    np.testing.assert_allclose(got.double().numpy(),
                               np.asarray(want, dtype=np.float64),
                               err_msg=what, **tol)


@functools.lru_cache(maxsize=None)
def _ref_loss_and_grads(name, **over):
    ref_cfg, ref_model, params, _ = _case(name, **over)
    batch = {k: jnp.asarray(v) for k, v in _batch(ref_cfg).items()}
    (total, metrics), grads = jax.jit(jax.value_and_grad(
        ref_model.loss, has_aux=True))(params, batch)
    return float(total), _np(metrics), _np(grads)


# ---- loss and gradients --------------------------------------------------------

@pytest.mark.parametrize("name", ALL)
def test_loss_and_grads_match_the_reference(name):
    ref_cfg, _, _, cfg = _case(name)
    want_total, want_metrics, want_grads = _ref_loss_and_grads(name)
    model = _model(name)
    total, metrics = model.loss(_port(_batch(ref_cfg)))
    _close(total.detach(), want_total, "total", **LOSS_TOL)
    assert sorted(metrics) == sorted(want_metrics)
    for k in METRICS:
        _close(metrics[k].detach(), want_metrics[k], k, **LOSS_TOL)
    total.backward()
    want = convert.lm_tree_from_numpy(cfg, want_grads)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for n, g in got.items():
        assert g is not None, n
        _within_share(g, want[n].numpy(), GRAD_SHARE, n)


def _rel_l2(got, want) -> float:
    got, want = (np.asarray(t, dtype=np.float64) for t in (got, want))
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("name", ALL)
def test_bf16_loss_and_grads_match_the_reference(name):
    """bfloat16 compute, the main path's (``reduced()`` sets float32):
    the loss and metrics at ``BF16_LOSS_TOL``; each gradient leaf's
    relative L2 distance from the reference's bfloat16 gradient within
    ``BF16_NOISE`` times the reference's own distance between its
    bfloat16 and float32 gradients of that leaf (1e-5 besides)."""
    ref_cfg, _, _, cfg = _case(name, compute_dtype="bfloat16")
    want_total, want_metrics, want_grads = _ref_loss_and_grads(
        name, compute_dtype="bfloat16")
    model = _model(name, compute_dtype="bfloat16")
    total, metrics = model.loss(_port(_batch(ref_cfg)))
    _close(total.detach(), want_total, "total", **BF16_LOSS_TOL)
    for k in METRICS:
        _close(metrics[k].detach(), want_metrics[k], k, **BF16_LOSS_TOL)
    total.backward()
    want = convert.lm_tree_from_numpy(cfg, want_grads)
    f32 = convert.lm_tree_from_numpy(cfg, _ref_loss_and_grads(name)[2])
    for n, p in model.named_parameters():
        noise = _rel_l2(want[n].float(), f32[n].float())
        err = _rel_l2(p.grad.double(), want[n].float())
        assert err <= BF16_NOISE * noise + 1e-5, (n, err, noise)


# ---- whole steps ---------------------------------------------------------------

def _optimizers(cfg, ref_cfg):
    sched = dict(peak_lr=LR, warmup_steps=2, total_steps=10)
    return (AdamW(schedule=WarmupCosine(**sched),
                  moment_dtype=cfg.moment_dtype),
            RefAdamW(schedule=RefWarmupCosine(**sched),
                     moment_dtype=ref_cfg.moment_dtype))


def _step_both(name, accum, mode, B=4, **over):
    """One step of each package from the same parameters, state at step
    3 and batch: (port model, port state, port error, port metrics,
    reference params, state, error and metrics as numpy)."""
    ref_cfg, ref_model, params, cfg = _case(name, **over)
    opt, ref_opt = _optimizers(cfg, ref_cfg)
    ref_state, ref_err = _ref_state(ref_model, ref_cfg)
    if mode == "none":
        ref_err = None
    batch = _batch(ref_cfg, B=B)
    ref_step = jax.jit(ref_trainer.make_train_step(
        ref_model, ref_opt, accum=accum,
        compression=RefGradCompression(mode)))
    want = _np(ref_step(params, ref_state, ref_err,
                        {k: jnp.asarray(v) for k, v in batch.items()}))

    model = _model(name, **over)
    state = convert.adamw_state_from_numpy(cfg, _np(ref_state))
    err = None if ref_err is None else convert.lm_tree_from_numpy(
        cfg, _np(ref_err))
    step = make_train_step(model, opt, accum=accum,
                           compression=GradCompression(mode))
    state, err, metrics = step(state, err, _port(batch))
    return (model, state, err, metrics) + tuple(want)


def _near_ties(name, **over):
    """Under ``int8``: per parameter name, the elements whose reference
    quantizer input ``(g + e) / scale`` lies within ``TIE_BAND`` of a
    rounding tie, and each element's quantum ``scale`` (one per reference
    leaf, which stacks the units)."""
    ref_cfg, ref_model, _, cfg = _case(name, **over)
    grads = _ref_loss_and_grads(name)[2]
    err = _ref_state(ref_model, ref_cfg)[1]

    def quantum(g, e):
        x = np.asarray(g, np.float64) + np.asarray(e, np.float64)
        return np.full(x.shape, max(np.abs(x).max(), 1e-12) / 127.0)

    def near(g, e):
        x = np.asarray(g, np.float64) + np.asarray(e, np.float64)
        q = quantum(g, e)
        return np.abs(np.abs(x / q) % 1.0 - 0.5) < TIE_BAND

    err = _np(err)
    return ({n: t.numpy() > 0.5 for n, t in convert.lm_tree_from_numpy(
                cfg, jax.tree.map(near, grads, err)).items()},
            convert.lm_tree_from_numpy(cfg, jax.tree.map(quantum, grads,
                                                         err)))


def _check_step(name, accum, mode, B=4, **over):
    cfg = _case(name, **over)[3]
    model, state, err, metrics, want_p, want_s, want_e, want_m = \
        _step_both(name, accum, mode, B=B, **over)
    near, quantum = _near_ties(name, **over) if mode == "int8" else ({}, {})

    def off(n, t):
        """``t`` with the near-tie elements of ``n`` zeroed."""
        return t.masked_fill(torch.from_numpy(near[n]), 0.0) if n in near \
            else t

    for n, t in convert.lm_params_from_numpy(cfg, want_p,
                                             train=True).items():
        assert near.get(n, np.zeros(1)).mean() < 0.1, n
        _close(off(n, model.state_dict()[n]), off(n, t).numpy(), n,
               atol=PARAM_ATOL, rtol=0)
    assert int(state.step) == int(want_s.step) == 4
    for moments, ref in ((state.mu, want_s.mu), (state.nu, want_s.nu)):
        for n, t in convert.lm_tree_from_numpy(cfg, ref).items():
            assert moments[n].dtype == t.dtype, n
            got, t = off(n, moments[n].float()), off(n, t.float())
            if moments[n].dtype == torch.bfloat16:
                _close(got, t.numpy(), n, rtol=BF16_RTOL,
                       atol=MOMENT_SHARE * t.abs().max().item())
            else:
                _within_share(got, t.numpy(), MOMENT_SHARE, f"moment {n}")
    if want_e is not None:
        for n, t in convert.lm_tree_from_numpy(cfg, want_e).items():
            # the error carries the gradient's own: GRAD_SHARE of the
            # leaf's max |g + e| (127 quanta)
            _close(off(n, err[n]), off(n, t).numpy(), f"error {n}", rtol=0,
                   atol=GRAD_SHARE * 127 * quantum[n].max().item())
            assert bool(((err[n] - t).abs() <= 1.01 * quantum[n]).all()), n
    for k in METRICS + ("grad_norm", "lr"):
        _close(metrics[k], want_m[k], k, **LOSS_TOL)


@pytest.mark.parametrize("name", ALL)
@pytest.mark.parametrize("accum,mode", [(1, "none"), (2, "none"),
                                        (1, "int8")])
def test_train_step_matches_the_reference(name, accum, mode):
    _check_step(name, accum, mode)


def test_tail_norms_are_not_decayed_like_the_reference():
    """gemma3 at 8 layers: one unit of 6 and a tail of 2.  The reference
    decays the unit layers' norm scales ((units, d) there) and not the
    tail's ((d,)); the port decides by the reference's ndim."""
    model = _model("gemma3-4b", n_layers=8)
    mask = model.weight_decay_mask()
    assert mask["layers.0.pre_norm.scale"]
    assert mask["layers.5.post_ffn_norm.scale"]
    assert not mask["layers.6.pre_norm.scale"]
    assert not mask["layers.7.mixer.q_scale"]
    assert mask["layers.7.mixer.wq"] and not mask["final_norm.scale"]
    _check_step("gemma3-4b", 1, "none", n_layers=8)


def test_accum_not_a_power_of_two_matches_the_reference():
    """accum 3: each microbatch's gradient divided by 3 and added into a
    separate accumulator, as the reference adds it."""
    _check_step("starcoder2-7b", 3, "none", B=6)


def test_loss_over_accum_into_grad_equals_divided_grads():
    """The claim behind ``make_train_step``'s direct path: for a
    power-of-two ``accum``, backpropagating ``loss / accum`` of each
    microbatch into ``.grad`` equals ``(0 + g0 / accum) + g1 / accum`` of
    the microbatches' own gradients, at 0."""
    model = _model("granite-moe-3b-a800m")
    batch = _port(_batch(model.cfg))
    micro = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()}
             for i in range(2)]
    params = dict(model.named_parameters())
    for mb in micro:
        (model.loss(mb)[0] / 2).backward()
    direct = {n: p.grad.clone() for n, p in params.items()}
    acc = {n: torch.zeros_like(p) for n, p in params.items()}
    for mb in micro:
        for p in params.values():
            p.grad = None
        model.loss(mb)[0].backward()
        for n, p in params.items():
            acc[n] = acc[n] + p.grad / 2
    for n in params:
        assert torch.equal(direct[n], acc[n]), n


# ---- port-only equalities --------------------------------------------------------

@pytest.mark.parametrize("name", ALL)
def test_remat_modes_equal(name):
    """``remat`` none, unit and layer: the same loss and gradients at 0."""
    batch = _port(_batch(_case(name)[3]))
    outs = []
    for remat in ("none", "unit", "layer"):
        model = _model(name)
        model.cfg = dataclasses.replace(model.cfg, remat=remat)
        total, _ = model.loss(batch)
        total.backward()
        outs.append((total.detach(), {n: p.grad for n, p in
                                      model.named_parameters()}))
    for total, grads in outs[1:]:
        assert torch.equal(total, outs[0][0])
        for n, g in grads.items():
            assert torch.equal(g, outs[0][1][n]), n


@pytest.mark.parametrize("name", ALL)
def test_training_build_forward_equals_the_serving_build(name):
    """bfloat16 compute: the serving build holds the cast weights, the
    training build casts at use; the logits and MoE losses equal at 0,
    with autograd recording (and remat by unit) and without."""
    over = dict(compute_dtype="bfloat16", remat="unit")
    serve, train = _model(name, False, **over), _model(name, True, **over)
    cfg = serve.cfg
    batch = _port(_batch(cfg))
    args = (batch["tokens"], batch.get("frontend_embeds"))
    with torch.no_grad():
        want = serve(*args)
        quiet = train(*args)
    got = train(*args)
    assert got.logits.requires_grad
    for out in (quiet, got):
        assert torch.equal(out.logits.detach(), want.logits)
        for k in want.aux:
            assert torch.equal(out.aux[k].detach(), want.aux[k]), k
