"""The LM serving path of the port against the JAX package, on the CPU.

The same configurations (the reference's dataclasses carried across by
``convert.arch_from_fields``) and the same weights (the reference's
params tree through ``convert.lm_params_from_numpy``) go through both
packages: ``repro`` under ``JAX_PLATFORMS=cpu``, ``repro_torch`` with
``device="cpu"``.  Modules in float32 at atol = rtol = 1e-5; whole
models at atol 1e-3, rtol 1e-4 (logits are about 100 in size); bfloat16
compute at 2e-2 of each row's max |logit|.

Random-init models echo their input under greedy decode, so the engine's
tokens prove little: every decode call's logits are compared too.  All
ten architectures: the dense GQA family, MLA (minicpm3), the llava
projector, MoE (granite, grok), RWKV-6, jamba's Mamba/attention/MoE
mix and musicgen's codebooks; the modules of the new families are held
one by one in ``tests/test_torch_lm_families.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.launch import serve as ref_serve
from repro.models import attention as ref_attention
from repro.models import common as ref_common
from repro.models import transformer as ref_transformer
from repro.runtime import trainer as ref_trainer

from repro_torch import convert
from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch import serve
from repro_torch.lint.diagnostics import DiagnosticError
from repro_torch.models import attention, common, transformer
from repro_torch.runtime import trainer

MODULE_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-3, rtol=1e-4)
BF16_SHARE = 2e-2
ALL = tuple(sorted(REF_ARCHS))
#: every architecture but musicgen, whose engine the reference cannot run
SERVED = tuple(n for n in ALL if REF_ARCHS[n].num_codebooks == 1)
RECURRENT = ("rwkv6-7b", "jamba-v0.1-52b")


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, tol=MODULE_TOL):
    np.testing.assert_allclose(got.double().numpy(),
                               np.asarray(want, dtype=np.float64), **tol)


def _close_to_row_max(got: torch.Tensor, want, share=BF16_SHARE):
    want = np.asarray(want, dtype=np.float64)
    err = np.abs(got.double().numpy() - want).max(axis=-1)
    assert np.all(err <= share * np.abs(want).max(axis=-1)), err.max()


#: leaves drawn N(centre, 0.1^2) (norm scales and biases, mixes, the
#: decay and SSM constants); ``dt_bias`` as the reference draws it
_AROUND = {"scale": 0.0, "bias": 0.0, "q_scale": 0.0, "k_scale": 0.0,
           "q_norm": 0.0, "kv_norm": 0.0, "conv_b": 0.0, "mu_x": 0.5,
           "mu": 0.5, "mu_k": 0.5, "mu_r": 0.5, "w0": -0.6, "u": 0.0,
           "ln_scale": 1.0, "ln_bias": 0.0, "d": 1.0}


def _ref_params(ref_model, seed=0):
    """The reference's params tree (its ``init`` structure and shapes),
    drawn with numpy: dense weights N(0, 1/fan_in), embeddings N(0, 1),
    norm scales, biases and the other vectors of ``_AROUND`` about their
    centre, ``a_log`` about the S4D-real log(1..d_state), so that every
    leaf matters."""
    with ref_common.abstract_init():
        tree = ref_common.split_params(ref_model.init(
            jax.random.PRNGKey(0)))[0]
    r = _rng(seed)

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

    return jax.tree_util.tree_map_with_path(draw, tree)


@functools.lru_cache(maxsize=None)
def _pair(name: str, **over):
    """(reference config, reference model, its params, the reference's
    jitted decode step, port model on the CPU holding the same
    weights)."""
    ref_cfg = dataclasses.replace(REF_ARCHS[name].reduced(), **over)
    ref_model = ref_transformer.build(ref_cfg)
    params = _ref_params(ref_model)
    cfg = convert.arch_from_fields(**dataclasses.asdict(ref_cfg))
    model = transformer.build(cfg, device="cpu", seed=1)
    model.load_state_dict(convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), "cpu"))
    ref_decode = jax.jit(ref_trainer.make_decode_step(ref_model))
    return ref_cfg, ref_model, params, ref_decode, model


@functools.lru_cache(maxsize=None)
def _ref_forward(name: str, **over):
    """The reference's jitted forward (logits, aux) for ``_pair(name,
    **over)``, compiled once for every test of the model."""
    ref_model = _pair(name, **over)[1]
    return jax.jit(lambda p, t, f: dataclasses.astuple(
        ref_model.forward(p, t, f)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Intra-op threads: one.  These CPU tensors are small, and the test
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- configs ------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_arch_configs_equal_the_reference(name):
    ref, port = REF_ARCHS[name], get_arch(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert (port.padded_vocab, port.units, port.uses_attention) == \
        (ref.padded_vocab, ref.units, ref.uses_attention)
    assert [dataclasses.asdict(l) for l in port.tail] == \
        [dataclasses.asdict(l) for l in ref.tail]
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert convert.arch_from_fields(**dataclasses.asdict(ref)) == port
    assert sorted(ARCHS) == sorted(REF_ARCHS)


@pytest.mark.parametrize("name", ALL)
def test_full_width_parameter_counts_equal_the_reference(name):
    ref_model = ref_transformer.build(REF_ARCHS[name])
    with ref_common.abstract_init():
        tree = ref_model.init(jax.random.PRNGKey(0))
    want = ref_common.param_count(ref_common.split_params(tree)[0])
    model = transformer.build(get_arch(name), device="meta")
    assert common.param_count(model) == want
    assert model.embed.device.type == "meta"


# ---- common --------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_apply_norm(kind):
    r = _rng(1)
    x = r.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 0.5
    p = {"scale": r.standard_normal(64).astype(np.float32)}
    if kind == "layer":
        p["bias"] = r.standard_normal(64).astype(np.float32)
    want = ref_common.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x), kind)
    got = common.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), kind)
    _close(got, want)


def test_rms_norm_headwise():
    r = _rng(2)
    x = r.standard_normal((2, 3, 4, 32)).astype(np.float32)
    s = r.standard_normal(32).astype(np.float32)
    _close(common.rms_norm(_t(x), 1.0 + _t(s)),
           ref_common.rms_norm_headwise(jnp.asarray(x), jnp.asarray(s)))


@pytest.mark.parametrize("theta", [1e4, 1e5, 1e6])
def test_rope(theta):
    r = _rng(3)
    x = r.standard_normal((2, 7, 4, 64)).astype(np.float32)
    pos = r.integers(0, 2048, size=(2, 7)).astype(np.int32)
    _close(common.rope_freqs(64, theta), ref_common.rope_freqs(64, theta))
    _close(common.rotate(_t(x), common.rope_tables(_t(pos), 64, theta)),
           ref_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_sinusoidal_embedding():
    pos = _rng(4).integers(0, 4096, size=(2, 9)).astype(np.int32)
    _close(common.sinusoidal_embedding(_t(pos), 128),
           ref_common.sinusoidal_embedding(jnp.asarray(pos), 128))


@pytest.mark.parametrize("cap", [None, 30.0, 50.0])
def test_softcap(cap):
    x = _rng(5).standard_normal((4, 33)).astype(np.float32) * 80
    _close(common.softcap(_t(x), cap), ref_common.softcap(jnp.asarray(x),
                                                           cap))


@pytest.mark.parametrize("act", ["gelu", "silu", "relu"])
def test_activations(act):
    x = _rng(6).standard_normal((3, 50)).astype(np.float32) * 4
    _close(common.ACTIVATIONS[act](_t(x)),
           ref_common.ACTIVATIONS[act](jnp.asarray(x)))
    if act == "gelu":
        _close(common.gelu_tanh(_t(x)), ref_common.gelu_tanh(jnp.asarray(x)))


@pytest.mark.parametrize("kind,act", [("swiglu", "gelu"), ("swiglu", "silu"),
                                      ("gelu_mlp", "gelu")])
def test_apply_mlp(kind, act):
    r = _rng(7)
    names = ("wi_gate", "wi_up", "wo") if kind == "swiglu" else ("wi", "wo")
    p = {n: (r.standard_normal((96, 64) if n == "wo" else (64, 96))
             / 8).astype(np.float32) for n in names}
    x = r.standard_normal((2, 5, 64)).astype(np.float32)
    want = ref_common.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), kind, act)
    _close(common.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x), kind,
                            act), want)


def test_take_embed_and_param_count():
    r = _rng(8)
    table = r.standard_normal((50, 16)).astype(np.float32)
    toks = r.integers(0, 50, size=(3, 4)).astype(np.int32)
    _close(common.take_embed(_t(table), _t(toks)),
           ref_common.take_embed(jnp.asarray(table), jnp.asarray(toks)))
    params, model = _pair("gemma3-4b")[2::2]
    assert common.param_count(model) == ref_common.param_count(params)


def test_initialisers_draw_the_reference_distributions():
    """Same distribution, not the same draw: moments of 2^17 samples."""
    gen = torch.Generator().manual_seed(0)
    got = common.dense_param(gen, (256, 512), torch.float32)
    want = np.asarray(ref_common.dense_param(
        jax.random.PRNGKey(0), (256, 512), (None, None), jnp.float32).value)
    bound = 2.0 / np.sqrt(256)
    assert float(got.abs().max()) <= bound + 1e-7
    assert np.abs(want).max() <= bound + 1e-7
    assert abs(float(got.std()) - want.std()) < 0.01 * want.std()
    assert abs(float(got.mean())) < 0.01 * want.std()
    emb = common.init_embed(gen, 512, 256, torch.float32)
    ref_emb = np.asarray(ref_common.init_embed(jax.random.PRNGKey(1), 512,
                                               256, jnp.float32).value)
    assert abs(float(emb.std()) - ref_emb.std()) < 0.01
    for kind in ("rms", "layer"):
        ref = ref_common.init_norm(None, 8, jnp.float32, kind)
        got = common.init_norm(8, torch.float32, kind)
        assert sorted(got) == sorted(ref)
        for k in got:
            assert np.array_equal(got[k].numpy(), np.asarray(ref[k].value))


# ---- attention -------------------------------------------------------------

def _qkv(seed, B=2, S=64, H=4, KV=2, D=32):
    r = _rng(seed)
    q, k, v = (r.standard_normal((B, S, n, D)).astype(np.float32)
               for n in (H, KV, KV))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return q, k, v, pos


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("cap", [None, 50.0])
def test_chunked_attention(window, cap):
    q, k, v, pos = _qkv(9)
    kw = dict(window=window, cap=cap, scale=0.3, chunk=16)
    want = ref_attention.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                           jnp.asarray(pos),
                                           jnp.asarray(pos), **kw)
    got = attention.chunked_attention(_t(q), _t(k), _t(v), _t(pos), _t(pos),
                                      **kw)
    _close(got, want)


def _gqa_params(cfg, seed):
    r = _rng(seed)
    d, H, KV, D = 64, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": r.standard_normal((d, H * D)), "wk": r.standard_normal(
        (d, KV * D)), "wv": r.standard_normal((d, KV * D)),
        "wo": r.standard_normal((H * D, d))}
    p = {n: (w / 8).astype(np.float32) for n, w in p.items()}
    if cfg.qk_norm:
        p["q_scale"] = r.standard_normal(D).astype(np.float32) / 4
        p["k_scale"] = r.standard_normal(D).astype(np.float32) / 4
    return p


def _attn_cfg(qk_norm=True, softcap=50.0):
    from repro_torch.configs.base import AttnCfg
    return AttnCfg(n_heads=4, n_kv_heads=2, head_dim=32, qk_norm=qk_norm,
                   softcap=softcap)


def _made(cfg, tp, positions, window, cache=None):
    """What the model makes once per call for ``apply_gqa``: the RoPE
    tables, the QK-norm weights and, with a cache, the step's position
    written and its slot and mask."""
    made = dict(positions=positions, window=window, cache=cache,
                rope=common.rope_tables(positions, cfg.head_dim,
                                        cfg.rope_theta))
    if cfg.qk_norm:
        made["qk_weights"] = (1.0 + tp["q_scale"], 1.0 + tp["k_scale"])
    if cache is not None:
        made["ring"] = attention.RingStep(
            *attention.write_positions(cache.pos, positions),
            attention.decode_bias(cache.pos, window))
    return made


def test_apply_gqa_decode_through_a_wrapping_ring():
    """Window 16, ring of 16, 40 steps: the ring wraps twice."""
    cfg = _attn_cfg()
    ref_cfg = ref_attention.AttnCfg(**dataclasses.asdict(cfg))
    p = _gqa_params(cfg, 10)
    xs = _rng(11).standard_normal((40, 2, 1, 64)).astype(np.float32)
    ref_cache = ref_attention.init_cache(ref_cfg, 2, 64, 16, jnp.float32)
    cache = attention.init_cache(cfg, 2, 64, 16, torch.float32)
    assert cache.k.shape[1] == ref_cache.k.shape[1] == 16
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    ref_step = jax.jit(lambda x, pos, cache: ref_attention.apply_gqa(
        jp, x, ref_cfg, positions=pos, window=16, cache=cache))
    for t in range(40):
        pos = np.full((2, 1), t, np.int32)
        want, ref_cache = ref_step(jnp.asarray(xs[t]), jnp.asarray(pos),
                                   ref_cache)
        got, cache = attention.apply_gqa(tp, _t(xs[t]), cfg,
                                         **_made(cfg, tp, _t(pos), 16, cache))
        _close(got, want)
    _close(cache.k, ref_cache.k)
    assert np.array_equal(cache.pos.numpy(), np.asarray(ref_cache.pos))


@pytest.mark.parametrize("window", [None, 16])
def test_decode_equals_prefill_in_the_port(window):
    cfg = _attn_cfg(softcap=None)
    tp = {k: _t(v) for k, v in _gqa_params(cfg, 12).items()}
    x = _t(_rng(13).standard_normal((2, 40, 64)).astype(np.float32))
    pos = torch.arange(40, dtype=torch.int32).expand(2, 40)
    full, _ = attention.apply_gqa(tp, x, cfg, **_made(cfg, tp, pos, window),
                                  chunk=8)
    cache = attention.init_cache(cfg, 2, 48, window, torch.float32)
    for t in range(40):
        got, cache = attention.apply_gqa(
            tp, x[:, t:t + 1], cfg,
            **_made(cfg, tp, pos[:, t:t + 1], window, cache))
        torch.testing.assert_close(got[:, 0], full[:, t], **MODULE_TOL)


# ---- whole models ---------------------------------------------------------

def _tokens(cfg, B, S, seed):
    """(B, S) tokens, or (B, S, K) for ``num_codebooks`` K > 1."""
    shape = (B, S, cfg.num_codebooks) if cfg.num_codebooks > 1 else (B, S)
    return _rng(seed).integers(0, cfg.vocab, size=shape).astype(np.int32)


def _frontend(cfg, B, seed=16):
    """llava's precomputed patch embeddings (B, img_tokens, frontend_dim),
    or None."""
    if not cfg.frontend_dim:
        return None
    return _rng(seed).standard_normal(
        (B, cfg.img_tokens, cfg.frontend_dim)).astype(np.float32)


def _forward_and_decode(name, steps, close, **over):
    """forward (with llava's frontend embeddings) and its MoE losses, then
    ``steps`` decode steps from empty caches of 32, each step's logits
    held to the reference's by ``close``."""
    ref_cfg, ref_model, params, ref_decode, model = _pair(name, **over)
    toks, fe = _tokens(ref_cfg, 2, 32, 14), _frontend(ref_cfg, 2)
    ref_fe = None if fe is None else jnp.asarray(fe)
    logits, aux = _ref_forward(name, **over)(params, jnp.asarray(toks),
                                             ref_fe)
    got = model(_t(toks), None if fe is None else _t(fe))
    assert got.logits.dtype == torch.float32
    assert got.logits.shape == logits.shape
    close(got.logits, logits)
    assert sorted(got.aux) == sorted(aux) == ["lb_loss", "z_loss"]
    for k in got.aux:
        _close(got.aux[k], aux[k], MODEL_TOL)

    ref_caches = ref_model.init_caches(2, 32)
    caches = model.init_caches(2, 32)
    stream = _tokens(ref_cfg, 2, steps, 15)
    for t in range(steps):
        pos = np.full((2, 1), t, np.int32)
        want, ref_caches = ref_decode(params, ref_caches,
                                      jnp.asarray(stream[:, t:t + 1]),
                                      jnp.asarray(pos))
        got, caches = trainer.make_decode_step(model)(
            caches, _t(stream[:, t:t + 1]), _t(pos))
        close(got, want)
    return ref_model, params, model, toks, fe


@pytest.mark.parametrize("name", ALL)
def test_forward_and_decode_match_the_reference(name):
    """Reduced widths, float32; 40 decode steps into caches of 32, so the
    window rings (16) and the global caches both wrap, and the recurrent
    states run 40 steps; the prefill step (llava's with its frontend
    embeddings)."""
    ref_model, params, model, toks, fe = _forward_and_decode(
        name, 40, lambda g, w: _close(g, w, MODEL_TOL))
    batch = {"tokens": toks} if fe is None else {"tokens": toks,
                                                 "frontend_embeds": fe}
    want = ref_trainer.make_prefill_step(ref_model)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    _close(trainer.make_prefill_step(model)(
        {k: _t(v) for k, v in batch.items()}), want, MODEL_TOL)


def _bf16_share(name, wants) -> float:
    """The share of each row's max |logit| that the port's bfloat16 run
    is held to: ``BF16_SHARE``, or for ``RECURRENT`` twice the largest
    share by which the reference's own bfloat16 logits ``wants`` (forward
    and 12 decode steps) differ from its float32 run on the same weights
    and inputs, where that is larger (RWKV and Mamba carry bfloat16
    rounding through their recurrences: at these widths the reference's
    own bfloat16 is further off its float32 than ``BF16_SHARE``)."""
    if name not in RECURRENT:
        return BF16_SHARE
    f32 = []
    _forward_and_decode(name, 12, lambda g, w: f32.append(
        np.asarray(w, dtype=np.float64)))
    noise = max((np.abs(np.asarray(a, dtype=np.float64) - b).max(-1)
                 / np.abs(b).max(-1)).max() for a, b in zip(wants, f32))
    return max(BF16_SHARE, 2 * noise)


@pytest.mark.parametrize("name", ALL)
def test_bfloat16_compute_matches_the_reference(name):
    """bfloat16 compute, 12 decode steps, at ``_bf16_share``: layer
    weights held as their bfloat16 cast, the ``KEEP_F32`` leaves as
    stored (float32), the embedding(s), projector and head in the param
    dtype."""
    pairs = []
    model = _forward_and_decode(name, 12, lambda g, w: pairs.append((g, w)),
                                compute_dtype="bfloat16")[2]
    share = _bf16_share(name, [w for _, w in pairs])
    for got, want in pairs:
        _close_to_row_max(got, want, share)
    for layer in model.layers:
        for n, w in layer.mixer.items():
            want = torch.float32 if n in transformer.KEEP_F32 \
                or n in transformer.NORM_SCALES else torch.bfloat16
            assert w.dtype == want, n
    assert model.embed.dtype == model.final_norm["scale"].dtype \
        == torch.float32
    if model.frontend_proj is not None:
        assert model.frontend_proj.dtype == torch.float32


def test_untied_head_and_padded_vocab_match_the_reference():
    model = _forward_and_decode(
        "starcoder2-7b", 4, lambda g, w: _close(g, w, MODEL_TOL),
        tie_embeddings=False, vocab=500)[2]
    assert model.lm_head.shape == (128, 512)
    logits = model(torch.zeros((1, 2), dtype=torch.int32)).logits
    assert bool((logits[..., 500:] == -1e9).all())


# ---- the serving engine -----------------------------------------------------

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


def _serve_both(name, prompts, max_new, batch, cache_len, seeds=None):
    """Both engines over requests of these prompt lengths (prompt ``i``
    drawn from seed ``seeds[i]``, default ``20 + i``): each one's calls,
    generated tokens and token count."""
    ref_cfg, _, params, ref_decode, model = _pair(name)
    seeds = seeds or [20 + i for i in range(len(prompts))]
    out = []
    for ref in (True, False):
        reqs = [(ref_serve if ref else serve).Request(
            rid=i, prompt=_tokens(ref_cfg, 1, n, s)[0], max_new=m)
            for i, (n, m, s) in enumerate(zip(prompts, max_new, seeds))]
        engine = (ref_serve.ServeEngine(ref_cfg, params, batch, cache_len)
                  if ref else serve.ServeEngine(model, batch, cache_len,
                                                device="cpu"))
        if ref:     # one compiled step for every engine of this model
            engine.decode = ref_decode
        calls = []
        _recorded(engine, calls)
        stats = engine.run(reqs)
        out.append((calls, [r.generated for r in reqs], stats["tokens"]))
    return out


@pytest.mark.parametrize("name", SERVED)
def test_serve_engine_matches_the_reference_call_for_call(name):
    """Batch 2, five requests of mixed prompt lengths: slots refill (a
    recurrent slot carrying the previous request's state)."""
    (ref_calls, ref_gen, ref_n), (calls, gen, n) = _serve_both(
        name, prompts=(7, 3, 12, 5, 9), max_new=(4, 6, 3, 5, 2), batch=2,
        cache_len=32)
    assert len(calls) == len(ref_calls) > 40
    for (t, p, logits), (rt, rp, want) in zip(calls, ref_calls):
        assert np.array_equal(t, rt) and np.array_equal(p, rp)
        np.testing.assert_allclose(logits, want, **MODEL_TOL)
    assert gen == ref_gen and n == ref_n == 20


def test_refilled_slot_reads_stale_cache_like_the_reference():
    """One slot: a 20-token prompt, then a 5-token one in the same cache.
    The second request's first decode (call 20 + 1 + 5) attends to the
    first request's entries at positions 5..20, as the reference does; a
    fresh engine's (call 5) does not."""
    (ref_calls, _, _), (calls, _, _) = _serve_both(
        "starcoder2-7b", prompts=(20, 5), max_new=(1, 2), batch=1,
        cache_len=32)
    (_, _, _), (fresh, _, _) = _serve_both(
        "starcoder2-7b", prompts=(5,), max_new=(2,), batch=1, cache_len=32)
    stale = calls[26][2]
    np.testing.assert_allclose(stale, ref_calls[26][2], **MODEL_TOL)
    assert calls[26][1][0, 0] == fresh[5][1][0, 0] == 5
    assert np.abs(stale - fresh[5][2]).max() > 1.0
    # the first decode of a request feeds the slot's previous token: 0 in
    # a fresh engine, the first request's generated token after a refill
    assert fresh[5][0][0, 0] == 0
    assert calls[26][0][0, 0] == int(np.argmax(calls[20][2][0, 0]))


@pytest.mark.parametrize("name", RECURRENT + ("minicpm3-4b",))
def test_refilled_slot_carries_state_like_the_reference(name):
    """One slot: a 20-token prompt, then a 5-token one.  Nothing resets a
    recurrent state, so the second request starts from the first one's
    RWKV/Mamba state (the reference does the same): every call of its
    prompt differs from a fresh engine's on the same prompt.  MLA masks
    cache entries past the step's own position, so minicpm3's refilled
    slot reads only its own entries and equals the fresh engine."""
    (ref_calls, _, _), (calls, _, _) = _serve_both(
        name, prompts=(20, 5), max_new=(1, 2), batch=1, cache_len=32)
    (_, _, _), (fresh, _, _) = _serve_both(
        name, prompts=(5,), max_new=(2,), batch=1, cache_len=32, seeds=(21,))
    assert len(calls) == len(ref_calls) == 28
    for (t, p, logits), (rt, rp, want) in zip(calls, ref_calls):
        assert np.array_equal(t, rt) and np.array_equal(p, rp)
        np.testing.assert_allclose(logits, want, **MODEL_TOL)
    refilled = [c[2] for c in calls[21:26]]       # its prompt, positions 0-4
    gaps = [np.abs(a - b[2]).max() for a, b in zip(refilled, fresh[:5])]
    if name in RECURRENT:
        assert min(gaps) > 1e-2, gaps
    else:
        assert max(gaps) < 1e-3, gaps


def test_serve_engine_refuses_codebooks_before_any_step():
    """musicgen's (B, 1, K) tokens: the reference's engine feeds (B, 1)
    and fails in ``decode_attention``; the port's refuses at once."""
    ref_cfg, _, params, _, model = _pair("musicgen-large")
    reqs = [ref_serve.Request(rid=0, prompt=_tokens(ref_cfg, 1, 3, 1)[0, :,
                                                                        0],
                              max_new=2)]
    with pytest.raises(TypeError, match="cannot reshape"):
        ref_serve.ServeEngine(ref_cfg, params, 2, 16).run(reqs)
    with pytest.raises(ValueError, match="num_codebooks = 4"):
        serve.ServeEngine(model, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="decode_attention"):
        serve.main(["--arch", "musicgen-large", "--reduced", "--device",
                    "cpu"])


# ---- no quiet fallback to the CPU --------------------------------------------

def test_no_gpu_raises_rp110(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("gemma3-4b").reduced()
    model = transformer.build(cfg, device="cpu")
    for call in (lambda: serve.ServeEngine(model, 2, 16),
                 lambda: transformer.build(cfg),
                 lambda: transformer.LMModel(cfg),
                 lambda: serve.main(["--arch", "gemma3-4b", "--reduced"])):
        with pytest.raises(DiagnosticError, match="RP110"):
            call()


def test_main_serves_on_the_cpu_when_asked(capsys):
    stats = serve.main(["--arch", "gemma3-4b", "--reduced", "--device",
                        "cpu", "--requests", "3", "--batch", "2",
                        "--prompt-len", "4", "--gen-len", "3",
                        "--cache-len", "16", "--seed", "3"])
    assert stats["tokens"] == 9
    assert "device=cpu" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["rwkv6-7b", "jamba-v0.1-52b",
                                  "minicpm3-4b"])
def test_main_serves_every_family_on_the_cpu(capsys, name):
    stats = serve.main(["--arch", name, "--reduced", "--device", "cpu",
                        "--requests", "3", "--batch", "2", "--prompt-len",
                        "4", "--gen-len", "3", "--cache-len", "16"])
    assert stats["tokens"] == 9
    assert f"arch={name} device=cpu" in capsys.readouterr().out
