"""The port's MLA, MoE, Mamba and RWKV modules against the JAX package,
on the CPU, module by module.

The same inputs and weights, drawn with numpy, go through the reference
function (``repro``, ``JAX_PLATFORMS=cpu``) and its port
(``repro_torch``, CPU tensors), in float32 at atol = rtol = 1e-5
(``MODULE_TOL``).  The whole models, the prefill and decode steps and
the serving engine of these families are held to the reference in
``tests/test_torch_lm.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AttnCfg as RefAttnCfg
from repro.configs.base import MambaCfg as RefMambaCfg
from repro.configs.base import MoECfg as RefMoECfg
from repro.configs.base import RwkvCfg as RefRwkvCfg
from repro.models import attention as ref_attention
from repro.models import common as ref_common
from repro.models import mamba as ref_mamba
from repro.models import moe as ref_moe
from repro.models import rwkv as ref_rwkv

from repro_torch.configs.base import AttnCfg, MambaCfg, MoECfg, RwkvCfg
from repro_torch.models import attention, common, mamba, moe, rwkv

MODULE_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Intra-op threads: one.  These CPU tensors are small, and the test
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=MODULE_TOL):
    np.testing.assert_allclose(got.double().numpy(),
                               np.asarray(want, dtype=np.float64), **tol)


def _both(p):
    """A numpy params dict as the reference's and the port's."""
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: _t(v) for k, v in p.items()})


def _normal(r, shape, scale):
    return (r.standard_normal(shape) * scale).astype(np.float32)


# ---- MLA -------------------------------------------------------------------

MLA = dict(n_heads=4, n_kv_heads=4, head_dim=32, kind="mla", q_lora=64,
           kv_lora=32, rope_dim=16, nope_dim=16, v_dim=32)


def _mla_params(seed, d=64):
    r = _rng(seed)
    H, qk = MLA["n_heads"], MLA["nope_dim"] + MLA["rope_dim"]
    shapes = {"wq_a": (d, 64), "wq_b": (64, H * qk), "wkv_a": (d, 32 + 16),
              "wk_b": (32, H * 16), "wv_b": (32, H * 32), "wo": (H * 32, d)}
    p = {n: _normal(r, s, 1 / math.sqrt(s[0])) for n, s in shapes.items()}
    p["q_norm"] = _normal(r, (64,), 0.1)
    p["kv_norm"] = _normal(r, (32,), 0.1)
    return p


def _mla_made(cfg, tp, positions, cache=None):
    made = dict(positions=positions, cache=cache,
                rope=common.rope_tables(positions, cfg.rope_dim,
                                        cfg.rope_theta),
                norm_weights=(1.0 + tp["q_norm"], 1.0 + tp["kv_norm"]))
    if cache is not None:
        made["ring"] = attention.RingStep(
            *attention.write_positions(cache.pos, positions),
            attention.mla_decode_bias(cache.pos, positions))
    return made


def test_mla_forward_and_absorbed_decode_match_the_reference():
    """The materialised prefill over 16 tokens (chunk 8), then 20 absorbed
    decode steps into a cache of 16 (the ring wraps) and the cache."""
    cfg, ref_cfg = AttnCfg(**MLA), RefAttnCfg(**MLA)
    jp, tp = _both(_mla_params(1))
    r = _rng(2)
    x = _normal(r, (2, 16, 64), 1.0)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()
    want, _ = ref_attention.apply_mla(jp, jnp.asarray(x), ref_cfg,
                                      positions=jnp.asarray(pos), chunk=8)
    got, _ = attention.apply_mla(tp, _t(x), cfg, chunk=8,
                                 **_mla_made(cfg, tp, _t(pos)))
    _close(got, want)

    ref_cache = ref_attention.init_cache(ref_cfg, 2, 16, None, jnp.float32)
    cache = attention.init_cache(cfg, 2, 16, None, torch.float32)
    assert isinstance(cache, attention.MLACache)
    assert cache.c_kv.shape == ref_cache.c_kv.shape == (2, 16, 32)
    step = jax.jit(lambda x, p, c: ref_attention.apply_mla(
        jp, x, ref_cfg, positions=p, cache=c))
    xs = _normal(r, (20, 2, 1, 64), 1.0)
    for t in range(20):
        p = np.full((2, 1), t, np.int32)
        want, ref_cache = step(jnp.asarray(xs[t]), jnp.asarray(p), ref_cache)
        got, cache = attention.apply_mla(tp, _t(xs[t]), cfg,
                                         **_mla_made(cfg, tp, _t(p), cache))
        _close(got, want)
    for name in ("c_kv", "k_rope"):
        _close(getattr(cache, name), getattr(ref_cache, name))
    assert np.array_equal(cache.pos.numpy(), np.asarray(ref_cache.pos))


def test_mla_decode_equals_its_prefill_in_the_port():
    cfg = AttnCfg(**MLA)
    tp = {k: _t(v) for k, v in _mla_params(3).items()}
    x = _t(_normal(_rng(4), (2, 24, 64), 1.0))
    pos = torch.arange(24, dtype=torch.int32).expand(2, 24)
    full, _ = attention.apply_mla(tp, x, cfg, chunk=8,
                                  **_mla_made(cfg, tp, pos))
    cache = attention.init_cache(cfg, 2, 32, None, torch.float32)
    for t in range(24):
        got, cache = attention.apply_mla(
            tp, x[:, t:t + 1], cfg, **_mla_made(cfg, tp, pos[:, t:t + 1],
                                                cache))
        torch.testing.assert_close(got[:, 0], full[:, t], **MODULE_TOL)


def test_mla_decode_masks_entries_past_the_step_like_the_reference():
    """A cache holding entries at positions 0..11 decoded at position 4:
    the reference's MLA masks entries past ``positions`` (GQA would read
    up to ``max(pos)``), and so does the port."""
    cfg, ref_cfg = AttnCfg(**MLA), RefAttnCfg(**MLA)
    jp, tp = _both(_mla_params(5))
    r = _rng(6)
    c_kv, k_rope = _normal(r, (2, 16, 32), 1.0), _normal(r, (2, 16, 16), 1.0)
    cpos = np.full((2, 16), -1, np.int32)
    cpos[:, :12] = np.arange(12)
    x, p = _normal(r, (2, 1, 64), 1.0), np.full((2, 1), 4, np.int32)
    ref_cache = ref_attention.MLACache(*map(jnp.asarray, (c_kv, k_rope,
                                                          cpos)))
    want, _ = ref_attention.apply_mla(jp, jnp.asarray(x), ref_cfg,
                                      positions=jnp.asarray(p),
                                      cache=ref_cache)
    cache = attention.MLACache(_t(c_kv), _t(k_rope), _t(cpos))
    got, _ = attention.apply_mla(tp, _t(x), cfg,
                                 **_mla_made(cfg, tp, _t(p), cache))
    _close(got, want)
    bias = attention.mla_decode_bias(cache.pos, _t(p))
    assert bool((bias[:, :5] == 0).all()) and bool((bias[:, 5:] < 0).all())


# ---- MoE -------------------------------------------------------------------

def _moe_cfgs(**kw):
    fields = dict(num_experts=4, top_k=2, d_ff=32, capacity_factor=1.25)
    fields.update(kw)
    return MoECfg(**fields), RefMoECfg(**fields)


@pytest.mark.parametrize("seq,kw", [(1, {}), (24, {}), (24, dict(
    capacity_factor=0.25)), (512, dict(num_experts=40, top_k=8,
                                       capacity_factor=1.25))])
def test_capacity_equals_the_reference(seq, kw):
    cfg, ref_cfg = _moe_cfgs(**kw)
    assert moe.capacity(cfg, seq) == ref_moe.capacity(ref_cfg, seq)


def _route_both(x, logits, cap, **kw):
    """The port's and the reference's routing: expert, slot and keep
    equal, weight and probs at ``MODULE_TOL``."""
    cfg, ref_cfg = _moe_cfgs(**kw)
    want = ref_moe._route_one(jnp.asarray(x), jnp.asarray(logits), ref_cfg,
                              cap)
    got = moe._route_one(_t(x), _t(logits), cfg, cap)
    for i, (g, w) in enumerate(zip(got, want)):
        if i in (2, 4):
            _close(g, w)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return got


def test_route_one_breaks_ties_as_jax_top_k_does():
    """Planted ties: every token's logits hold equal values at several
    experts (the lower index must come first, as ``jax.lax.top_k`` puts
    it), in float32 and in the bfloat16 a router gives."""
    r = _rng(7)
    S, E = 16, 8
    logits = np.round(r.standard_normal((S, E)) * 2) / 2   # many ties
    logits[0] = 1.0                                          # all tie
    logits[1, [2, 5, 6]] = 3.0
    x = _normal(r, (S, 8), 1.0)
    for dtype in (np.float32, jnp.bfloat16):
        lg = np.asarray(jnp.asarray(logits, dtype).astype(jnp.float32))
        got = _route_both(x, lg, cap=8, num_experts=E, top_k=3)
    assert got[0][0].tolist() == [0, 1, 2]
    assert got[0][1].tolist() == [2, 5, 6]


def test_route_one_drops_tokens_past_capacity_like_the_reference():
    """Every token prefers expert 1: the choices past ``cap`` are
    dropped (``keep`` false, their slot >= cap), the earlier tokens
    kept."""
    r = _rng(8)
    S, E = 20, 4
    logits = _normal(r, (S, E), 0.3)
    logits[:, 1] += 4.0
    x = _normal(r, (S, 8), 1.0)
    got = _route_both(x, logits, cap=8)
    expert_idx, slot, _, keep, _ = got
    assert not bool(keep[8:, 0].any()) and bool(keep[:8, 0].all())
    assert bool((slot[~keep] >= 8).all())


def _moe_params(mlp_kind, E, d, F, seed):
    r = _rng(seed)
    names = ("wi_gate", "wi_up") if mlp_kind == "swiglu" else ("wi",)
    p = {n: _normal(r, (E, d, F), 1 / math.sqrt(d)) for n in names}
    p["wo"] = _normal(r, (E, F, d), 1 / math.sqrt(F))
    p["router"] = _normal(r, (d, E), 1 / math.sqrt(d))
    return p


@pytest.mark.parametrize("mlp_kind,act", [("swiglu", "silu"),
                                          ("swiglu", "gelu"),
                                          ("gelu_mlp", "gelu")])
@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
def test_apply_moe_and_its_aux_match_the_reference(mlp_kind, act, cf):
    """Batch 3 of 24 tokens, 4 experts top-2; at capacity factor 0.5
    tokens are dropped, at 4.0 none."""
    cfg, ref_cfg = _moe_cfgs(capacity_factor=cf)
    jp, tp = _both(_moe_params(mlp_kind, 4, 16, 32, 9))
    x = _normal(_rng(10), (3, 24, 16), 1.0)
    want, want_aux = ref_moe.apply_moe(jp, jnp.asarray(x), ref_cfg,
                                       mlp_kind, act)
    got, aux = moe.apply_moe(tp, _t(x), cfg, mlp_kind, act)
    _close(got, want)
    assert sorted(aux) == sorted(want_aux)
    for k in aux:
        _close(aux[k], want_aux[k])
    if cf != 1.25:
        assert (float(aux["dropped_frac"]) > 0) == (cf < 1.0)


# ---- Mamba -----------------------------------------------------------------

MAMBA = dict(d_inner=32, d_state=8, d_conv=4, dt_rank=16, chunk=8)


def _mamba_params(seed, d=16):
    r = _rng(seed)
    di, ds, K, rank = 32, 8, 4, 16
    p = {"in_proj": _normal(r, (d, 2 * di), 1 / math.sqrt(d)),
         "conv_w": _normal(r, (K, di), 0.5),
         "conv_b": _normal(r, (di,), 0.1),
         "x_proj": _normal(r, (di, rank + 2 * ds), 1 / math.sqrt(di)),
         "dt_proj": _normal(r, (rank, di), 1 / math.sqrt(rank)),
         "dt_bias": np.log(np.expm1(r.uniform(1e-3, 1e-1, di))).astype(
             np.float32),
         "a_log": (np.log(np.arange(1, ds + 1))[None] + _normal(
             r, (di, ds), 0.1)).astype(np.float32),
         "d": (1 + _normal(r, (di,), 0.1)).astype(np.float32),
         "out_proj": _normal(r, (di, d), 1 / math.sqrt(di))}
    return p


@pytest.mark.parametrize("with_prev", [False, True])
def test_conv_causal_matches_the_reference(with_prev):
    r = _rng(11)
    x, w, b = (_normal(r, s, 1.0) for s in ((2, 9, 32), (4, 32), (32,)))
    prev = _normal(r, (2, 3, 32), 1.0) if with_prev else None
    want = ref_mamba._conv_causal(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b),
                                  None if prev is None else jnp.asarray(prev))
    got = mamba._conv_causal(_t(x), _t(w), _t(b),
                             None if prev is None else _t(prev))
    for g, w_ in zip(got, want):
        _close(g, w_)


def test_ssm_scan_matches_the_reference():
    r = _rng(12)
    B, S, di, ds = 2, 24, 32, 8
    dt = np.abs(_normal(r, (B, S, di), 0.1))
    bt, ct, xin = (_normal(r, s, 1.0) for s in ((B, S, ds), (B, S, ds),
                                                (B, S, di)))
    p = _mamba_params(13)
    h0 = _normal(r, (B, di, ds), 1.0)
    args = (dt, bt, ct, xin, p["a_log"], p["d"], h0)
    want = ref_mamba._ssm_scan(*map(jnp.asarray, args), chunk=8)
    got = mamba._ssm_scan(*map(_t, args), chunk=8)
    for g, w in zip(got, want):
        _close(g, w)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        mamba._ssm_scan(*map(_t, args), chunk=7)


def test_softplus_is_jax_softplus_beyond_twenty():
    x = np.linspace(-40, 60, 201).astype(np.float32)
    _close(mamba.softplus(_t(x)), jax.nn.softplus(jnp.asarray(x)),
           dict(atol=0, rtol=2.5e-7))
    # above 20 F.softplus returns x itself; logaddexp does not
    big = torch.tensor([25.0, 30.0], dtype=torch.float64)
    np.testing.assert_array_equal(mamba.softplus(big).numpy(),
                                  np.logaddexp(big.numpy(), 0.0))
    assert bool((mamba.softplus(big) > big).all())


def test_mamba_prompt_and_steps_match_the_reference():
    """A 16-token prompt (chunk 8), then 12 single-token steps carrying
    the (ssm, conv) state, written in place."""
    cfg, ref_cfg = MambaCfg(**MAMBA), RefMambaCfg(**MAMBA)
    jp, tp = _both(_mamba_params(14))
    r = _rng(15)
    x = _normal(r, (2, 16, 16), 1.0)
    want, _ = ref_mamba.apply_mamba(jp, jnp.asarray(x), ref_cfg)
    got, none = mamba.apply_mamba(tp, _t(x), cfg)
    _close(got, want)
    assert none is None
    ref_state = ref_mamba.init_state(ref_cfg, 2, jnp.float32)
    state = mamba.init_state(cfg, 2, torch.float32)
    step = jax.jit(lambda x, s: ref_mamba.apply_mamba(jp, x, ref_cfg,
                                                      state=s))
    for t in range(12):
        xt = _normal(r, (2, 1, 16), 1.0)
        want, ref_state = step(jnp.asarray(xt), ref_state)
        got, same = mamba.apply_mamba(tp, _t(xt), cfg, state=state)
        assert same is state
        _close(got, want)
    _close(state.ssm, ref_state.ssm)
    _close(state.conv, ref_state.conv)


def test_mamba_steps_equal_its_prompt_in_the_port():
    cfg = MambaCfg(**MAMBA)
    tp = {k: _t(v) for k, v in _mamba_params(16).items()}
    x = _t(_normal(_rng(17), (2, 16, 16), 1.0))
    full, _ = mamba.apply_mamba(tp, x, cfg)
    state = mamba.init_state(cfg, 2, torch.float32)
    for t in range(16):
        got, _ = mamba.apply_mamba(tp, x[:, t:t + 1], cfg, state=state)
        torch.testing.assert_close(got[:, 0], full[:, t], **MODULE_TOL)


# ---- RWKV ------------------------------------------------------------------

RWKV = dict(head_dim=8, decay_lora=16, mix_lora=8, chunk=8)


def _wkv_inputs(seed, B=2, S=24, H=4, hd=8):
    r = _rng(seed)
    rr, k, v = (_normal(r, (B, S, H, hd), 1.0) for _ in range(3))
    w = np.exp(-np.exp(_normal(r, (B, S, H, hd), 0.5) - 0.6)).astype(
        np.float32)
    u = _normal(r, (H, hd), 0.3)
    h0 = _normal(r, (B, H, hd, hd), 1.0)
    return rr, k, v, w, u, h0


@pytest.mark.parametrize("impl", ["_wkv_scan", "_wkv_chunked"])
def test_wkv_matches_the_reference(impl):
    args = _wkv_inputs(18)
    want = getattr(ref_rwkv, impl)(*map(jnp.asarray, args), chunk=8)
    got = getattr(rwkv, impl)(*map(_t, args), chunk=8)
    for g, w in zip(got, want):
        _close(g, w, dict(atol=1e-4, rtol=1e-5))


def test_wkv_chunked_equals_the_scan_in_the_port():
    args = list(map(_t, _wkv_inputs(19)))
    for g, w in zip(rwkv._wkv_chunked(*args, chunk=8),
                    rwkv._wkv_scan(*args, chunk=24)):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-5)


def test_group_norm_and_token_shift_match_the_reference():
    r = _rng(20)
    x = (_normal(r, (2, 5, 32), 2.0) + 0.5).astype(np.float32)
    scale, bias = 1 + _normal(r, (32,), 0.1), _normal(r, (32,), 0.1)
    _close(rwkv._group_norm(_t(x), _t(scale), _t(bias), 4),
           ref_rwkv._group_norm(jnp.asarray(x), jnp.asarray(scale),
                                jnp.asarray(bias), 4))
    prev = _normal(r, (2, 32), 1.0)
    _close(rwkv._token_shift(_t(x), _t(prev)),
           ref_rwkv._token_shift(jnp.asarray(x), jnp.asarray(prev)))


def _rwkv_params(seed, d=32, d_ff=64):
    r = _rng(seed)
    H, hd, rr = d // 8, 8, 8
    tm = {"mu_x": _normal(r, (d,), 0.3), "mix_w1": _normal(
        r, (d, 5 * rr), 1 / math.sqrt(d)),
        "mix_w2": _normal(r, (5, rr, d), 0.3), "mu": _normal(r, (5, d), 0.3),
        "w0": (_normal(r, (d,), 0.3) - 0.6).astype(np.float32),
        "w_lora1": _normal(r, (d, 16), 1 / math.sqrt(d)),
        "w_lora2": _normal(r, (16, d), 0.1), "u": _normal(r, (H, hd), 0.3),
        "ln_scale": 1 + _normal(r, (d,), 0.1),
        "ln_bias": _normal(r, (d,), 0.1)}
    for n in ("wr", "wk", "wv", "wg", "wo"):
        tm[n] = _normal(r, (d, d), 1 / math.sqrt(d))
    cm = {"mu_k": _normal(r, (d,), 0.3), "mu_r": _normal(r, (d,), 0.3),
          "wk": _normal(r, (d, d_ff), 1 / math.sqrt(d)),
          "wv": _normal(r, (d_ff, d), 1 / math.sqrt(d_ff)),
          "wr": _normal(r, (d, d), 1 / math.sqrt(d))}
    return tm, cm


@pytest.mark.parametrize("impl", ["chunked", "scan"])
def test_rwkv_prompt_and_steps_match_the_reference(impl):
    """Time mix and channel mix over a 16-token prompt (chunk 8), then 12
    single-token steps: the channel mix reads the state's old
    ``shift_cm``, as the reference's layer does."""
    cfg = RwkvCfg(**RWKV, impl=impl)
    ref_cfg = RefRwkvCfg(**RWKV, impl=impl)
    (jtm, ttm), (jcm, tcm) = map(_both, _rwkv_params(21))
    r = _rng(22)
    x = _normal(r, (2, 16, 32), 1.0)
    want, _ = ref_rwkv.apply_time_mix(jtm, jnp.asarray(x), ref_cfg)
    got, _ = rwkv.apply_time_mix(ttm, _t(x), cfg)
    _close(got, want, dict(atol=1e-4, rtol=1e-5))
    want, _ = ref_rwkv.apply_channel_mix(jcm, jnp.asarray(x))
    _close(rwkv.apply_channel_mix(tcm, _t(x))[0], want)

    def ref_layer(x, s):
        out, new = ref_rwkv.apply_time_mix(jtm, x, ref_cfg, state=s)
        out2, cm = ref_rwkv.apply_channel_mix(jcm, x, state=s)
        return out, out2, new._replace(shift_cm=cm.shift_cm)

    ref_layer = jax.jit(ref_layer)
    ref_state = ref_rwkv.init_state(ref_cfg, 32, 2, jnp.float32)
    state = rwkv.init_state(cfg, 32, 2, torch.float32)
    for t in range(12):
        xt = _normal(r, (2, 1, 32), 1.0)
        w1, w2, ref_state = ref_layer(jnp.asarray(xt), ref_state)
        g1, same = rwkv.apply_time_mix(ttm, _t(xt), cfg, state=state)
        g2, _ = rwkv.apply_channel_mix(tcm, _t(xt), state=state)
        assert same is state
        _close(g1, w1, dict(atol=1e-4, rtol=1e-5))
        _close(g2, w2)
    for name in ("wkv", "shift_tm", "shift_cm"):
        _close(getattr(state, name), getattr(ref_state, name))


def test_rwkv_steps_equal_its_prompt_in_the_port():
    cfg = RwkvCfg(**RWKV)
    ttm = {k: _t(v) for k, v in _rwkv_params(23)[0].items()}
    x = _t(_normal(_rng(24), (2, 16, 32), 1.0))
    full, _ = rwkv.apply_time_mix(ttm, x, cfg)
    state = rwkv.init_state(cfg, 32, 2, torch.float32)
    for t in range(16):
        got, _ = rwkv.apply_time_mix(ttm, x[:, t:t + 1], cfg, state=state)
        torch.testing.assert_close(got[:, 0], full[:, t], atol=1e-4,
                                   rtol=1e-5)


# ---- initialisers ----------------------------------------------------------

def _ref_init(fn, *args):
    tree = fn(jax.random.PRNGKey(0), *args)
    return {k: np.asarray(v.value) for k, v in tree.items()}


def _same_distribution(got: torch.Tensor, want: np.ndarray):
    """Shape, dtype, magnitude and the first two moments (or the values, for
    a constant leaf)."""
    g = got.double().numpy()
    assert g.shape == want.shape
    if np.all(want == want.flat[0]):
        np.testing.assert_array_equal(g, want.astype(np.float64))
        return
    assert np.abs(g).max() <= 1.25 * np.abs(want).max()
    assert abs(g.std() - want.std()) < 0.05 * want.std()
    assert abs(g.mean() - want.mean()) < 0.05 * want.std() + 1e-3


@pytest.mark.parametrize("family", ["mla", "moe", "mamba", "rwkv_tm",
                                    "rwkv_cm"])
def test_initialisers_draw_the_reference_distributions(family):
    """Every leaf of the new families: the reference's shape, dtype and
    distribution (constant leaves exactly: ``a_log``, ``d``, ``w0``,
    ``u``, ``ln_scale``, ``ln_bias``, the zero scales and mixes)."""
    gen = torch.Generator().manual_seed(0)
    d = 256
    if family == "mla":
        cfg = dict(MLA, q_lora=256, kv_lora=128, nope_dim=32, rope_dim=32,
                   v_dim=32)
        got = attention.init_attention(gen, d, AttnCfg(**cfg), torch.float32)
        want = _ref_init(ref_attention.init_attention, d, RefAttnCfg(**cfg),
                         jnp.float32)
    elif family == "moe":
        cfg = dict(num_experts=8, top_k=2, d_ff=128)
        got = moe.init_moe(gen, d, MoECfg(**cfg), torch.float32, "swiglu")
        want = _ref_init(ref_moe.init_moe, d, RefMoECfg(**cfg), jnp.float32,
                         "swiglu")
    elif family == "mamba":
        cfg = dict(d_inner=512, d_state=16, dt_rank=0)
        got = mamba.init_mamba(gen, d, MambaCfg(**cfg), torch.bfloat16)
        want = _ref_init(ref_mamba.init_mamba, d, RefMambaCfg(**cfg),
                         jnp.bfloat16)
    elif family == "rwkv_tm":
        got = rwkv.init_time_mix(gen, d, RwkvCfg(), torch.bfloat16)
        want = _ref_init(ref_rwkv.init_time_mix, d, RefRwkvCfg(),
                         jnp.bfloat16)
    else:
        got = rwkv.init_channel_mix(gen, d, 512, torch.float32)
        want = _ref_init(ref_rwkv.init_channel_mix, d, 512, jnp.float32)
    assert list(got) == list(want)
    for name in got:
        assert str(got[name].dtype).split(".")[-1] == want[name].dtype.name, \
            name
        _same_distribution(got[name], want[name].astype(np.float64))
    if family == "mamba":
        # the log-uniform dt: softplus(dt_bias) in [1e-3, 1e-1]
        dt = torch.nn.functional.softplus(got["dt_bias"].float())
        assert float(dt.min()) >= 1e-3 * 0.99 and float(dt.max()) <= 0.101
        assert mamba.dt_rank(MambaCfg(**cfg), d) == \
            got["dt_proj"].shape[0] == 16


def test_zeros_param_equals_the_reference():
    got = common.zeros_param((3, 5), torch.float32)
    want = ref_common.zeros_param((3, 5), (None, None), jnp.float32).value
    assert np.array_equal(got.numpy(), np.asarray(want))
