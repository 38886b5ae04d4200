"""Model code of the PyTorch port against the JAX package, on the CPU.

Inputs are drawn with numpy from a seed and handed to both sides; the JAX
model's weights reach the port through ``repro_torch.convert``. fp32
throughout, tolerance 3e-4 for the model (the port's attention keeps fp32
probabilities where the reference's jnp path casts them to ``v.dtype``,
which in fp32 changes nothing but the order of rounding).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

from repro.configs import get_config as jget_config
from repro.models import common as jc
from repro.models import transformer as jt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import common as tc
from repro_torch.models import transformer as tt

TOL = 3e-4


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               torch.as_tensor(b).float().numpy(),
                               atol=tol, rtol=tol)


T = torch.from_numpy


def test_config_copy_matches_reference():
    for reduce in (False, True):
        a, b = jget_config("yi-6b"), get_config("yi-6b")
        if reduce:
            a, b = a.reduced(num_layers=2, d_model=128), b.reduced(num_layers=2, d_model=128)
        for f in dataclasses.fields(b):
            assert getattr(a, f.name) == getattr(b, f.name), f.name
        assert (a.padded_vocab, a.kv_bytes_per_token) == \
            (b.padded_vocab, b.kv_bytes_per_token)
    assert get_config("yi-6b").kv_bytes_per_token == 65536


def test_rmsnorm_matches():
    x, s = _rand(0, (2, 5, 48), (48,))
    _close(jc.rmsnorm({"scale": s}, x, 1e-5), tc.rmsnorm({"scale": T(s)}, T(x), 1e-5), 1e-6)


@pytest.mark.parametrize("hd", [16, 7])
def test_apply_rope_matches(hd):
    (x,) = _rand(1, (2, 9, 3, hd))
    pos = np.arange(40, 49)
    _close(jc.apply_rope(x, jnp.asarray(pos), 10_000.0),
           tc.apply_rope(T(x), T(pos), 10_000.0), 2e-5)


@pytest.mark.parametrize("activation,gated", [("silu", True), ("gelu", False),
                                              ("relu2", True)])
def test_mlp_matches(activation, gated):
    cfg = dataclasses.replace(get_config("yi-6b").reduced(d_model=32),
                              activation=activation, gated_mlp=gated)
    x, wu, wd, wg = _rand(2, (2, 3, 32), (32, 64), (64, 32), (32, 64))
    p = {"w_up": wu, "w_down": wd}
    if gated:
        p["w_gate"] = wg
    _close(jc.mlp(p, x, cfg), tc.mlp({k: T(v) for k, v in p.items()}, T(x), cfg), 1e-5)


@pytest.mark.parametrize("Sq,Sk,off,win", [(16, 16, 0, None), (9, 29, 20, None),
                                           (12, 40, 28, 8)])
def test_attention_matches(Sq, Sk, off, win):
    q, k, v = _rand(3, (1, Sq, 4, 16), (1, Sk, 2, 16), (1, Sk, 2, 16))
    _close(jc.attention(q, k, v, q_offset=off, window=win),
           tc.attention(T(q), T(k), T(v), q_offset=off, window=win), 2e-5)


@pytest.mark.parametrize("pos,win", [(5, None), (30, None), (30, 6)])
def test_decode_attend_matches_on_ring(pos, win):
    W = 16
    q, kc, vc = _rand(4, (2, 1, 4, 8), (2, W, 2, 8), (2, W, 2, 8))
    jk = jt.ring_kpos(W, jnp.asarray(pos))
    tk = tt.ring_kpos(W, pos)
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    _close(jc.decode_attend(q, kc, vc, jk, jnp.asarray(pos), window=win),
           tc.decode_attend(T(q), T(kc), T(vc), tk, pos, window=win), 2e-5)


@pytest.mark.parametrize("S,W", [(5, 8), (8, 8), (21, 8)])
def test_place_kv_in_ring_matches(S, W):
    (k,) = _rand(5, (2, S, 2, 4))
    np.testing.assert_array_equal(np.asarray(jt._place_kv_in_ring(k, W)),
                                  tt._place_kv_in_ring(T(k), W).numpy())


# --------------------------------------------------------------------------- #
# whole model, reduced yi-6b with converted weights
# --------------------------------------------------------------------------- #

def _models(window=None, seed=0):
    jcfg = jget_config("yi-6b").reduced(num_layers=2, d_model=128)
    tcfg = get_config("yi-6b").reduced(num_layers=2, d_model=128)
    if window:
        jcfg = dataclasses.replace(jcfg, window_size=window)
        tcfg = dataclasses.replace(tcfg, window_size=window)
    jp = jt.init_params(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu", torch.float32)
    return jcfg, jp, tcfg, tp


def _tokens(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, n)).astype(np.int32)


@pytest.mark.parametrize("window", [None, 16])
def test_prefill_and_decode_match(window):
    jcfg, jp, tcfg, tp = _models(window)
    toks = _tokens(jcfg, 24)
    tt_toks = T(toks).long()
    # cold prefill
    jl, jcache = jt.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=64)
    tl, tcache = tt.prefill(tp, tcfg, {"tokens": tt_toks}, max_len=64)
    _close(jl, tl)
    _close(jcache["k"], tcache["k"])
    _close(jcache["v"], tcache["v"])
    # prefix prefill: 16 cached tokens, 8-token suffix
    _, jpre = jt.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :16])}, max_len=64)
    _, tpre = tt.prefill(tp, tcfg, {"tokens": tt_toks[:, :16]}, max_len=64)
    jl2, jc2 = jt.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, 16:])}, max_len=64,
                          prefix_cache=jpre, prefix_len=16)
    tl2, tc2 = tt.prefill(tp, tcfg, {"tokens": tt_toks[:, 16:]}, max_len=64,
                          prefix_cache=tpre, prefix_len=16)
    _close(jl2, tl2)
    _close(jc2["k"], tc2["k"])
    # decode steps past the prefill (and, with the window, around the ring)
    jcache_d, tcache_d = jcache, tcache
    for pos in range(24, 24 + 4):
        tok = np.array([[pos * 7 % jcfg.vocab_size]], np.int32)
        jl3, jcache_d = jt.decode_step(jp, jcfg, jcache_d, jnp.asarray(tok), jnp.asarray(pos))
        tl3, tcache_d = tt.decode_step(tp, tcfg, tcache_d, T(tok).long(), pos)
        _close(jl3, tl3)
    _close(jcache_d["k"], tcache_d["k"])


def test_long_context_prefix_prefill_and_decode_match():
    """The long-context window (reduced: 128) on the cache-hit route: a
    100-token prefix, a 60-token suffix prefilled at ``q_offset`` 100 past
    the window into a ring of 128, then decode steps over the wrapped ring;
    the port against the JAX package at the reference's 5e-4."""
    jcfg, jp, tcfg, tp = _models()
    toks = _tokens(jcfg, 163, seed=5)
    tt_toks = T(toks).long()
    kw = dict(max_len=256, long_context=True)
    _, jpre = jt.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :100])}, **kw)
    _, tpre = tt.prefill(tp, tcfg, {"tokens": tt_toks[:, :100]}, **kw)
    assert tpre["k"].shape[2] == tcfg.long_context_window == 128
    jl, jc = jt.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, 100:160])},
                        prefix_cache=jpre, prefix_len=100, **kw)
    tl, tc = tt.prefill(tp, tcfg, {"tokens": tt_toks[:, 100:160]},
                        prefix_cache=tpre, prefix_len=100, **kw)
    _close(jl, tl, 5e-4)
    _close(jc["k"], tc["k"], 5e-4)
    for pos in range(160, 163):
        jl, jc = jt.decode_step(jp, jcfg, jc, jnp.asarray(toks[:, pos:pos + 1]),
                                jnp.asarray(pos), long_context=True)
        tl, tc = tt.decode_step(tp, tcfg, tc, tt_toks[:, pos:pos + 1], pos,
                                long_context=True)
        _close(jl, tl, 5e-4)


def test_forward_matches_prefill_logits():
    jcfg, jp, tcfg, tp = _models()
    toks = _tokens(jcfg, 12, seed=3)
    _close(jt.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, remat=False),
           tt.forward(tp, tcfg, {"tokens": T(toks).long()}))


def test_torch_init_params_shapes_and_scales():
    tcfg = get_config("yi-6b").reduced(num_layers=2, d_model=128)
    jcfg = jget_config("yi-6b").reduced(num_layers=2, d_model=128)
    jp = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32))
    tp = tt.init_params(torch.Generator().manual_seed(0), tcfg, torch.float32)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in jflat:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
        assert abs(float(t.float().std()) - float(leaf.std())) <= 0.1 * float(leaf.std()) + 1e-6
