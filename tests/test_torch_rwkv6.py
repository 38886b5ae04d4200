"""RWKV6 slice of the PyTorch port against the JAX package, on the CPU.

Inputs are drawn with numpy from a seed and handed to both sides; the JAX
model's weights reach the port through ``repro_torch.convert``. On the CPU
the port's ``ops.wkv6`` runs its plain version (``kernels/ref.wkv6_ref``);
the CUDA kernel is held against that plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` through the same case
tables (``repro_torch.kernels.cases``).

Tolerances, each from the reference's own tests:

* the recurrence: ``atol = rtol = 1e-4`` (``tests/test_kernels.py:95-98``,
  and ``tests/test_rwkv_chunked.py:29-32`` against the chunked form);
* the model: ``atol 5e-4, rtol 1e-4``. The JAX model runs
  ``wkv_scan_chunked`` for ``S >= 32``, the port the per-token recurrence at
  every ``S``; the reference holds those two to this tolerance
  (``tests/test_rwkv_chunked.py:48-49``), and holds prefill + step against
  forward to ``5e-4`` (``tests/test_models_smoke.py:84-85``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

from repro.configs import get_config as jget_config
from repro.core.kvstore import KVStore as JKVStore
from repro.core.policies import POLICIES as JPOLICIES
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import common as jc
from repro.models import rwkv6 as jrw
from repro.models import transformer as jt
from repro.serving.realexec import RealExecutionEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.kvstore import KVStore
from repro_torch.core.policies import POLICIES
from repro_torch.kernels import cases, ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve
from repro_torch.models import common as tc
from repro_torch.models import rwkv6 as trw
from repro_torch.models import transformer as tt
from repro_torch.serving.realexec import RealExecutionEngine

KERNEL_TOL = 1e-4
MODEL_ATOL, MODEL_RTOL = 5e-4, 1e-4
ARCH = "rwkv6-1.6b"
T = torch.from_numpy


def _close(a, b, atol, rtol=None):
    np.testing.assert_allclose(torch.as_tensor(b).float().numpy(),
                               np.asarray(a, np.float32), atol=atol,
                               rtol=atol if rtol is None else rtol)


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _cfgs(d_model=128):
    return (jget_config(ARCH).reduced(num_layers=2, d_model=d_model),
            get_config(ARCH).reduced(num_layers=2, d_model=d_model))


def _models(seed=0, jdtype=jnp.float32, tdtype=torch.float32):
    """The reduced rwkv6-1.6b (2 layers, d_model 128) on both sides, over
    the same weights."""
    jcfg, tcfg = _cfgs()
    jp = jt.init_params(jax.random.PRNGKey(seed), jcfg, jdtype)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu", tdtype)
    return jcfg, jp, tcfg, tp


def _tokens(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, n)).astype(np.int32)


def _layer0(jp, tp, name):
    return (jax.tree.map(lambda a: np.asarray(a[0]), jp["layers"][name]),
            tt.layer_params(tp["layers"], 0)[name])


# --------------------------------------------------------------------------- #
# 1-2. the recurrence
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("case", cases.WKV6_SWEEP + cases.WKV6_EDGE + cases.WKV6_SLICE)
def test_wkv6_matches_pallas_and_reference(case):
    """The port's wkv6 (its plain version here) against the Pallas kernel in
    interpret mode and against ``repro.kernels.ref.wkv6_ref``, on y and
    s_n; "bshd" cases pass the model's layout as permuted views."""
    arrays = [jnp.asarray(a) for a in cases.wkv6_arrays(case)]
    y, sn = ops.wkv6(*cases.wkv6_inputs(case, "cpu"))
    for jy, js in (jops.wkv6(*arrays), jref.wkv6_ref(*arrays)):
        _close(jy, y, KERNEL_TOL)
        _close(js, sn, KERNEL_TOL)


@pytest.mark.parametrize("case", cases.WKV6_NO_TOKEN)
def test_wkv6_without_tokens_returns_s0(case):
    """S = 0, which the Pallas kernel does not take: as the reference's scan,
    an empty y and s_n equal to s0 (a new tensor, not s0 itself)."""
    inputs = cases.wkv6_inputs(case, "cpu")
    y, sn = ops.wkv6(*inputs)
    jy, js = jref.wkv6_ref(*[jnp.asarray(a) for a in cases.wkv6_arrays(case)])
    assert y.shape == jy.shape == (1, 2, 0, 32)
    assert torch.equal(sn, inputs[5]) and sn.data_ptr() != inputs[5].data_ptr()
    _close(js, sn, 0.0)


@pytest.mark.parametrize("decay_lo,decay_hi", [(-5, -1), (-1, 1)])
@pytest.mark.parametrize("B,S,H,hd,chunk", [
    (1, 64, 2, 16, 16), (2, 128, 3, 32, 16), (1, 96, 1, 64, 16),
])
def test_wkv6_matches_chunked_scan(B, S, H, hd, chunk, decay_lo, decay_hi):
    """The cases and decay regimes of tests/test_rwkv_chunked.py: the JAX
    model's chunked form against the port's per-token recurrence, which
    takes the model's (B,S,H,hd) tensors as permuted views."""
    rng = np.random.default_rng(7)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(rng.uniform(decay_lo, decay_hi, (B, S, H, hd)))).astype(np.float32)
    u = rng.uniform(0, 1, (H, hd)).astype(np.float32)
    s0 = (rng.standard_normal((B, H, hd, hd)) * 0.1).astype(np.float32)
    jy, js = jrw.wkv_scan_chunked(*map(jnp.asarray, (r, k, v, w, u, s0)), chunk=chunk)
    y, sn = ops.wkv6(*(T(a).transpose(1, 2) for a in (r, k, v, w)), T(u), T(s0))
    _close(jy, y.transpose(1, 2), KERNEL_TOL)
    _close(js, sn, KERNEL_TOL)


@pytest.mark.parametrize("case", cases.WKV6_STEP + cases.WKV6_FLOOR + cases.WKV6_BF16
                         + [c for c in cases.WKV6_SLICE if c[7] == "bf16"])
def test_wkv6_bf16_rkv_is_the_fp32_call_on_upcast_values(case):
    """bf16 r, k, v (the model's activations, passed without a cast) give
    the fp32 call on the upcast values bit for bit, and match the Pallas
    kernel in interpret mode on those values at KERNEL_TOL; the one-token
    cases are the ones the step kernel takes on the card."""
    inputs = cases.wkv6_inputs(case, "cpu")
    y, sn = ops.wkv6(*inputs)
    y32, sn32 = ops.wkv6(*(t.float() for t in inputs[:3]), *inputs[3:])
    assert y.dtype == sn.dtype == torch.float32
    assert torch.equal(y, y32) and torch.equal(sn, sn32)
    jy, js = jops.wkv6(*[jnp.asarray(a) for a in cases.wkv6_arrays(case)])
    _close(jy, y, KERNEL_TOL)
    _close(js, sn, KERNEL_TOL)


def test_wkv6_wrapper_rejects_bad_inputs():
    r, k, v, w, u, s0 = cases.wkv6_inputs(cases.WKV6_SWEEP[0], "cpu")
    with pytest.raises(TypeError, match="float32"):
        ops.wkv6(r.bfloat16(), k, v, w, u, s0)         # r, k, v in one dtype
    with pytest.raises(TypeError, match="float32"):
        ops.wkv6(*(t.half() for t in (r, k, v)), w, u, s0)
    with pytest.raises(TypeError, match="float32"):
        ops.wkv6(r, k, v, w.bfloat16(), u, s0)         # w, u, s0 stay fp32
    with pytest.raises(ValueError):
        ops.wkv6(r, k[:, :, :-1], v, w, u, s0)
    with pytest.raises(ValueError):
        ops.wkv6(r, k, v, w, u[:1], s0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.wkv6(*(t.to("meta") for t in (r, k, v, w, u, s0)))


def test_wkv6_cpu_path_counts_no_launch():
    n = ops.wkv6.launches
    cases.check_wkv6(cases.WKV6_EDGE[-1], "cpu")
    assert ops.wkv6.launches == n


# --------------------------------------------------------------------------- #
# 3. the block's functions on converted parameters
# --------------------------------------------------------------------------- #

def test_groupnorm_heads_matches():
    x, scale, bias = _rand(0, (2, 5, 4, 32), (4, 32), (4, 32))
    x[..., 0] += 50.0                      # a large mean: population variance matters
    p = {"scale": scale, "bias": bias}
    _close(jc.groupnorm_heads(p, x), tc.groupnorm_heads({k: T(a) for k, a in p.items()},
                                                        T(x)), 1e-5)


def test_ddlerp_matches_fp32():
    jcfg, jp, tcfg, tp = _models()
    jtm, ttm = _layer0(jp, tp, "tmix")
    x, xp = _rand(1, (2, 7, 128), (2, 7, 128))
    a, b = jrw._ddlerp(jtm, x, xp), trw._ddlerp(ttm, T(x), T(xp))
    for name in ("r", "k", "v", "w", "g"):
        _close(a[name], b[name], 1e-5)


def test_ddlerp_matches_bf16_with_fp32_mixing():
    """bf16 weights with fp32 ``mu`` and ``ts_w1``/``ts_w2`` in bf16: the
    products mix dtypes, which ``torch.matmul`` refuses and JAX promotes to
    fp32; the port casts the weight up and matches JAX at the bf16
    tolerance, in bf16 outputs."""
    jcfg, jp, tcfg, tp = _models(jdtype=jnp.bfloat16, tdtype=torch.bfloat16)
    jtm, ttm = _layer0(jp, tp, "tmix")
    assert ttm["mu"].dtype == torch.float32 and ttm["ts_w1"].dtype == torch.bfloat16
    x, xp = _rand(2, (1, 9, 128), (1, 9, 128))
    jx, jxp = jnp.asarray(x, jnp.bfloat16), jnp.asarray(xp, jnp.bfloat16)
    a = jrw._ddlerp(jtm, jx, jxp)
    b = trw._ddlerp(ttm, T(x).bfloat16(), T(xp).bfloat16())
    for name in ("r", "k", "v", "w", "g"):
        assert b[name].dtype == torch.bfloat16
        _close(np.asarray(a[name], np.float32), b[name], cases.TOL[torch.bfloat16])


@pytest.mark.parametrize("S", [1, 20, 40])
def test_time_mix_matches(S):
    jcfg, jp, tcfg, tp = _models()
    jtm, ttm = _layer0(jp, tp, "tmix")
    H, hd = tcfg.num_rwkv_heads, tcfg.rwkv_head_dim
    x, xp, s0 = _rand(3, (2, S, 128), (2, 128), (2, H, hd, hd))
    jo, jx, js = jrw.time_mix(jtm, jcfg, x, xp, s0 * 0.1)
    to, tx, ts = trw.time_mix(ttm, tcfg, T(x), T(xp), T(s0 * 0.1))
    _close(jo, to, MODEL_ATOL, MODEL_RTOL)
    _close(jx, tx, 0.0)
    _close(js, ts, MODEL_ATOL, MODEL_RTOL)


def test_channel_mix_matches():
    jcfg, jp, tcfg, tp = _models()
    jcm, tcm = _layer0(jp, tp, "cmix")
    x, xp = _rand(4, (2, 11, 128), (2, 128))
    jo, jx = jrw.channel_mix(jcm, x, xp)
    to, tx = trw.channel_mix(tcm, T(x), T(xp))
    _close(jo, to, 1e-5)
    _close(jx, tx, 0.0)


# --------------------------------------------------------------------------- #
# 4. the reduced rwkv6-1.6b
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("S", [20, 64])
def test_forward_matches(S):
    """S = 20 runs the JAX scan, S = 64 its chunked form."""
    jcfg, jp, tcfg, tp = _models()
    toks = _tokens(jcfg, S, seed=S)
    _close(jt.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, remat=False),
           tt.forward(tp, tcfg, {"tokens": T(toks).long()}), MODEL_ATOL, MODEL_RTOL)


def test_prefill_caches_and_decode_match():
    jcfg, jp, tcfg, tp = _models()
    toks = _tokens(jcfg, 24, seed=1)
    jl, jcache = jt.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=64)
    tl, tcache = tt.prefill(tp, tcfg, {"tokens": T(toks).long()}, max_len=64)
    _close(jl, tl, MODEL_ATOL, MODEL_RTOL)
    assert set(tcache) == set(jcache) == {"wkv", "x_tm", "x_cm"}
    for name in jcache:
        assert tuple(tcache[name].shape) == jcache[name].shape
        _close(jcache[name], tcache[name], MODEL_ATOL, MODEL_RTOL)
    for pos in range(24, 27):
        tok = np.array([[pos * 7 % jcfg.vocab_size]], np.int32)
        jl, jcache = jt.decode_step(jp, jcfg, jcache, jnp.asarray(tok), jnp.asarray(pos))
        tl, tcache = tt.decode_step(tp, tcfg, tcache, T(tok).long(), pos)
        _close(jl, tl, MODEL_ATOL, MODEL_RTOL)
    for name in jcache:
        _close(jcache[name], tcache[name], MODEL_ATOL, MODEL_RTOL)


@pytest.mark.parametrize("S", [16, 63])
def test_prefill_plus_step_matches_forward(S):
    """prefill(S) then one decode step == forward(S + 1) at the last
    position, on the port and against the JAX forward."""
    jcfg, jp, tcfg, tp = _models()
    toks = _tokens(jcfg, S + 1, seed=2)
    tl, cache = tt.prefill(tp, tcfg, {"tokens": T(toks[:, :S]).long()}, max_len=128)
    step, _ = tt.decode_step(tp, tcfg, cache, T(toks[:, S:]).long(), S)
    full = tt.forward(tp, tcfg, {"tokens": T(toks).long()})
    _close(full[:, -1].numpy(), step[:, 0], MODEL_ATOL, MODEL_RTOL)
    jfull = jt.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, remat=False)
    _close(jfull[:, -1], step[:, 0], MODEL_ATOL, MODEL_RTOL)


def test_prefill_takes_no_stored_prefix():
    jcfg, jp, tcfg, tp = _models()
    _, cache = tt.prefill(tp, tcfg, {"tokens": T(_tokens(tcfg, 4)).long()}, max_len=16)
    with pytest.raises(ValueError, match="decode_step"):
        tt.prefill(tp, tcfg, {"tokens": T(_tokens(tcfg, 4)).long()}, max_len=16,
                   prefix_cache=cache, prefix_len=4)


# --------------------------------------------------------------------------- #
# 5-6. the engine: state-snapshot route
# --------------------------------------------------------------------------- #

def _engines(seed=0, max_len=128):
    jcfg, jp, tcfg, tp = _models(seed)
    jeng = JEngine(jcfg, jp, JKVStore(64e6, JPOLICIES["lcs"], max(jcfg.kv_bytes_per_token, 1.0)),
                   max_len=max_len)
    teng = RealExecutionEngine(tcfg, tp, KVStore(64e6, POLICIES["lcs"],
                                                 max(tcfg.kv_bytes_per_token, 1.0)),
                               max_len=max_len, dtype=torch.float32, device="cpu")
    return jeng, teng


def _same(jr, tr):
    assert tr.tokens == jr.tokens
    assert tr.reused_tokens == jr.reused_tokens
    assert tr.prefill_tokens_computed == jr.prefill_tokens_computed


def test_multi_turn_reuse_identical_output():
    """Twin of test_multi_turn_reuse_identical_output[rwkv6-1.6b]: the port
    and the JAX engine on the same weights give the same tokens and reuse
    counts, and the hit equals a cold engine's turn 2."""
    jeng, teng = _engines()
    rng = np.random.default_rng(1)
    ctx = [int(t) for t in rng.integers(0, 512, 20)]
    extra = [int(t) for t in rng.integers(0, 512, 6)]
    j1, t1 = jeng.generate("c", ctx, num_new=3), teng.generate("c", ctx, num_new=3)
    _same(j1, t1)
    assert t1.reused_tokens == 0
    ctx2 = ctx + t1.tokens + extra
    j2, t2 = jeng.generate("c", ctx2, num_new=3), teng.generate("c", ctx2, num_new=3)
    _same(j2, t2)
    assert t2.reused_tokens == len(ctx)
    assert t2.prefill_tokens_computed == len(ctx2) - len(ctx)

    _, cold = _engines()
    tc_ = cold.generate("other", ctx2, num_new=3)
    assert tc_.reused_tokens == 0 and tc_.tokens == t2.tokens
    _close(tc_.last_logits.numpy(), t2.last_logits, 1e-5)


def test_store_counts_one_byte_per_token():
    """kv_bytes_per_token is 0 for an attention-free model, so the store
    counts max(0, 1) = 1 byte per token, as the reference's launcher sets
    it; the payload is the whole recurrent state."""
    jeng, teng = _engines()
    ctx = [int(t) for t in np.random.default_rng(2).integers(0, 512, 12)]
    _same(jeng.generate("a", ctx, num_new=2), teng.generate("a", ctx, num_new=2))
    e, je = teng.store.entries["a"], jeng.store.entries["a"]
    assert (e.num_tokens, e.size_bytes) == (je.num_tokens, je.size_bytes) == (12, 12.0)
    plen, pay = e.payload
    assert plen == 12 and set(pay) == {"wkv", "x_tm", "x_cm"}
    assert pay["wkv"].shape == (2, 1, 4, 32, 32) and pay["wkv"].dtype == torch.float32


def test_decode_does_not_advance_the_stored_state():
    """decode_step updates the state in place; the stored snapshot must stay
    the state after the prompt, through the decode that follows the store
    and through a hit that resumes from it (JAX arrays are immutable, so
    the JAX engine shows what the tokens must be)."""
    jeng, teng = _engines()
    ctx = [int(t) for t in np.random.default_rng(4).integers(0, 512, 10)]
    _same(jeng.generate("x", ctx, num_new=5), teng.generate("x", ctx, num_new=5))
    plen, pay = teng.store.entries["x"].payload
    _, want = tt.prefill(teng.params, teng.cfg, {"tokens": torch.tensor([ctx])}, max_len=16)
    for name in pay:
        torch.testing.assert_close(pay[name], want[name], atol=1e-5, rtol=1e-5)
    saved = {k: v.clone() for k, v in pay.items()}
    r = teng.generate("x", ctx + [3], num_new=6)
    _same(jeng.generate("x", ctx + [3], num_new=6), r)
    assert r.reused_tokens == 10
    for name in saved:
        assert torch.equal(pay[name], saved[name])
    r_again = teng.generate("x", ctx + [3, 5], num_new=6)
    _same(jeng.generate("x", ctx + [3, 5], num_new=6), r_again)
    assert r_again.reused_tokens == 11
    _, cold = _engines()
    assert cold.generate("y", ctx + [3, 5], num_new=6).tokens == r_again.tokens


def test_hit_without_suffix_fails_on_both():
    """A stored prefix equal to the prompt leaves nothing to feed: the JAX
    engine fails at argmax of None logits, the port raises ValueError."""
    jeng, teng = _engines()
    ctx = [int(t) for t in np.random.default_rng(5).integers(0, 512, 8)]
    _same(jeng.generate("e", ctx, num_new=1), teng.generate("e", ctx, num_new=1))
    with pytest.raises(TypeError):
        jeng.generate("e", ctx, num_new=1)
    with pytest.raises(ValueError, match="no token is left to feed"):
        teng.generate("e", ctx, num_new=1)


def test_serve_demo_runs_on_cpu(capsys):
    serve.main(["--real", "--arch", ARCH, "--device", "cpu", "--reduced"])
    out = capsys.readouterr().out
    assert "turn 2: computed 12 prefill tokens, reused 24" in out
    assert "cache hit verified" in out


# --------------------------------------------------------------------------- #
# 7. parameters: config, init, conversion
# --------------------------------------------------------------------------- #

def test_config_copy_matches_reference():
    for reduce in (False, True):
        a, b = jget_config(ARCH), get_config(ARCH)
        if reduce:
            a, b = a.reduced(num_layers=2, d_model=128), b.reduced(num_layers=2, d_model=128)
        for f in dataclasses.fields(b):
            assert getattr(a, f.name) == getattr(b, f.name), f.name
        assert (a.padded_vocab, a.kv_bytes_per_token, a.num_rwkv_heads) == \
            (b.padded_vocab, b.kv_bytes_per_token, b.num_rwkv_heads)
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.num_rwkv_heads, full.rwkv_head_dim,
            full.d_ff, full.vocab_size) == (24, 2048, 32, 64, 7168, 65536)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float32, torch.float32),
                                           (jnp.bfloat16, torch.bfloat16)])
def test_init_params_shapes_dtypes_and_scales(jdtype, tdtype):
    jcfg, tcfg = _cfgs()
    jp = dict(_flat(jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(0), jcfg,
                                                            jdtype))))
    tp = dict(_flat(tt.init_params(torch.Generator().manual_seed(0), tcfg, tdtype)))
    assert set(jp) == set(tp)
    for path, leaf in jp.items():
        t = tp[path]
        assert tuple(t.shape) == leaf.shape, path
        want = torch.float32 if leaf.dtype == np.float32 else torch.bfloat16
        assert t.dtype == want, path
        # the draws differ: the scales agree to well inside a wrong scale's
        # factor (1/sqrt(d) against 1e-2 is 11x here)
        a, b = leaf.astype(np.float32), t.float()
        sd = float(a.std())
        assert abs(float(b.std()) - sd) <= 0.2 * sd + 1e-6, path
        assert abs(float(b.mean()) - float(a.mean())) <= 0.3 * sd + 1e-6, path


def test_convert_keeps_fp32_leaves_at_bf16():
    """The reference keeps mu, decay_base, u, mu_k and mu_r in fp32 in a
    bf16 model; conversion keeps every leaf's dtype and its exact values."""
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(3), jcfg, jnp.bfloat16))
    tp = dict(_flat(params_from_jax(jp, tcfg, "cpu", torch.bfloat16)))
    fp32 = set()
    for path, leaf in _flat(jp):
        t = tp[path]
        if leaf.dtype == np.float32:
            fp32.add(path[-1])
            assert t.dtype == torch.float32, path
        else:
            assert t.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(t.float().numpy(), leaf.astype(np.float32))
    assert fp32 == set(trw.FP32_LEAVES)


def test_wkv6_ref_is_the_reference_recurrence_in_kernel_layout():
    """The port's plain version and the reference's oracle, called directly
    (no wrapper), on one sweep case."""
    arrays = cases.wkv6_arrays(cases.WKV6_SWEEP[1], seed=3)
    y, sn = tref.wkv6_ref(*map(T, arrays))
    jy, js = jref.wkv6_ref(*map(jnp.asarray, arrays))
    _close(jy, y, KERNEL_TOL)
    _close(js, sn, KERNEL_TOL)
