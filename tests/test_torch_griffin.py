"""Griffin (recurrentgemma-2b) slice of the PyTorch port against the JAX
package, on the CPU.

Inputs are drawn with numpy from a seed and handed to both sides; the JAX
model's weights reach the port through ``repro_torch.convert``. On the CPU
the port's ``ops.rglru_scan`` and ``ops.rglru_step`` run their plain
versions (``kernels/ref.rglru_scan_ref``, ``rglru_step_ref``); the CUDA
kernels are held against those plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` through the same case
tables (``repro_torch.kernels.cases``).

Tolerances, each from the reference's own tests:

* the recurrence: ``atol`` 1e-5 (``tests/test_kernels.py:79-80``), and
  the decode step (``cases.RGLRU_TOL``), with a bf16 ``y`` at the bf16
  kernel tolerance 2e-2 (``cases.TOL``, ``tests/test_kernels.py``);
* the model, prefill + step against forward and the port against the JAX
  model: ``atol`` 5e-4 (``tests/test_models_smoke.py:84-85``). The JAX
  model's ``rglru_scan`` is an ``associative_scan`` with ``h0`` folded into
  ``b[:, 0]``, the port's the sequential kernel: the same function, rounded
  in another order.

The block's pieces are held tighter, at 1e-5: in fp32 over a few steps the
two orders of rounding differ by about 1e-7, and the tighter limit is what
catches a gate taken in the exact erf form instead of the tanh form.

The reference's tests build the hybrid with 4 layers (one unit and one tail
layer); 3 layers is one unit and no tail, 2 (the ``--reduced`` demo) two
tail layers and no unit. The reduced local window is 32, so S = 40 masks
keys in the prefill and wraps the ring.
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
from repro.models import griffin as jgr
from repro.models import transformer as jt
from repro.serving.realexec import RealExecutionEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.kvstore import KVStore
from repro_torch.core.policies import POLICIES
from repro_torch.kernels import cases, ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve
from repro_torch.models import griffin as tgr
from repro_torch.models import transformer as tt
from repro_torch.serving.realexec import RealExecutionEngine

KERNEL_TOL = 1e-5
BLOCK_TOL = 1e-5
MODEL_TOL = 5e-4
ARCH = "recurrentgemma-2b"
T = torch.from_numpy


def _close(a, b, atol):
    np.testing.assert_allclose(torch.as_tensor(b).float().numpy(),
                               np.asarray(a, np.float32), atol=atol)


def _rand(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def _cfgs(num_layers=4, d_model=128):
    return (jget_config(ARCH).reduced(num_layers=num_layers, d_model=d_model),
            get_config(ARCH).reduced(num_layers=num_layers, d_model=d_model))


def _models(num_layers=4, d_model=128, seed=0, jdtype=jnp.float32,
            tdtype=torch.float32):
    """The reduced recurrentgemma-2b on both sides, over the same weights."""
    jcfg, tcfg = _cfgs(num_layers, d_model)
    jp = jt.init_params(jax.random.PRNGKey(seed), jcfg, jdtype)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu", tdtype)
    return jcfg, jp, tcfg, tp


def _tokens(cfg, n, seed=0, batch=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (batch, n)).astype(np.int32)


def _rg0(jp, tp):
    """The first unit's first recurrent block on both sides."""
    return (jax.tree.map(lambda a: np.asarray(a[0]), jp["units"]["rec1"]["rg"]),
            tt.layer_params(tp["units"], 0)["rec1"]["rg"])


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def _close_tree(jtree, ttree, atol):
    j, t = dict(_flat(jtree)), dict(_flat(ttree))
    assert set(j) == set(t)
    for path, leaf in j.items():
        assert tuple(t[path].shape) == np.shape(leaf), path
        _close(leaf, t[path], atol)


# --------------------------------------------------------------------------- #
# 1-3. the recurrence
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("case", cases.RGLRU_SWEEP + cases.RGLRU_EDGE + cases.RGLRU_CHUNK)
def test_rglru_matches_pallas_and_reference(case):
    """The port's rglru_scan (its plain version here) against the Pallas
    kernel in interpret mode and against ``repro.kernels.ref.rglru_scan_ref``,
    on y and h_S; "wide" cases pass strided views."""
    arrays = [jnp.asarray(a) for a in cases.rglru_arrays(case)]
    y, hn = ops.rglru_scan(*cases.rglru_inputs(case, "cpu"))
    for jy, jh in (jops.rglru_scan(*arrays), jref.rglru_scan_ref(*arrays)):
        _close(jy, y, KERNEL_TOL)
        _close(jh, hn, KERNEL_TOL)


@pytest.mark.parametrize("case", cases.RGLRU_NO_TOKEN)
def test_rglru_without_tokens_returns_h0(case):
    """S = 0, which the Pallas kernel does not take: as the reference's scan,
    an empty y and h_S equal to h0 (a new tensor, not h0 itself)."""
    inputs = cases.rglru_inputs(case, "cpu")
    y, hn = ops.rglru_scan(*inputs)
    jy, jh = jref.rglru_scan_ref(*[jnp.asarray(a) for a in cases.rglru_arrays(case)])
    assert y.shape == jy.shape == (1, 0, 64)
    assert torch.equal(hn, inputs[2]) and hn.data_ptr() != inputs[2].data_ptr()
    _close(jh, hn, 0.0)


def test_rglru_ref_is_the_reference_recurrence():
    """The port's plain version and the reference's oracle, called directly
    (no wrapper), on one sweep case."""
    arrays = cases.rglru_arrays(cases.RGLRU_SWEEP[1], seed=3)
    y, hn = tref.rglru_scan_ref(*map(T, arrays))
    jy, jh = jref.rglru_scan_ref(*map(jnp.asarray, arrays))
    _close(jy, y, KERNEL_TOL)
    _close(jh, hn, KERNEL_TOL)


def test_rglru_wide_case_reads_strided_views():
    a, b, h0 = cases.rglru_inputs(cases.RGLRU_EDGE[-1], "cpu")
    assert not a.is_contiguous() and a.stride(-1) == 1 and a.stride(1) == 2 * a.shape[-1]
    assert h0.stride(0) == 2 * h0.shape[-1]


def test_rglru_wrapper_rejects_bad_inputs():
    a, b, h0 = cases.rglru_inputs(cases.RGLRU_SWEEP[0], "cpu")
    with pytest.raises(TypeError, match="float32"):
        ops.rglru_scan(a.bfloat16(), b, h0)
    with pytest.raises(ValueError):
        ops.rglru_scan(a, b[:, :-1], h0)
    with pytest.raises(ValueError):
        ops.rglru_scan(a, b, h0[:, :-1])
    with pytest.raises(ValueError):
        ops.rglru_scan(a[0], b[0], h0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.rglru_scan(*(t.to("meta") for t in (a, b, h0)))


def test_rglru_cpu_path_counts_no_launch():
    n = ops.rglru_scan.launches
    cases.check_rglru(cases.RGLRU_EDGE[2], "cpu")
    assert ops.rglru_scan.launches == n


# --------------------------------------------------------------------------- #
# 4. the block's functions on converted parameters
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("S", [1, 2, 7])
def test_causal_conv_matches(S):
    """S below W-1 = 3 too: the new history is the last W-1 inputs of
    [history, x], part of it from the old history."""
    jcfg, jp, tcfg, tp = _models()
    jrg, trg = _rg0(jp, tp)
    x, hist = _rand(1, (2, S, 128), (2, 3, 128))
    jo, jh = jgr._causal_conv(jrg, x, hist)
    to, th = tgr._causal_conv(trg, T(x), T(hist))
    _close(jo, to, BLOCK_TOL)
    _close(jh, th, 0.0)
    assert th.shape == (2, 3, 128)


def test_rglru_coeffs_match():
    jcfg, jp, tcfg, tp = _models()
    jrg, trg = _rg0(jp, tp)
    (x,) = _rand(2, (2, 9, 128))
    for a, b in zip(jgr._rglru_coeffs(jrg, x), tgr._rglru_coeffs(trg, T(x))):
        assert b.dtype == torch.float32
        _close(a, b, BLOCK_TOL)


def test_rglru_coeffs_match_bf16_with_fp32_leaves():
    """bf16 weights and input with fp32 ba/bx/lam: the port casts x and
    wa/wx up to fp32, as JAX's promotion does, and returns fp32."""
    jcfg, jp, tcfg, tp = _models(jdtype=jnp.bfloat16, tdtype=torch.bfloat16)
    jrg, trg = _rg0(jp, tp)
    assert trg["wa"].dtype == torch.bfloat16 and trg["ba"].dtype == torch.float32
    (x,) = _rand(3, (1, 5, 128))
    a = jgr._rglru_coeffs(jrg, jnp.asarray(x, jnp.bfloat16))
    b = tgr._rglru_coeffs(trg, T(x).bfloat16())
    for ja, tb in zip(a, b):
        assert tb.dtype == torch.float32
        _close(ja, tb, BLOCK_TOL)


def test_gate_scale_is_the_clamped_exp_form():
    """At r = 0 the decay is 1 and 1 - a^2 is 0: the reference takes
    sqrt(max(1 - exp(2 log_a), 1e-12)) = 1e-6, not 0."""
    jcfg, jp, tcfg, tp = _models()
    jrg, trg = _rg0(jp, tp)
    trg = dict(trg, ba=torch.full_like(trg["ba"], -1e4))      # r = sigmoid(-1e4) = 0
    jrg = dict(jrg, ba=np.full_like(jrg["ba"], -1e4))
    (x,) = _rand(4, (1, 3, 128))
    ja, jb = jgr._rglru_coeffs(jrg, x)
    ta, tb = tgr._rglru_coeffs(trg, T(x))
    assert bool((ta == 1.0).all())
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=0)


@pytest.mark.parametrize("S", [1, 16, 40])
def test_rglru_scan_matches(S):
    """The port's model scan (the kernel, h0 given) against the reference's
    associative scan (h0 folded into b[:, 0]); y in x's dtype, h fp32."""
    jcfg, jp, tcfg, tp = _models()
    jrg, trg = _rg0(jp, tp)
    x, h0 = _rand(5, (2, S, 128), (2, 128))
    jy, jh = jgr.rglru_scan(jrg, x, h0)
    ty, th = tgr.rglru_scan(trg, T(x), T(h0))
    assert ty.dtype == torch.float32 and th.dtype == torch.float32
    _close(jy, ty, BLOCK_TOL)
    _close(jh, th, BLOCK_TOL)


def test_rglru_step_matches():
    jcfg, jp, tcfg, tp = _models()
    jrg, trg = _rg0(jp, tp)
    x, h = _rand(6, (2, 128), (2, 128))
    jy, jh = jgr.rglru_step(jrg, x, h)
    ty, th = tgr.rglru_step(trg, T(x), T(h))
    _close(jy, ty, BLOCK_TOL)
    _close(jh, th, BLOCK_TOL)


def test_rglru_step_goes_through_the_kernel_entry(monkeypatch):
    """The step is one call of ops.rglru_step (the fused step kernel on the
    card) and none of ops.rglru_scan: the recurrence and its elementwise
    chain run in one launch, where the reference computes them inline."""
    jcfg, jp, tcfg, tp = _models()
    _, trg = _rg0(jp, tp)
    seen = []
    real = ops.rglru_step
    monkeypatch.setattr(ops, "rglru_step",
                        lambda *a: seen.append(tuple(a[5].shape)) or real(*a))
    monkeypatch.setattr(ops, "rglru_scan", None)
    x, h = _rand(6, (2, 128), (2, 128))
    tgr.rglru_step(trg, T(x), T(h))
    assert seen == [(2, 128)]


# (B, D, dtype of x and of wa/wx, h as a strided view): B = 2, an odd D,
# recurrentgemma-2b's width, bf16 as the served model holds it
STEP_MODEL_CASES = [(2, 77, "float32", True), (2, 77, "bfloat16", True),
                    (1, 2560, "bfloat16", False), (3, 128, "float32", False)]


def _step_params(D, seed):
    """wa, wx (D,D), ba, bx, lam (D,) from numpy; channel 0 gets r = 0 (the
    clamped scale), channel 1 softplus's linear branch."""
    rng = np.random.default_rng(seed)
    wa, wx = ((rng.standard_normal((D, D)) * D ** -0.5).astype(np.float32) for _ in range(2))
    ba, bx = ((rng.standard_normal(D) * 0.5).astype(np.float32) for _ in range(2))
    lam = rng.uniform(0.0013, 0.1320, D).astype(np.float32)
    ba[0], lam[1] = -1e4, 25.0
    return {"wa": wa, "wx": wx, "ba": ba, "bx": bx, "lam": lam}


@pytest.mark.parametrize("case", STEP_MODEL_CASES)
def test_rglru_step_and_plain_step_match_reference_step(case):
    """The port's griffin.rglru_step (ops.rglru_step) and the kernel's plain
    version ref.rglru_step_ref, called directly on the two products, against
    repro.models.griffin.rglru_step on the same params, x and h: h' at
    cases.RGLRU_TOL, y at RGLRU_TOL in fp32 and cases.TOL in bf16 (one bf16
    rounding of h')."""
    B, D, dtype, strided = case
    jp = _step_params(D, seed=D)
    x, h = _rand(9, (B, D), (B, D))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tp = {k: T(v) for k, v in jp.items()}
    tp["wa"], tp["wx"] = tp["wa"].to(tdt), tp["wx"].to(tdt)
    jpar = dict(jp, wa=jnp.asarray(jp["wa"], jdt), wx=jnp.asarray(jp["wx"], jdt))
    tx = T(x).to(tdt)
    th = torch.cat([T(h), torch.zeros_like(T(h))], dim=1)[:, :D] if strided else T(h)
    assert th.is_contiguous() != strided
    jy, jh = jgr.rglru_step(jpar, jnp.asarray(x, jdt), jnp.asarray(h))
    x32 = tx.float()
    for ty, th2 in (tgr.rglru_step(tp, tx, th),
                    tref.rglru_step_ref(x32 @ tp["wa"].float(), x32 @ tp["wx"].float(),
                                        tp["ba"], tp["bx"], tp["lam"], tx, th)):
        assert ty.dtype == tdt and th2.dtype == torch.float32
        _close(jh, th2, cases.RGLRU_TOL)
        _close(jy, ty, cases.RGLRU_TOL if dtype == "float32" else cases.TOL[torch.bfloat16])


def test_rglru_step_wrapper_rejects_bad_inputs():
    gx_a, gx_x, ba, bx, lam, x, h = cases.rglru_step_inputs(cases.RGLRU_STEP[3], "cpu")
    with pytest.raises(TypeError, match="float32"):
        ops.rglru_step(gx_a, gx_x, ba, bx, lam, x, h.bfloat16())
    with pytest.raises(TypeError, match="float32"):
        ops.rglru_step(gx_a, gx_x, ba, bx, lam, x.half(), h)
    with pytest.raises(ValueError):
        ops.rglru_step(gx_a[:, :-1], gx_x, ba, bx, lam, x, h)
    with pytest.raises(ValueError):
        ops.rglru_step(gx_a, gx_x, ba[:-1], bx, lam, x, h)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.rglru_step(*(t.to("meta") for t in (gx_a, gx_x, ba, bx, lam, x, h)))


def test_rglru_step_cpu_path_counts_no_launch():
    n, m = ops.rglru_step.launches, ops.rglru_scan.launches
    cases.check_rglru_step(cases.RGLRU_STEP[2], "cpu")
    assert (ops.rglru_step.launches, ops.rglru_scan.launches) == (n, m)


@pytest.mark.parametrize("S", [2, 16])
def test_rglru_block_matches(S):
    jcfg, jp, tcfg, tp = _models()
    jrg, trg = _rg0(jp, tp)
    x, h0, conv = _rand(7, (2, S, 128), (2, 128), (2, 3, 128))
    jo, js = jgr.rglru_block(jrg, x, {"h": h0, "conv": conv})
    to, ts = tgr.rglru_block(trg, T(x), {"h": T(h0), "conv": T(conv)})
    _close(jo, to, BLOCK_TOL)
    _close_tree(js, ts, BLOCK_TOL)


def test_rglru_block_step_matches():
    jcfg, jp, tcfg, tp = _models()
    jrg, trg = _rg0(jp, tp)
    x, h0, conv = _rand(8, (2, 128), (2, 128), (2, 3, 128))
    jo, js = jgr.rglru_block_step(jrg, x, {"h": h0, "conv": conv})
    to, ts = tgr.rglru_block_step(trg, T(x), {"h": T(h0), "conv": T(conv)})
    _close(jo, to, BLOCK_TOL)
    _close_tree(js, ts, BLOCK_TOL)
    assert ts["h"].dtype == torch.float32


# --------------------------------------------------------------------------- #
# 5. the reduced recurrentgemma-2b
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("S", [16, 40])
@pytest.mark.parametrize("num_layers", [3, 4])
def test_forward_matches(num_layers, S):
    """3 layers: one unit, no tail; 4: one unit and one tail layer. At
    S = 40 the local window of 32 masks keys."""
    jcfg, jp, tcfg, tp = _models(num_layers)
    toks = _tokens(jcfg, S, seed=S)
    _close(jt.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, remat=False),
           tt.forward(tp, tcfg, {"tokens": T(toks).long()}), MODEL_TOL)


@pytest.mark.parametrize("S", [16, 40])
@pytest.mark.parametrize("num_layers", [3, 4])
def test_prefill_cache_matches(num_layers, S):
    """Logits and the whole nested cache: each unit's h and conv states and
    its local-attention ring (at S = 40 the last 32 K/V wrap the ring), the
    tail's h and conv."""
    jcfg, jp, tcfg, tp = _models(num_layers)
    toks = _tokens(jcfg, S, seed=1)
    jl, jcache = jt.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=64)
    tl, tcache = tt.prefill(tp, tcfg, {"tokens": T(toks).long()}, max_len=64)
    _close(jl, tl, MODEL_TOL)
    assert set(tcache) == set(jcache) == ({"units", "tail"} if num_layers == 4
                                          else {"units"})
    _close_tree(jax.tree.map(np.asarray, jcache), tcache, MODEL_TOL)
    assert tcache["units"]["k"].shape[2] == 32
    assert tcache["units"]["rec1_h"].dtype == torch.float32


def test_prefill_then_decode_steps_match():
    """Decode steps after a prefill past the window read and write a
    wrapped ring; logits and caches stay with the JAX model's."""
    jcfg, jp, tcfg, tp = _models()
    toks = _tokens(jcfg, 40, seed=2)
    jl, jcache = jt.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=64)
    tl, tcache = tt.prefill(tp, tcfg, {"tokens": T(toks).long()}, max_len=64)
    for pos in range(40, 44):
        tok = np.array([[pos * 7 % jcfg.vocab_size]], np.int32)
        jl, jcache = jt.decode_step(jp, jcfg, jcache, jnp.asarray(tok), jnp.asarray(pos))
        tl, tcache = tt.decode_step(tp, tcfg, tcache, T(tok).long(), pos)
        _close(jl, tl, MODEL_TOL)
    _close_tree(jax.tree.map(np.asarray, jcache), tcache, MODEL_TOL)


def test_prefill_plus_step_matches_forward():
    """Twin of test_prefill_decode_consistency[recurrentgemma-2b]: reduced
    to 4 layers and d_model 256, B 2, S 16, max_len 32; prefill then one
    step == forward at the last position, on the port and against the JAX
    forward."""
    jcfg, jp, tcfg, tp = _models(num_layers=4, d_model=256)
    toks = _tokens(jcfg, 16, seed=0, batch=2)
    new = np.full((2, 1), 5, np.int32)
    _, cache = tt.prefill(tp, tcfg, {"tokens": T(toks).long()}, max_len=32)
    step, _ = tt.decode_step(tp, tcfg, cache, T(new).long(), 16)
    both = np.concatenate([toks, new], axis=1)
    full = tt.forward(tp, tcfg, {"tokens": T(both).long()})
    _close(full[:, -1].numpy(), step[:, 0], MODEL_TOL)
    jfull = jt.forward(jp, jcfg, {"tokens": jnp.asarray(both)}, remat=False)
    _close(jfull[:, -1], step[:, 0], MODEL_TOL)


def test_prefill_takes_no_stored_prefix():
    jcfg, jp, tcfg, tp = _models()
    toks = T(_tokens(tcfg, 4)).long()
    _, cache = tt.prefill(tp, tcfg, {"tokens": toks}, max_len=16)
    with pytest.raises(ValueError, match="decode_step"):
        tt.prefill(tp, tcfg, {"tokens": toks}, max_len=16, prefix_cache=cache,
                   prefix_len=4)


# --------------------------------------------------------------------------- #
# 6. the engine: state-snapshot route
# --------------------------------------------------------------------------- #

def _engines(seed=0, max_len=128, num_layers=4):
    """The reference's make_engine("recurrentgemma-2b") on both sides."""
    jcfg, jp, tcfg, tp = _models(num_layers, seed=seed)
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


@pytest.mark.parametrize("ctx_len", [20, 40])
def test_multi_turn_reuse_identical_output(ctx_len):
    """Twin of test_multi_turn_reuse_identical_output[recurrentgemma-2b]
    (ctx_len 20); at 40 the context passes the 32-slot ring, so turn 1
    feeds through a wrapped ring and the snapshot holds one. The port and
    the JAX engine on the same weights give the same tokens and reuse
    counts, and the hit equals a cold engine's turn 2."""
    jeng, teng = _engines()
    rng = np.random.default_rng(1)
    ctx = [int(t) for t in rng.integers(0, 512, ctx_len)]
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


def test_decode_does_not_advance_the_stored_snapshot():
    """decode_step updates the nested state (recurrent states and rings) in
    place; the stored snapshot must stay the state after the prompt through
    the decode that follows the store and through a hit that resumes from
    it (JAX arrays are immutable, so the JAX engine shows what the tokens
    must be)."""
    jeng, teng = _engines()
    ctx = [int(t) for t in np.random.default_rng(4).integers(0, 512, 10)]
    _same(jeng.generate("x", ctx, num_new=5), teng.generate("x", ctx, num_new=5))
    plen, pay = teng.store.entries["x"].payload
    assert plen == 10 and set(pay) == {"units", "tail"}
    _, want = tt.prefill(teng.params, teng.cfg, {"tokens": torch.tensor([ctx])},
                         max_len=128)
    _close_tree({k: {n: t.numpy() for n, t in v.items()} for k, v in want.items()},
                pay, 1e-5)
    saved = {k: {n: t.clone() for n, t in v.items()} for k, v in pay.items()}
    r = teng.generate("x", ctx + [3], num_new=6)
    _same(jeng.generate("x", ctx + [3], num_new=6), r)
    assert r.reused_tokens == 10
    for k in saved:
        for n in saved[k]:
            assert torch.equal(pay[k][n], saved[k][n]), (k, n)
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


def test_store_counts_kv_bytes_of_every_layer():
    """recurrentgemma-2b is not attention-free, so the store charges K/V for
    all 26 layers, 26·1·256·2·2 = 26,624 bytes per token, as the reference
    does, though only the 8 units hold a ring and the snapshot's size does
    not grow with the prompt (ROADMAP.md Queue 3)."""
    assert get_config(ARCH).kv_bytes_per_token == jget_config(ARCH).kv_bytes_per_token \
        == 26624
    jeng, teng = _engines()
    ctx = [int(t) for t in np.random.default_rng(2).integers(0, 512, 12)]
    _same(jeng.generate("a", ctx, num_new=2), teng.generate("a", ctx, num_new=2))
    e, je = teng.store.entries["a"], jeng.store.entries["a"]
    assert (e.num_tokens, e.size_bytes) == (je.num_tokens, je.size_bytes) \
        == (12, 12.0 * teng.cfg.kv_bytes_per_token)
    assert teng.cfg.kv_bytes_per_token == 4 * 1 * 32 * 2 * 2


def test_serve_demo_runs_on_cpu(capsys):
    """The --reduced demo keeps the reference's 2 layers: 0 units and 2 tail
    recurrent layers."""
    serve.main(["--real", "--arch", ARCH, "--device", "cpu", "--reduced"])
    out = capsys.readouterr().out
    assert "turn 2: computed 12 prefill tokens, reused 24" in out
    assert "cache hit verified" in out
    assert tt.griffin_layout(get_config(ARCH).reduced(num_layers=2)) == (0, 2)


# --------------------------------------------------------------------------- #
# 7. parameters: config, init, conversion
# --------------------------------------------------------------------------- #

def test_config_copy_matches_reference():
    for reduce in (False, True):
        a, b = jget_config(ARCH), get_config(ARCH)
        if reduce:
            a, b = a.reduced(num_layers=4, d_model=128), b.reduced(num_layers=4, d_model=128)
        for f in dataclasses.fields(b):
            assert getattr(a, f.name) == getattr(b, f.name), f.name
        assert (a.padded_vocab, a.kv_bytes_per_token) == (b.padded_vocab, b.kv_bytes_per_token)
        assert tt.griffin_layout(b) == jt.griffin_layout(a)
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads, full.head_dim,
            full.d_ff, full.vocab_size, full.rnn_width, full.conv_width,
            full.local_window) == (26, 2560, 10, 1, 256, 7680, 256000, 2560, 4, 2048)
    assert tt.griffin_layout(full) == (8, 2)
    small = get_config(ARCH).reduced(num_layers=4, d_model=128)
    assert (small.local_window, small.rnn_width) == (32, 128)
    assert get_config("yi-6b").reduced().rnn_width == 0


@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float32, torch.float32),
                                           (jnp.bfloat16, torch.bfloat16)])
def test_init_params_shapes_dtypes_and_scales(jdtype, tdtype):
    jcfg, tcfg = _cfgs(num_layers=4, d_model=128)
    jp = dict(_flat(jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(0), jcfg,
                                                            jdtype))))
    tp = dict(_flat(tt.init_params(torch.Generator().manual_seed(0), tcfg, tdtype)))
    assert set(jp) == set(tp)
    for path, leaf in jp.items():
        t = tp[path]
        assert tuple(t.shape) == leaf.shape, path
        want = torch.float32 if leaf.dtype == np.float32 else torch.bfloat16
        assert t.dtype == want, path
        if path[-1] in tgr.FP32_LEAVES:
            assert t.dtype == torch.float32, path
        # the draws differ: the scales agree to well inside a wrong scale's
        # factor (1/sqrt(d) against 1e-2 is 9x here)
        a, b = leaf.astype(np.float32), t.float()
        sd = float(a.std())
        assert abs(float(b.std()) - sd) <= 0.2 * sd + 1e-6, path
        assert abs(float(b.mean()) - float(a.mean())) <= 0.3 * sd + 1e-6, path
        assert float(b.min()) >= float(a.min()) - 4 * sd - 1e-6, path


def test_convert_keeps_fp32_leaves_at_bf16():
    """ba, bx and lam stay fp32 in a bf16 model; every leaf keeps its dtype
    and its exact values."""
    jcfg, tcfg = _cfgs(num_layers=4)
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
    assert fp32 == set(tgr.FP32_LEAVES)


def test_convert_takes_zero_units():
    """reduced(num_layers=2) stacks 0 units and 2 tail layers; conversion
    keeps the empty stack, and the model runs through the tail alone."""
    jcfg, jp, tcfg, tp = _models(num_layers=2, tdtype=torch.bfloat16, jdtype=jnp.bfloat16)
    assert tp["units"]["rec1"]["rg"]["wa"].shape == (0, 128, 128)
    assert tp["tail"]["rg"]["lam"].shape == (2, 128)
    assert tp["tail"]["rg"]["lam"].dtype == torch.float32
    jcfg, jp, tcfg, tp = _models(num_layers=2)
    toks = _tokens(jcfg, 12, seed=9)
    _close(jt.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, remat=False),
           tt.forward(tp, tcfg, {"tokens": T(toks).long()}), MODEL_TOL)


def test_convert_checks_the_layout():
    jcfg, tcfg = _cfgs(num_layers=4)
    jp = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32))
    with pytest.raises(ValueError, match="keys"):
        params_from_jax({k: v for k, v in jp.items() if k != "tail"}, tcfg, "cpu")
    with pytest.raises(ValueError, match="units"):
        params_from_jax(jp, dataclasses.replace(tcfg, num_layers=7), "cpu")
