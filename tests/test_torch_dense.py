"""The rest of the dense family and the long-context window mode of the
PyTorch port against the JAX package, on the CPU.

Configs: every arch the port registers is a copy of the reference's, full
and reduced. Models: llama3-8b, h2o-danube-1.8b, minitron-8b,
nemotron-4-15b and llama3-70b, reduced as ``tests/test_models_smoke.py``
reduces them (2 layers, d_model 256), with the JAX model's weights carried
through ``repro_torch.convert``; fp32, and the tolerances of the reference
tests they twin (5e-4 for decode against forward and for the long-context
mode, 1e-4 for the window) or of ``tests/test_torch_models.py`` (3e-4, the
port against the JAX package). Engines: h2o-danube-1.8b reduced, whose
turn-2 prompt passes the window of 64, against the JAX engine.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

from repro.configs import ALL_ARCHS as JALL_ARCHS
from repro.configs import get_config as jget_config
from repro.core.kvstore import KVStore as JKVStore
from repro.core.policies import POLICIES as JPOLICIES
from repro.models import transformer as jt
from repro.serving.realexec import RealExecutionEngine as JEngine
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.kvstore import KVStore
from repro_torch.core.policies import POLICIES
from repro_torch.kernels import cases
from repro_torch.launch import serve, shapes
from repro_torch.models import transformer as tt
from repro_torch.serving.realexec import RealExecutionEngine

NEW_DENSE = ("llama3-8b", "h2o-danube-1.8b", "minitron-8b", "nemotron-4-15b", "llama3-70b")
TOL = 3e-4
B, S = 2, 16                        # tests/test_models_smoke.py


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               torch.as_tensor(b).float().numpy(), atol=tol, rtol=tol)


def _models(arch, **changes):
    """(JAX config, JAX params, port config, port params): the arch reduced
    as the reference's smoke tests reduce it, with ``changes`` on both."""
    jcfg = dataclasses.replace(jget_config(arch).reduced(num_layers=2, d_model=256), **changes)
    tcfg = dataclasses.replace(get_config(arch).reduced(num_layers=2, d_model=256), **changes)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu", torch.float32)
    return jcfg, jp, tcfg, tp


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


# --------------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_copy_matches_reference(arch, reduce):
    a, b = jget_config(arch), get_config(arch)
    if reduce:
        a, b = a.reduced(num_layers=2, d_model=128), b.reduced(num_layers=2, d_model=128)
    ported = {f.name for f in dataclasses.fields(b)}
    for name in ported:
        assert getattr(a, name) == getattr(b, name), name
    assert (a.padded_vocab, a.kv_bytes_per_token, a.attn_free) == \
        (b.padded_vocab, b.kv_bytes_per_token, b.attn_free)
    assert b.long_context_window == (128 if reduce else 8192)
    if not reduce:        # what the port leaves out, the reference's config leaves at its default
        for f in dataclasses.fields(a):
            if f.name not in ported:
                assert getattr(a, f.name) == f.default, f.name


def test_registry_serves_the_dense_family():
    """The port's registry is the reference's: all twelve archs."""
    assert set(ALL_ARCHS) == set(JALL_ARCHS) == {
        "yi-6b", "rwkv6-1.6b", "recurrentgemma-2b", "llama3-8b", "h2o-danube-1.8b",
        "minitron-8b", "nemotron-4-15b", "llama3-70b", "dbrx-132b", "grok-1-314b",
        "qwen2-vl-2b", "seamless-m4t-large-v2"}
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("qwen2-vl-7b")


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("long_context", [False, True], ids=["short", "long"])
@pytest.mark.parametrize("arch", ["llama3-8b", "h2o-danube-1.8b"])
def test_attn_window_and_cache_width_match_reference(arch, long_context, reduce):
    a, b = jget_config(arch), get_config(arch)
    if reduce:
        a, b = a.reduced(), b.reduced()
    assert tt.attn_window(b, long_context) == jt.attn_window(a, long_context)
    for max_len in (16, 100, 4096, 5000, 20000):
        assert tt.cache_width(b, max_len, long_context) == \
            jt.cache_width(a, max_len, long_context)
    # at full width danube's 4096 wins over 8192; reduced the long window
    # (128) loses to danube's 64 as well
    want = {("llama3-8b", False): None, ("h2o-danube-1.8b", False): b.window_size,
            ("llama3-8b", True): b.long_context_window,
            ("h2o-danube-1.8b", True): b.window_size}
    assert tt.attn_window(b, long_context) == want[arch, long_context]


# --------------------------------------------------------------------------- #
# models: twins of tests/test_models_smoke.py
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", NEW_DENSE)
def test_prefill_decode_consistency(arch):
    """decode continuation matches teacher-forced forward, and the port
    matches the JAX package on prefill, decode and forward."""
    jcfg, jp, tcfg, tp = _models(arch)
    toks = _tokens(jcfg, (B, S))
    new = np.full((B, 1), 5, np.int32)
    jl, jcache = jt.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=32)
    tl, tcache = tt.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()}, max_len=32)
    _close(jl, tl)
    jlg, _ = jt.decode_step(jp, jcfg, jcache, jnp.asarray(new), jnp.asarray(S))
    tlg, _ = tt.decode_step(tp, tcfg, tcache, torch.from_numpy(new).long(), S)
    _close(jlg, tlg)
    full = tt.forward(tp, tcfg, {"tokens": torch.from_numpy(np.concatenate([toks, new], 1))
                                 .long()})
    np.testing.assert_allclose(tlg[:, 0].numpy(), full[:, -1].numpy(), atol=5e-4)


def test_sliding_window_limits_attention():
    """SWA arch: tokens beyond the window do not affect the output."""
    jcfg, jp, tcfg, tp = _models("h2o-danube-1.8b", window_size=8)
    toks = _tokens(jcfg, (1, 24))
    toks2 = toks.copy()
    toks2[:, 0] = (toks2[:, 0] + 1) % tcfg.vocab_size
    out1 = tt.forward(tp, tcfg, {"tokens": torch.from_numpy(toks).long()})
    out2 = tt.forward(tp, tcfg, {"tokens": torch.from_numpy(toks2).long()})
    np.testing.assert_allclose(out1[:, -1].numpy(), out2[:, -1].numpy(), atol=1e-4)
    assert float((out1[:, 0] - out2[:, 0]).abs().max()) > 1e-3   # position 0 itself moves
    _close(jt.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, remat=False), out1)


@pytest.mark.parametrize("arch", NEW_DENSE)
def test_cache_width_ring_buffer_decode(arch):
    """long-context mode: dense decode uses a ring buffer of window size."""
    jcfg = jget_config(arch).reduced(num_layers=2, d_model=256)
    tcfg = get_config(arch).reduced(num_layers=2, d_model=256)
    cache = tt.init_cache(tcfg, 1, max_len=1024, dtype=torch.float32, device="cpu",
                          long_context=True)
    jcache = jt.init_cache(jcfg, 1, max_len=1024, dtype=jnp.float32, long_context=True)
    assert tuple(cache["k"].shape) == tuple(jcache["k"].shape)
    assert cache["k"].shape[2] == min(tcfg.long_context_window,
                                      tcfg.window_size or tcfg.long_context_window)
    short = tt.init_cache(tcfg, 1, max_len=1024, dtype=torch.float32, device="cpu")
    assert short["k"].shape[2] == (tcfg.window_size or 1024)


# --------------------------------------------------------------------------- #
# the long-context mode against the reference, the ring wrapped
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch,heads", [
    ("llama3-8b", None),            # reduced: 4/4 heads, G = 1
    ("llama3-8b", (6, 1)),          # G = 6, as nemotron-4-15b's 48/8
    ("llama3-8b", (8, 2)),          # G = 4, as llama3-8b's 32/8
    ("h2o-danube-1.8b", (8, 2)),    # its window (64) under the long one (128)
])
def test_long_context_prefill_and_decode_match_reference(arch, heads):
    changes = {} if heads is None else dict(num_heads=heads[0], num_kv_heads=heads[1])
    jcfg, jp, tcfg, tp = _models(arch, **changes)
    n, max_len = 150, 192                          # past the ring of 128 (64 for danube)
    toks = _tokens(jcfg, (1, n + 3), seed=1)
    jl, jc = jt.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :n])}, max_len,
                        long_context=True)
    tl, tc = tt.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :n]).long()}, max_len,
                        long_context=True)
    W = tt.cache_width(tcfg, max_len, long_context=True)
    assert tc["k"].shape[2] == W < n
    _close(jl, tl, 5e-4)
    _close(jc["k"], tc["k"], 5e-4)
    for pos in range(n, n + 3):                    # decode over the wrapped ring
        tok = toks[:, pos:pos + 1]
        jlg, jc = jt.decode_step(jp, jcfg, jc, jnp.asarray(tok), jnp.asarray(pos),
                                 long_context=True)
        tlg, tc = tt.decode_step(tp, tcfg, tc, torch.from_numpy(tok).long(), pos,
                                 long_context=True)
        _close(jlg, tlg, 5e-4)
    full = tt.forward(tp, tcfg, {"tokens": torch.from_numpy(toks).long()}, long_context=True)
    np.testing.assert_allclose(tlg[:, 0].numpy(), full[:, -1].numpy(), atol=5e-4)
    # without the flag the window is the config's own, and the answer differs
    plain = tt.forward(tp, tcfg, {"tokens": torch.from_numpy(toks).long()})
    if tt.attn_window(tcfg) != tt.attn_window(tcfg, True):
        assert float((plain[:, -1] - full[:, -1]).abs().max()) > 1e-3


def test_griffin_and_rwkv_ignore_the_flag():
    """The hybrid branch keeps its local window and the ssm branch has no
    window, with or without ``long_context``, as in the reference."""
    cfg = get_config("recurrentgemma-2b").reduced(num_layers=4, d_model=128)
    assert jt.init_cache(jget_config("recurrentgemma-2b").reduced(num_layers=4, d_model=128),
                         1, 256, long_context=True)["units"]["k"].shape[2] == \
        tt.init_cache(cfg, 1, 256, device="cpu", long_context=True)["units"]["k"].shape[2] \
        == cfg.local_window
    p = tt.init_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    toks = torch.from_numpy(_tokens(cfg, (1, 40))).long()
    assert torch.equal(tt.forward(p, cfg, {"tokens": toks}),
                       tt.forward(p, cfg, {"tokens": toks}, long_context=True))
    rcfg = get_config("rwkv6-1.6b").reduced(num_layers=2, d_model=128)
    assert {k: v.shape for k, v in tt.init_cache(rcfg, 1, 64, device="cpu").items()} == \
        {k: v.shape for k, v in tt.init_cache(rcfg, 1, 64, device="cpu",
                                                long_context=True).items()}


@pytest.mark.parametrize("arch", ["minitron-8b", "nemotron-4-15b"])
def test_non_gated_mlp_converts(arch):
    *_, tcfg, tp = _models(arch)
    assert not tcfg.gated_mlp and tcfg.activation == "relu2"
    assert set(tp["layers"]["mlp"]) == {"w_up", "w_down"}


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #

def test_multi_turn_reuse_past_the_window_matches_jax_engine():
    """h2o-danube-1.8b reduced (window 64, ring 64): turn 2's prompt of 72
    passes the window, so its suffix prefill masks keys and its decode reads
    a wrapped ring; the port and the JAX engine give the same greedy tokens
    and reuse counts, and a cold engine the same tokens."""
    jcfg = jget_config("h2o-danube-1.8b").reduced(num_layers=2, d_model=128)
    cfg = get_config("h2o-danube-1.8b").reduced(num_layers=2, d_model=128)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu", torch.float32)

    def engine():
        return RealExecutionEngine(cfg, tp, KVStore(64e6, POLICIES["lcs"],
                                                    cfg.kv_bytes_per_token),
                                   max_len=128, dtype=torch.float32, device="cpu")
    jeng = JEngine(jcfg, jp, JKVStore(64e6, JPOLICIES["lcs"], jcfg.kv_bytes_per_token),
                   max_len=128)
    teng = engine()
    assert teng.width == cfg.window_size == 64
    rng = np.random.default_rng(1)
    ctx = [int(t) for t in rng.integers(0, cfg.vocab_size, 48)]
    extra = [int(t) for t in rng.integers(0, cfg.vocab_size, 20)]
    def turn(prompt):
        j, t = jeng.generate("c", prompt, num_new=4), teng.generate("c", prompt, num_new=4)
        assert (t.tokens, t.reused_tokens, t.prefill_tokens_computed) == \
            (j.tokens, j.reused_tokens, j.prefill_tokens_computed)
        return t

    t1 = turn(ctx)
    ctx2 = ctx + t1.tokens + extra
    assert len(ctx2) > cfg.window_size
    t = turn(ctx2)
    assert (t1.reused_tokens, t.reused_tokens, t.prefill_tokens_computed) == (0, 48, 24)
    cold = engine().generate("other", ctx2, num_new=4)
    assert cold.reused_tokens == 0 and cold.tokens == t.tokens
    np.testing.assert_allclose(cold.last_logits.numpy(), t.last_logits.numpy(), atol=TOL)


@pytest.mark.parametrize("arch", NEW_DENSE)
def test_serve_demo_runs_each_dense_arch_on_cpu(arch, capsys):
    serve.main(["--real", "--arch", arch, "--device", "cpu", "--reduced"])
    out = capsys.readouterr().out
    assert "turn 2: computed 12 prefill tokens, reused 24" in out
    assert "cache hit verified" in out


def test_llama3_70b_does_not_fit_one_card():
    assert "llama3-70b" not in serve.FULL_TURNS
    assert 140e9 < serve.weight_bytes(get_config("llama3-70b")) < 142e9
    with pytest.raises(ValueError, match=r"141\.1 GB .* 80 GB"):
        serve.build_engine("llama3-70b", device="cpu")


def test_engine_takes_no_long_context_option():
    """The reference's engine never passes the flag, so the port's has none."""
    import inspect
    for fn in (RealExecutionEngine.__init__, RealExecutionEngine.generate,
               JEngine.__init__, JEngine.generate):
        assert "long_context" not in inspect.signature(fn).parameters


@pytest.mark.parametrize("arch,layers", [("minitron-8b", 2), ("rwkv6-1.6b", 3),
                                         ("recurrentgemma-2b", 5)])
def test_weight_bytes_counts_init_params(arch, layers):
    """The bytes and the largest leaf of ``init_params``'s weights, the fp32
    leaves (RWKV6's ``FP32_LEAVES``, Griffin's ``ba``, ``bx``, ``lam``) in
    fp32; recurrentgemma-2b at 5 layers is one unit and two tail layers."""
    cfg = get_config(arch).reduced(num_layers=layers, d_model=128)
    p = tt.init_params(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    leaves = [p]
    n = largest = 0
    while leaves:
        x = leaves.pop()
        if isinstance(x, dict):
            leaves.extend(x.values())
        else:
            n += x.numel() * x.element_size()
            largest = max(largest, x.numel())
    assert serve.weight_bytes(cfg) == n
    assert serve._param_counts(cfg)[2] == largest


@pytest.mark.parametrize("arch,elements,fp32", [("rwkv6-1.6b", 1_599_719_424, 442_368),
                                                ("recurrentgemma-2b", 3_549_934_080, 138_240)])
def test_param_counts_of_the_recurrent_archs_at_full_width(arch, elements, fp32):
    """The elements ``init_params`` draws at the published widths (counted
    once on the CPU), of them the fp32 leaves: 24 x 9 x 2,048 for RWKV6's
    mixes, decay base, bonus and channel-mix shifts, 18 x 3 x 2,560 for
    Griffin's ba, bx and lam."""
    n, f, _ = serve._param_counts(get_config(arch))
    assert (n + f, f) == (elements, fp32)
    assert serve.weight_bytes(get_config(arch)) == 2 * n + 4 * f


# --------------------------------------------------------------------------- #
# the card's rows: repro_torch.launch.shapes computes them from the configs
# and turns
# --------------------------------------------------------------------------- #

def test_dense_kernel_rows_follow_the_configs_and_turns():
    flash, decode, identity = shapes.dense_shapes()
    # every call of each conversation, each shape once (llama3-8b's and
    # minitron-8b's are one, and so are nemotron-4-15b's and the MoE archs'),
    # then the long-context phase's
    calls = ("turn 1", "turn 2", "cold")
    assert list(flash) == (
        [f"llama3-8b {c}, minitron-8b {c}" for c in calls]
        + [f"h2o-danube-1.8b {c}" for c in calls]
        + [f"nemotron-4-15b {c}, dbrx-132b {c}, grok-1-314b {c}" for c in calls]
        + [f"llama3-70b {c}" for c in calls]
        + [f"llama3-8b long context {c}" for c in ("prefill", "forward", "rows 9216-")])
    assert list(decode) == ["llama3-8b turn 2, minitron-8b turn 2", "h2o-danube-1.8b turn 2",
                            "nemotron-4-15b turn 2, dbrx-132b turn 2, grok-1-314b turn 2",
                            "llama3-70b turn 2", "llama3-8b long context step"]
    # danube: turn 1 inside the window, the cold prefill past it, its ring
    # of 4,096 full and wrapped at the last step; G = 6 for nemotron-4-15b
    assert flash["h2o-danube-1.8b turn 1"] == (1, 32, 8, 3584, 3584, 80, 0, 4096, True)
    assert flash["h2o-danube-1.8b cold"] == (1, 32, 8, 4608, 4608, 80, 0, 4096, True)
    assert decode["h2o-danube-1.8b turn 2"] == (1, 32, 8, 4096, 80, 4096, 520)
    assert flash["nemotron-4-15b turn 2, dbrx-132b turn 2, grok-1-314b turn 2"] == \
        (1, 48, 8, 512, 2560, 128, 2048, None, True)
    # the long-context step reads a full, wrapped ring of 8,192
    assert flash["llama3-8b long context prefill"] == (1, 32, 8, 10240, 10240, 128, 0,
                                                       8192, True)
    assert decode["llama3-8b long context step"] == (1, 32, 8, 8192, 128, 8192, 2049)
    # each identity pair: a cold prefill and the hit call on its last rows,
    # which is itself a row
    assert len(identity) == 5
    for cold, first in identity:
        assert cold[3] == cold[4] > first and cold[6] == 0
        hit = cold[:3] + (cold[3] - first, cold[4], cold[5], first) + cold[7:]
        assert cold in flash.values() and hit in flash.values()
    assert (flash["h2o-danube-1.8b cold"], 3584) in identity
    # yi-6b's and recurrentgemma-2b's decode shapes are cases.DECODE_MAIN
    _, yi = shapes.main_path_shapes(get_config("yi-6b"))
    assert [yi["turn 2"], shapes.griffin_decode_shape(
        get_config("recurrentgemma-2b"))] == cases.DECODE_MAIN
