"""The MoE family of the PyTorch port (dbrx-132b, grok-1-314b) against the
JAX package, on the CPU.

Module: twins of ``tests/test_moe.py``, each also holding the port's
``moe_ffn`` against the reference's on the same input: ``y`` at 1e-5
(fp32), ``load_balance_loss`` and ``router_z_loss`` at rtol 1e-5,
``dropped_frac`` at an absolute 1e-6 (the reference reads -2.98e-08 where
nothing drops), and the drop set element for element. Inputs are drawn
with numpy from a seed; weights are the reference's, carried through
``repro_torch.convert.params_from_jax``.

Models: twins of ``tests/test_models_smoke.py`` for both archs reduced as
it reduces them (2 layers, d_model 256, 4 experts top-2), the port against
the JAX package at 3e-4 (``tests/test_torch_models.py``) and decode against
``forward`` at 5e-4. Engines: the reduced demo (2 layers, d_model 128) on
the reference's conversation against the JAX engine.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

from repro.configs import get_config as jget_config
from repro.core.kvstore import KVStore as JKVStore
from repro.core.policies import POLICIES as JPOLICIES
from repro.models import moe as jm
from repro.models import transformer as jt
from repro.serving.realexec import RealExecutionEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.kvstore import KVStore
from repro_torch.core.policies import POLICIES
from repro_torch.launch import serve, shapes
from repro_torch.models import moe as tm
from repro_torch.models import transformer as tt
from repro_torch.serving.realexec import RealExecutionEngine

MOE = ("dbrx-132b", "grok-1-314b")
TOL = 3e-4
B, S = 2, 16                        # tests/test_models_smoke.py


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               torch.as_tensor(b).float().numpy(), atol=tol, rtol=tol)


def _cfgs(arch, cf, **reduce):
    """(JAX config, port config) of ``arch`` reduced, at capacity factor ``cf``."""
    return (dataclasses.replace(jget_config(arch).reduced(**reduce), moe_capacity_factor=cf),
            dataclasses.replace(get_config(arch).reduced(**reduce), moe_capacity_factor=cf))


def _models(jcfg, tcfg, dtype=torch.float32):
    """The reference's weights (PRNGKey 0) and the port's copy of them."""
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu", dtype)


def _moe_weights(jcfg, tcfg):
    """Layer 0's ``moe`` weights on both sides."""
    jp, tp = _models(jcfg, tcfg)
    return (jax.tree.map(lambda a: a[0], jp["layers"]["moe"]),
            tt.layer_params(tp["layers"], 0)["moe"])


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(shape + (cfg.d_model,)
                                                        ).astype(np.float32)


def _activation(name, h):
    if name == "silu":
        return h / (1 + np.exp(-h))
    # jax.nn.gelu's default, the tanh form
    return 0.5 * h * (1 + np.tanh(np.sqrt(2 / np.pi) * (h + 0.044715 * h ** 3)))


def _reference_keep(jcfg, jw, x, y_ref):
    """The reference's drop set, read from its output: each token's ``y`` is
    the gate-weighted sum of the expert outputs of the slots it kept, so of
    the ``2**K`` subsets of its slots exactly one sums to ``y``. The slots'
    experts, gates and outputs are computed in numpy (fp64)."""
    K = jcfg.experts_per_token
    w = {k: np.asarray(v, np.float64) for k, v in jw.items()}
    xt = x.reshape(-1, jcfg.d_model).astype(np.float64)
    logits = xt @ w["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top_e = np.argsort(-probs, axis=-1, kind="stable")[:, :K]
    top_p = np.take_along_axis(probs, top_e, -1)
    top_p /= top_p.sum(-1, keepdims=True)
    keep = np.zeros(top_e.shape, bool)
    for t, y_t in enumerate(np.asarray(y_ref, np.float64).reshape(xt.shape)):
        contrib = []
        for k, e in enumerate(top_e[t]):
            h = _activation(jcfg.activation, xt[t] @ w["w_up"][e]) * (xt[t] @ w["w_gate"][e])
            contrib.append(top_p[t, k] * (h @ w["w_down"][e]))
        subsets = list(itertools.product((False, True), repeat=K))
        dist = [np.abs(y_t - sum((c for c, m in zip(contrib, sub) if m),
                                 np.zeros_like(y_t))).max() for sub in subsets]
        best, second = np.sort(dist)[:2]
        assert best < 1e-4 < second, (t, dist)          # one subset, and only one
        keep[t] = subsets[int(np.argmin(dist))]
    return keep


def _ffn_both(arch, cf, shape, seed):
    """(port config, port weights, x, port (y, aux), reference (y, aux))."""
    jcfg, tcfg = _cfgs(arch, cf)
    jw, tw = _moe_weights(jcfg, tcfg)
    x = _x(jcfg, shape, seed)
    jy, jaux = jm.moe_ffn(jw, jnp.asarray(x), jcfg)
    ty, taux = tm.moe_ffn(tw, torch.from_numpy(x), tcfg)
    return jcfg, tcfg, jw, tw, x, (ty, taux), (jy, jaux)


def _hold_to_reference(tcfg, tw, x, port, ref, jcfg, jw):
    """y at 1e-5, the two losses at rtol 1e-5, dropped_frac at abs 1e-6,
    and the port's drop set equal to the reference's."""
    (ty, taux), (jy, jaux) = port, ref
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    for name in ("load_balance_loss", "router_z_loss"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]), rtol=1e-5)
    assert abs(float(taux["dropped_frac"]) - float(jaux["dropped_frac"])) <= 1e-6
    T = x.shape[0] * x.shape[1]
    _, _, _, top_e = tm._route(tw, torch.from_numpy(x).reshape(T, -1),
                               tcfg.experts_per_token)
    keep = tm.dispatch(tcfg, top_e, T)[2].reshape(T, -1).numpy()
    np.testing.assert_array_equal(keep, _reference_keep(jcfg, jw, x, jy))
    return keep


# --------------------------------------------------------------------------- #
# the module: twins of tests/test_moe.py
# --------------------------------------------------------------------------- #

def test_dispatch_matches_dense_oracle_no_drops():
    jcfg, tcfg, jw, tw, x, port, ref = _ffn_both("dbrx-132b", 16.0, (2, 8), 1)
    assert abs(float(port[1]["dropped_frac"])) <= 1e-6
    np.testing.assert_allclose(port[0].numpy(),
                               tm.moe_ffn_ref(tw, torch.from_numpy(x), tcfg).numpy(), atol=1e-5)
    assert _hold_to_reference(tcfg, tw, x, port, ref, jcfg, jw).all()


def test_capacity_drops_tokens_gracefully():
    """At capacity factor 0.25 (C = 8 for 64 tokens and 4 experts) most
    assignments drop; the port drops exactly the reference's."""
    jcfg, tcfg, jw, tw, x, port, ref = _ffn_both("dbrx-132b", 0.25, (4, 16), 1)
    assert float(port[1]["dropped_frac"]) > 0.0
    assert not bool(torch.isnan(port[0]).any())
    keep = _hold_to_reference(tcfg, tw, x, port, ref, jcfg, jw)
    assert 0 < keep.sum() < keep.size
    # an expert keeps its first C assignments in (token, slot) order
    assert keep.sum() == tcfg.num_experts * tm.moe_capacity(tcfg, keep.shape[0])


def test_load_balance_loss_bounds():
    jcfg, tcfg, jw, tw, x, port, ref = _ffn_both("dbrx-132b", 8.0, (2, 32), 2)
    lb = float(port[1]["load_balance_loss"])
    assert lb >= 0.99  # E * sum(me*ce) >= 1 by Cauchy-Schwarz at balance
    assert lb < float(tcfg.num_experts)
    _hold_to_reference(tcfg, tw, x, port, ref, jcfg, jw)


@pytest.mark.parametrize("cf", [0.25, 1.25, 4.0])
def test_capacity_formula(cf):
    jcfg, tcfg = _cfgs("dbrx-132b", cf)
    for T in (1, 7, 36, 512, 1024, 2560):
        c = tm.moe_capacity(tcfg, T)
        assert c == jm.moe_capacity(jcfg, T)
        assert c >= cf * T * tcfg.experts_per_token / tcfg.num_experts
        assert c % 8 == 0 and c >= 8
    # at E/K every token fits: C >= T
    full = dataclasses.replace(get_config("grok-1-314b"), moe_capacity_factor=4.0)
    assert all(tm.moe_capacity(full, T) >= T for T in (1, 512, 2560))


def test_grok_top2_routing_weights_normalized():
    jcfg, tcfg, jw, tw, x, port, ref = _ffn_both("grok-1-314b", 16.0, (1, 8), 3)
    np.testing.assert_allclose(port[0].numpy(),
                               tm.moe_ffn_ref(tw, torch.from_numpy(x), tcfg).numpy(), atol=1e-5)
    _hold_to_reference(tcfg, tw, x, port, ref, jcfg, jw)
    # gelu is the tanh form, as jax.nn.gelu's default: the exact form differs
    exact = tm.moe_ffn(tw, torch.from_numpy(x), dataclasses.replace(tcfg, activation="silu"))
    assert float((exact[0] - port[0]).abs().max()) > 1e-3


def test_router_stays_fp32_in_a_bf16_model():
    jcfg, tcfg = _cfgs("grok-1-314b", 1.25)
    _, tp = _models(jcfg, tcfg, torch.bfloat16)
    m = tp["layers"]["moe"]
    assert m["router"].dtype == torch.float32
    assert {m[k].dtype for k in ("w_up", "w_gate", "w_down")} == {torch.bfloat16}
    own = tt.init_params(torch.Generator().manual_seed(0), tcfg, torch.bfloat16)
    assert {k: (v.dtype, v.shape) for k, v in own["layers"]["moe"].items()} == \
        {k: (v.dtype, v.shape) for k, v in m.items()}
    assert "mlp" not in own["layers"]


# --------------------------------------------------------------------------- #
# the models: twins of tests/test_models_smoke.py
# --------------------------------------------------------------------------- #

def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("arch", MOE)
def test_forward_shapes_no_nan(arch):
    """At the published capacity, with the aux values, each the mean over
    layers, against the reference's."""
    jcfg, tcfg = _cfgs(arch, 1.25, num_layers=2, d_model=256)
    jp, tp = _models(jcfg, tcfg)
    toks = _tokens(jcfg, (B, S))
    logits, aux = tt.forward(tp, tcfg, {"tokens": torch.from_numpy(toks).long()},
                             with_aux=True)
    assert logits.shape == (B, S, tcfg.padded_vocab)
    assert not bool(torch.isnan(logits).any())
    jlogits, jaux = jt.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, remat=False,
                               with_aux=True)
    _close(jlogits, logits)
    assert set(aux) == set(jaux) == {"load_balance_loss", "router_z_loss", "dropped_frac"}
    for name in ("load_balance_loss", "router_z_loss"):
        np.testing.assert_allclose(float(aux[name]), float(jaux[name]), rtol=1e-5)
    assert abs(float(aux["dropped_frac"]) - float(jaux["dropped_frac"])) <= 1e-6
    # the other families return no aux, as the reference's
    ycfg = get_config("yi-6b").reduced(num_layers=2, d_model=128)
    yp = tt.init_params(torch.Generator().manual_seed(0), ycfg, torch.float32)
    assert tt.forward(yp, ycfg, {"tokens": torch.from_numpy(toks).long()},
                      with_aux=True)[1] == {}


@pytest.mark.parametrize("cf", [1.25, None], ids=["published", "no-drop"])
@pytest.mark.parametrize("arch", MOE)
def test_prefill_decode_consistency(arch, cf):
    """The port against the JAX package on prefill, decode and forward; and
    decode continuation against teacher-forced forward at 5e-4 where nothing
    drops (capacity factor E/K). At the published capacity the reference's
    own decode and forward differ: the 32-token prefill and the 34-token
    forward drop other assignments (``test_hit_and_cold_differ_at_the_published_capacity``)."""
    cf = cf or get_config(arch).num_experts / get_config(arch).experts_per_token
    jcfg, tcfg = _cfgs(arch, cf, num_layers=2, d_model=256)
    jp, tp = _models(jcfg, tcfg)
    toks = _tokens(jcfg, (B, S))
    new = np.full((B, 1), 5, np.int32)
    jl, jcache = jt.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=32)
    tl, tcache = tt.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()}, max_len=32)
    _close(jl, tl)
    jlg, _ = jt.decode_step(jp, jcfg, jcache, jnp.asarray(new), jnp.asarray(S))
    tlg, _ = tt.decode_step(tp, tcfg, tcache, torch.from_numpy(new).long(), S)
    _close(jlg, tlg)
    both = np.concatenate([toks, new], 1)
    full = tt.forward(tp, tcfg, {"tokens": torch.from_numpy(both).long()})
    _close(jt.forward(jp, jcfg, {"tokens": jnp.asarray(both)}, remat=False), full)
    gap = float((tlg[:, 0] - full[:, -1]).abs().max())
    if cf == 1.25:
        assert gap > 5e-4
    else:
        assert gap <= 5e-4


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #

def _engines(arch, cf=1.25):
    """The port's reduced demo engine and the JAX engine on the same weights."""
    jcfg, tcfg = _cfgs(arch, cf, num_layers=2, d_model=128)
    jp, tp = _models(jcfg, tcfg)
    max_len = serve.REDUCED_TURNS[3]
    jeng = JEngine(jcfg, jp, JKVStore(64e6, JPOLICIES["lcs"], jcfg.kv_bytes_per_token),
                   max_len=max_len)

    def engine():
        return RealExecutionEngine(tcfg, tp, KVStore(64e6, POLICIES["lcs"],
                                                     tcfg.kv_bytes_per_token),
                                   max_len=max_len, dtype=torch.float32, device="cpu")
    return tcfg, jeng, engine


def _turns(eng, cfg):
    """Turn 1, turn 2 and a cold run of the turn-2 prompt on ``eng``, on the
    reduced demo's conversation (24 + 4 + 8)."""
    ctx, extra, num_new = serve.conversation(cfg, True)
    r1 = eng.generate("c", ctx, num_new=num_new)
    ctx2 = ctx + r1.tokens + extra
    return r1, eng.generate("c", ctx2, num_new=num_new), eng.generate("cold", ctx2,
                                                                       num_new=num_new)


@pytest.mark.parametrize("arch", MOE)
def test_multi_turn_reuse_matches_jax_engine(arch):
    cfg, jeng, engine = _engines(arch)
    got = [(r.tokens, r.reused_tokens, r.prefill_tokens_computed)
           for r in _turns(engine(), cfg)]
    want = [(r.tokens, r.reused_tokens, r.prefill_tokens_computed) for r in _turns(jeng, cfg)]
    assert got == want
    assert [g[1:] for g in got] == [(0, 24), (24, 12), (0, 36)]


def test_hit_and_cold_differ_at_the_published_capacity():
    """A standing divergence, in the reference too: capacity is a function
    of a call's token count and drops follow the order of the call's
    tokens, so grok-1-314b's 12-token hit prefill and the cold 36-token
    prefill drop other assignments and decode other tokens, in the JAX
    engine and in the port alike. At capacity factor E/K nothing drops and
    the port's hit equals its cold run."""
    cfg, jeng, engine = _engines("grok-1-314b")
    _, j2, jc = _turns(jeng, cfg)
    _, t2, tc = _turns(engine(), cfg)
    assert j2.tokens != jc.tokens and t2.tokens != tc.tokens
    assert (t2.tokens, tc.tokens) == (j2.tokens, jc.tokens)
    cfg, _, engine = _engines("grok-1-314b", cf=4.0)
    _, t2, tc = _turns(engine(), cfg)
    assert t2.tokens == tc.tokens
    np.testing.assert_allclose(t2.last_logits.numpy(), tc.last_logits.numpy(), atol=TOL)


@pytest.mark.parametrize("arch", MOE)
def test_serve_demo_runs_each_moe_arch_on_cpu(arch, capsys):
    serve.main(["--real", "--arch", arch, "--device", "cpu", "--reduced"])
    out = capsys.readouterr().out
    assert "turn 2: computed 12 prefill tokens, reused 24" in out
    assert "cache hit verified" in out


@pytest.mark.parametrize("arch,gb,depth,cut_gb", [("dbrx-132b", 263.2, 8, 54.6),
                                                  ("grok-1-314b", 633.0, 5, 52.4)])
def test_full_width_is_served_with_the_depth_cut(arch, gb, depth, cut_gb, capsys,
                                                 monkeypatch):
    """``build_engine`` at full width serves every published width with the
    depth cut, and logs both depths and weight sizes (the weights are not
    drawn here: ``init_params`` stands in with an empty embedding)."""
    full = get_config(arch)
    assert round(serve.weight_bytes(full) / 1e9, 1) == gb
    drawn = []

    def init_params(gen, cfg, dtype):
        drawn.append(cfg)
        return {"embed": torch.empty(0, dtype=dtype)}
    monkeypatch.setattr(serve, "init_params", init_params)
    cfg, eng = serve.build_engine(arch, device="cpu")
    assert cfg == drawn[0] == eng.cfg == dataclasses.replace(full, num_layers=depth)
    assert depth == serve.FULL_DEPTH[arch] and eng.dtype == torch.bfloat16
    assert round(serve.weight_bytes(cfg) / 1e9, 1) == cut_gb < serve.CARD_BYTES / 1e9
    out = capsys.readouterr().out
    assert f"published depth {full.num_layers} layers ({gb} GB" in out
    assert f"serving {depth} layers ({cut_gb} GB)" in out
    assert serve.turns(arch, False) == serve.FULL_TURNS["nemotron-4-15b"]
    assert serve.build_engine(arch, device="cpu", reduced=True)[0].num_layers == 2
    # an engine over the same weights at another capacity draws and logs nothing
    nodrop, _ = serve.build_engine(arch, device="cpu", params=eng.params,
                                   moe_capacity_factor=4.0)
    assert nodrop == dataclasses.replace(cfg, moe_capacity_factor=4.0) and len(drawn) == 2
    assert "published depth" not in capsys.readouterr().out


def test_weight_bytes_counts_moe_init_params():
    cfg = get_config("grok-1-314b").reduced(num_layers=2, d_model=128)
    p = tt.init_params(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    leaves, n = [p], 0
    while leaves:
        x = leaves.pop()
        if isinstance(x, dict):
            leaves.extend(x.values())
        else:
            n += x.numel() * x.element_size()
    assert serve.weight_bytes(cfg) == n


def test_moe_kernel_rows_are_nemotrons():
    """Both MoE archs have nemotron-4-15b's attention and conversation, so
    their flash and decode calls are its calls, held once on the card."""
    nemotron = shapes.main_path_shapes(get_config("nemotron-4-15b"))
    for arch in MOE:
        assert shapes.main_path_shapes(get_config(arch)) == nemotron
    flash, decode, _ = shapes.dense_shapes()
    for call, case in nemotron[0].items():
        label = ", ".join(f"{a} {call}" for a in ("nemotron-4-15b",) + MOE)
        assert flash[label] == case
    assert decode[", ".join(f"{a} turn 2" for a in ("nemotron-4-15b",) + MOE)] == \
        nemotron[1]["turn 2"]
