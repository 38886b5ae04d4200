"""seamless-m4t-large-v2 (``encdec``) in the PyTorch port against the JAX
package, on the CPU.

The encoder (bidirectional), the decoder's self- and cross-attention, the
four tensors of the cache, ``forward``/``prefill``/``decode_step``, twins of
``tests/test_models_smoke.py``, the standing divergence of the engines (the
reference's fails on enc-dec, the port's refuses it) and the multiarch
twin's run. Models are ``reduced(num_layers=2, d_model=256)`` as the
reference's smoke tests reduce them (1 encoder layer, 16 frames, 4/4 heads
of 64), fp32, the JAX model's weights through ``repro_torch.convert``.
Tolerances: ``test_torch_models.TOL`` (3e-4), and the reference's 5e-4
where a decode step is held against ``forward``.
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
from repro.models import transformer as jt
from repro.serving.realexec import RealExecutionEngine as JEngine
from repro.train.data import make_batch_for
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.kvstore import KVStore
from repro_torch.core.policies import POLICIES
from repro_torch.kernels import ops
from repro_torch.launch import multiarch, serve, shapes
from repro_torch.models import transformer as tt
from repro_torch.serving.realexec import RealExecutionEngine

ARCH = "seamless-m4t-large-v2"
TOL = 3e-4                          # tests/test_torch_models.py
STEP_TOL = 5e-4                     # test_models_smoke.py::test_prefill_decode_consistency
B, S = 2, 16                        # tests/test_models_smoke.py
T = torch.from_numpy


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               torch.as_tensor(b).float().numpy(), atol=tol, rtol=tol)


def _models(num_layers=2, d_model=256, **changes):
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(num_layers=num_layers,
                                                         d_model=d_model), **changes)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(num_layers=num_layers,
                                                        d_model=d_model), **changes)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu", torch.float32)
    return jcfg, jp, tcfg, tp


def _batch(cfg, n, batch=B, seed=0):
    """numpy tokens (batch, n) and frames (batch, source_len, d) at 0.02, as
    ``repro.train.data.make_batch_for`` draws them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, n)).astype(np.int32)
    out = make_batch_for(cfg, toks, toks)
    out.pop("labels")
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    out = {k: T(np.ascontiguousarray(v)) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


def _counted(fn):
    """(fn(), flash and decode calls it made through ``ops``) on the CPU,
    where the wrappers run their plain versions and count no launch."""
    real = ops.flash_attention, ops.decode_attention
    calls = {"flash": 0, "decode": 0}

    def flash(*a, **kw):
        calls["flash"] += 1
        return real[0](*a, **kw)

    def decode(*a, **kw):
        calls["decode"] += 1
        return real[1](*a, **kw)

    ops.flash_attention, ops.decode_attention = flash, decode
    try:
        return fn(), calls
    finally:
        ops.flash_attention, ops.decode_attention = real


# --------------------------------------------------------------------------- #
# the model functions
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("enc_layers", [1, 2])
def test_forward_matches(enc_layers):
    jcfg, jp, tcfg, tp = _models(encoder_layers=enc_layers)
    batch = _batch(jcfg, 12)
    got, calls = _counted(lambda: tt.forward(tp, tcfg, _torch(batch)))
    _close(jt.forward(jp, jcfg, _jax(batch), remat=False), got)
    # per encoder layer one bidirectional call; per decoder layer self + cross
    assert calls == {"flash": enc_layers + 2 * tcfg.num_layers, "decode": 0}


def test_prefill_and_its_cache_match():
    jcfg, jp, tcfg, tp = _models()
    batch = _batch(jcfg, 12)
    jl, jcache = jt.prefill(jp, jcfg, _jax(batch), max_len=32)
    tl, tcache = tt.prefill(tp, tcfg, _torch(batch), max_len=32)
    _close(jl, tl)
    assert set(tcache) == {"self_k", "self_v", "cross_k", "cross_v"}
    for name in tcache:
        assert tuple(tcache[name].shape) == jcache[name].shape, name
        _close(jcache[name], tcache[name])
    # init_cache lays the cache out as prefill returns it
    empty = tt.init_cache(tcfg, B, 32, torch.float32, "cpu")
    assert {k: v.shape for k, v in empty.items()} == {k: v.shape for k, v in tcache.items()}
    assert {k: tuple(v.shape) for k, v in empty.items()} == \
        {k: v.shape for k, v in jt.init_cache(jcfg, B, 32, jnp.float32).items()}


def test_decode_steps_match_and_leave_the_cross_cache():
    """Steps past the prompt: the port against the JAX package at each step
    and on the self ring; the cross cache is read, never written; the last
    step against ``forward`` at the reference's 5e-4."""
    jcfg, jp, tcfg, tp = _models()
    batch = _batch(jcfg, 12 + 4)
    pre = dict(batch, tokens=batch["tokens"][:, :12])
    _, jcache = jt.prefill(jp, jcfg, _jax(pre), max_len=32)
    _, tcache = tt.prefill(tp, tcfg, _torch(pre), max_len=32)
    cross = {k: tcache[k].clone() for k in ("cross_k", "cross_v")}
    for i in range(4):
        tok = batch["tokens"][:, 12 + i:13 + i]
        jl, jcache = jt.decode_step(jp, jcfg, jcache, jnp.asarray(tok), jnp.asarray(12 + i))
        (tl, tcache), calls = _counted(
            lambda: tt.decode_step(tp, tcfg, tcache, T(tok).long(), 12 + i))
        _close(jl, tl)
        assert calls == {"flash": 0, "decode": 2 * tcfg.num_layers}
    for name in tcache:
        _close(jcache[name], tcache[name])
    for name, t in cross.items():
        assert torch.equal(tcache[name], t)
    full = tt.forward(tp, tcfg, _torch(batch))
    np.testing.assert_allclose(tl[:, 0].numpy(), full[:, -1].numpy(), atol=STEP_TOL)


def test_decode_wraps_the_self_ring():
    """A prompt of 20 into a self ring of 16 (max_len 16): the step reads a
    wrapped ring, in the port as in the JAX package."""
    jcfg, jp, tcfg, tp = _models()
    batch = _batch(jcfg, 22, batch=1)
    pre = dict(batch, tokens=batch["tokens"][:, :20])
    jl, jcache = jt.prefill(jp, jcfg, _jax(pre), max_len=16)
    tl, tcache = tt.prefill(tp, tcfg, _torch(pre), max_len=16)
    assert tcache["self_k"].shape[2] == 16
    _close(jl, tl)
    for pos in (20, 21):
        tok = batch["tokens"][:, pos:pos + 1]
        jl, jcache = jt.decode_step(jp, jcfg, jcache, jnp.asarray(tok), jnp.asarray(pos))
        tl, tcache = tt.decode_step(tp, tcfg, tcache, T(tok).long(), pos)
        _close(jl, tl)


def test_encoder_is_bidirectional_and_cross_attention_reads_every_frame():
    """Moving the last frame moves the first target token's logits (through
    the encoder and the cross-attention); moving a later target token does
    not (the decoder is causal)."""
    *_, tcfg, tp = _models()
    batch = _torch(_batch(tcfg, 8, batch=1))
    base = tt.forward(tp, tcfg, batch)
    frames = batch["frames"].clone()
    frames[:, -1] += 1.0
    moved = tt.forward(tp, tcfg, dict(batch, frames=frames))
    assert float((moved[:, 0] - base[:, 0]).abs().max()) > 1e-4
    toks = batch["tokens"].clone()
    toks[:, -1] = (toks[:, -1] + 1) % tcfg.vocab_size
    later = tt.forward(tp, tcfg, dict(batch, tokens=toks))
    assert torch.equal(later[:, :-1], base[:, :-1])


def test_prefill_takes_no_stored_prefix():
    jcfg, jp, tcfg, tp = _models()
    batch = _torch(_batch(jcfg, 8))
    _, cache = tt.prefill(tp, tcfg, batch, max_len=32)
    with pytest.raises(ValueError, match="no stored prefix"):
        tt.prefill(tp, tcfg, batch, max_len=32, prefix_cache=cache, prefix_len=4)


# --------------------------------------------------------------------------- #
# twins of tests/test_models_smoke.py
# --------------------------------------------------------------------------- #

def test_forward_shapes_no_nan():
    jcfg, jp, tcfg, tp = _models()
    batch = _batch(jcfg, S)
    logits = tt.forward(tp, tcfg, _torch(batch))
    assert logits.shape == (B, S, tcfg.padded_vocab)
    assert not bool(torch.isnan(logits).any())
    _close(jt.forward(jp, jcfg, _jax(batch), remat=False), logits)


def test_prefill_decode_consistency():
    """decode continuation matches teacher-forced forward, and the port
    matches the JAX package (the reference's test skips enc-dec)."""
    jcfg, jp, tcfg, tp = _models()
    batch = _batch(jcfg, S)
    jl, jcache = jt.prefill(jp, jcfg, _jax(batch), max_len=32)
    logits, cache = tt.prefill(tp, tcfg, _torch(batch), max_len=32)
    _close(jl, logits)
    new = np.full((B, 1), 5, np.int32)
    pos = logits.shape[1]
    jlg, _ = jt.decode_step(jp, jcfg, jcache, jnp.asarray(new), jnp.asarray(pos))
    lg, _ = tt.decode_step(tp, tcfg, cache, T(new).long(), pos)
    _close(jlg, lg)
    b2 = dict(_torch(batch), tokens=torch.cat([_torch(batch)["tokens"], T(new).long()], 1))
    full = tt.forward(tp, tcfg, b2)
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, -1].numpy(), atol=STEP_TOL)


# --------------------------------------------------------------------------- #
# serving: the standing divergence
# --------------------------------------------------------------------------- #

def test_encdec_engine_fails_on_both():
    """The reference's engine passes no frames, so its prefill fails with
    ``KeyError: 'frames'``; the port's refuses enc-dec at construction with a
    ``ValueError`` that says so, and so do ``build_engine`` (before drawing
    weights) and the demo."""
    jcfg, jp, tcfg, tp = _models(d_model=128)
    jeng = JEngine(jcfg, jp, JKVStore(64e6, JPOLICIES["lcs"], jcfg.kv_bytes_per_token),
                   max_len=32)
    with pytest.raises(KeyError, match="frames"):
        jeng.generate("c", list(range(8)), num_new=2)
    store = KVStore(64e6, POLICIES["lcs"], tcfg.kv_bytes_per_token)
    with pytest.raises(ValueError, match="KeyError: 'frames'"):
        RealExecutionEngine(tcfg, tp, store, max_len=32, device="cpu")
    for reduced in (False, True):
        with pytest.raises(ValueError, match="model functions"):
            serve.build_engine(ARCH, device="cpu", reduced=reduced)
    with pytest.raises(ValueError, match="serves no enc-dec"):
        serve.main(["--real", "--arch", ARCH, "--device", "cpu", "--reduced"])


def test_multiarch_twin_runs_on_cpu_and_skips_encdec(capsys):
    multiarch.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for arch in multiarch.ARCHS:
        assert f"turn2 computed  9/29 tokens (reused 20)" in \
            next(line for line in out.splitlines() if line.startswith(arch))
    assert f"{ARCH}  [encdec] skipped" in out
    assert ARCH not in multiarch.ARCHS
    assert "All families serve with context-cache reuse." in out


# --------------------------------------------------------------------------- #
# init, convert, sizes, the card's rows
# --------------------------------------------------------------------------- #

def test_init_params_shapes_and_scales_match_reference():
    jcfg, jp, tcfg, _ = _models(encoder_layers=2)
    tp = tt.init_params(torch.Generator().manual_seed(0), tcfg, torch.float32)
    flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jp))[0]
    for path, leaf in flat:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
        assert abs(float(t.std()) - float(leaf.std())) <= 0.1 * float(leaf.std()) + 1e-6
    assert len(flat) == len(jax.tree.leaves(tp))
    assert serve.weight_bytes(tcfg, torch.float32) == sum(leaf.size * 4 for _, leaf in flat)


def test_convert_checks_the_stacks():
    jcfg, jp, tcfg, _ = _models()
    np_params = jax.tree.map(np.asarray, jp)
    with pytest.raises(ValueError, match="1 encoder and 2 decoder layers; config has 2"):
        params_from_jax(np_params, dataclasses.replace(tcfg, encoder_layers=2), "cpu")
    with pytest.raises(ValueError, match="config has 1 and 3"):
        params_from_jax(np_params, dataclasses.replace(tcfg, num_layers=3), "cpu")
    np_params.pop("enc_ln")
    with pytest.raises(ValueError, match="enc_ln"):
        params_from_jax(np_params, tcfg, "cpu")


def test_full_width_sizes():
    """About 1.08 B parameters: 2.16 GB in bf16, and one KV-cache token of
    the decoder's 12 layers."""
    cfg = get_config(ARCH)
    assert 2.15e9 < serve.weight_bytes(cfg) < 2.18e9
    assert cfg.kv_bytes_per_token == 12 * 16 * 64 * 2 * 2


def test_encdec_kernel_rows_follow_the_config():
    """The card's rows of the enc-dec model phase: the encoder and the
    cross-attention not causal, Sq != Sk for the cross calls, MHA (G = 1)
    at hd 64, and the decode rows' valid slots."""
    flash, decode, _ = shapes.family_shapes()
    assert flash[f"{ARCH} encoder"] == (1, 16, 16, 1024, 1024, 64, 0, None, False)
    assert flash[f"{ARCH} self"] == (1, 16, 16, 512, 512, 64, 0, None, True)
    assert flash[f"{ARCH} cross"] == (1, 16, 16, 512, 1024, 64, 0, None, False)
    assert flash[f"{ARCH} forward self"] == (1, 16, 16, 520, 520, 64, 0, None, True)
    assert flash[f"{ARCH} forward cross"] == (1, 16, 16, 520, 1024, 64, 0, None, False)
    assert decode[f"{ARCH} self"] == (1, 16, 16, 1024, 64, 520, 0)
    assert decode[f"{ARCH} cross"] == (1, 16, 16, 1024, 64, 1024, 0)
