"""Qwen2-VL (``vlm``) in the PyTorch port against the JAX package, on the CPU.

M-RoPE (``mrope_sections``, ``apply_mrope``), the model functions with
patches and Qwen2-VL's position layout passed explicitly, the KV-prefix
engine on its token path, the twin of ``examples/multiarch_decode.py``, and
the standing divergence of ``decode_step``'s default M-RoPE ids. Models are
``reduced(num_layers=2, d_model=256)`` as ``tests/test_models_smoke.py``
reduces them (8 vision tokens, 4/2 heads of 64), in fp32, with the JAX
model's weights carried through ``repro_torch.convert``. Tolerances:
``test_torch_models.TOL`` (3e-4) for the port against the JAX package, and
the reference's 5e-4 where a decode step is held against ``forward``.
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
from repro.models import common as jc
from repro.models import transformer as jt
from repro.serving.realexec import RealExecutionEngine as JEngine
from repro.train.data import make_batch_for
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.kvstore import KVStore
from repro_torch.core.policies import POLICIES
from repro_torch.launch import multiarch, serve, shapes
from repro_torch.models import common as tc
from repro_torch.models import transformer as tt
from repro_torch.serving.realexec import RealExecutionEngine

ARCH = "qwen2-vl-2b"
TOL = 3e-4                          # tests/test_torch_models.py
STEP_TOL = 5e-4                     # test_models_smoke.py::test_prefill_decode_consistency
B, S = 2, 16                        # tests/test_models_smoke.py
GRID = (2, 4)                       # the reduced config's 8 vision tokens as one image
T = torch.from_numpy


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               torch.as_tensor(b).float().numpy(), atol=tol, rtol=tol)


def _models(num_layers=2, d_model=256):
    jcfg = jget_config(ARCH).reduced(num_layers=num_layers, d_model=d_model)
    tcfg = get_config(ARCH).reduced(num_layers=num_layers, d_model=d_model)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu", torch.float32)
    return jcfg, jp, tcfg, tp


def _batch(cfg, text, batch=1, seed=0):
    """numpy tokens (batch, text), patches (batch, V, d) at scale 0.02 and
    Qwen2-VL's layout ids (batch, V + text, 3) for one image of ``GRID``."""
    rng = np.random.default_rng(seed)
    V = cfg.vision_tokens
    assert GRID[0] * GRID[1] == V
    pos = shapes.vision_positions(*GRID, text).numpy()
    return {"tokens": rng.integers(0, cfg.vocab_size, (batch, text)).astype(np.int32),
            "patches": (rng.standard_normal((batch, V, cfg.d_model)) * 0.02
                        ).astype(np.float32),
            "positions": np.broadcast_to(pos, (batch,) + pos.shape[1:]).astype(np.int32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    out = {k: T(np.ascontiguousarray(v)) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


# --------------------------------------------------------------------------- #
# M-RoPE
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("half", [1, 4, 8, 32, 64, 65])
def test_mrope_sections_match(half):
    assert tc.mrope_sections(half) == jc.mrope_sections(half)
    assert sum(tc.mrope_sections(half)) == half
    assert tc.mrope_sections(64) == (16, 24, 24)       # hd 128, qwen2-vl-2b's


@pytest.mark.parametrize("hd", [16, 64])
def test_apply_mrope_matches_with_distinct_ids(hd):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 9, 3)).astype(np.int32)
    assert (pos[..., 0] != pos[..., 1]).any() and (pos[..., 1] != pos[..., 2]).any()
    got = tc.apply_mrope(T(x), T(pos).long(), 1e6)
    _close(jc.apply_mrope(x, jnp.asarray(pos), 1e6), got, 2e-5)
    # each section turns by its own id: moving the width ids moves only the
    # width section's pairs (and their partners in the second half)
    pos2 = pos.copy()
    pos2[..., 2] += 7
    moved = (tc.apply_mrope(T(x), T(pos2).long(), 1e6) != got).any(dim=(0, 1, 2))
    s1, s2, s3 = tc.mrope_sections(hd // 2)
    want = torch.zeros(hd // 2, dtype=torch.bool)
    want[s1 + s2:] = True
    assert torch.equal(moved, torch.cat([want, want]))


@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_mrope_with_equal_ids_is_apply_rope_bit_for_bit(hd, dtype):
    rng = np.random.default_rng(2)
    x = T(rng.standard_normal((1, 12, 2, hd)).astype(np.float32)).to(dtype)
    pos = torch.arange(40, 52)
    ids = pos[None, :, None].expand(1, 12, 3)
    assert torch.equal(tc.apply_mrope(x, ids, 10_000.0), tc.apply_rope(x, pos, 10_000.0))
    # one token at one position: decode_step's default ids
    step = torch.full((1, 1, 3), 77)
    assert torch.equal(tc.apply_mrope(x[:, :1], step), tc.apply_rope(x[:, :1],
                                                                    torch.full((1,), 77)))


# --------------------------------------------------------------------------- #
# the model functions, with patches and the layout's ids
# --------------------------------------------------------------------------- #

def test_forward_and_prefill_match_with_patches_and_layout():
    jcfg, jp, tcfg, tp = _models()
    batch = _batch(jcfg, 12, batch=2)
    want = jt.forward(jp, jcfg, _jax(batch), remat=False)
    got = tt.forward(tp, tcfg, _torch(batch))
    assert got.shape == (2, 8 + 12, tcfg.padded_vocab)
    _close(want, got)
    jl, jcache = jt.prefill(jp, jcfg, _jax(batch), max_len=32)
    tl, tcache = tt.prefill(tp, tcfg, _torch(batch), max_len=32)
    _close(jl, tl)
    _close(jcache["k"], tcache["k"])
    _close(jcache["v"], tcache["v"])
    # the ids are read: without them (apply_rope) the text rows move
    rope = {k: v for k, v in _torch(batch).items() if k != "positions"}
    other = tt.forward(tp, tcfg, rope)
    assert float((other[:, 8:] - got[:, 8:]).abs().max()) > 1e-3


def test_prefix_prefill_matches_with_layout():
    """A stored prefix of the image and 6 text tokens, then a suffix of 6
    text tokens with its own ids at q_offset 14: the port's suffix prefill
    against the JAX package's, and against the cold prefill's last rows."""
    jcfg, jp, tcfg, tp = _models()
    batch = _batch(jcfg, 12)
    first = {"tokens": batch["tokens"][:, :6], "patches": batch["patches"],
             "positions": batch["positions"][:, :14]}
    suffix = {"tokens": batch["tokens"][:, 6:], "positions": batch["positions"][:, 14:]}
    _, jpre = jt.prefill(jp, jcfg, _jax(first), max_len=32)
    _, tpre = tt.prefill(tp, tcfg, _torch(first), max_len=32)
    jl, jcache = jt.prefill(jp, jcfg, _jax(suffix), max_len=32, prefix_cache=jpre,
                            prefix_len=14)
    tl, tcache = tt.prefill(tp, tcfg, _torch(suffix), max_len=32, prefix_cache=tpre,
                            prefix_len=14)
    _close(jl, tl)
    _close(jcache["k"], tcache["k"])
    cold, _ = tt.prefill(tp, tcfg, _torch(batch), max_len=32)
    _close(cold[:, 14:], tl)


def test_decode_steps_match_with_explicit_ids():
    """Steps past the image and text with the layout's next ids passed
    explicitly: the port against the JAX package at each step and its cache,
    and the last step against ``forward`` at the reference's 5e-4."""
    jcfg, jp, tcfg, tp = _models()
    batch = _batch(jcfg, 12 + 3)
    pre = {"tokens": batch["tokens"][:, :12], "patches": batch["patches"],
           "positions": batch["positions"][:, :20]}
    _, jcache = jt.prefill(jp, jcfg, _jax(pre), max_len=32)
    _, tcache = tt.prefill(tp, tcfg, _torch(pre), max_len=32)
    for i in range(3):
        tok = batch["tokens"][:, 12 + i:13 + i]
        ids = batch["positions"][:, 20 + i:21 + i]
        jl, jcache = jt.decode_step(jp, jcfg, jcache, jnp.asarray(tok), jnp.asarray(20 + i),
                                    mrope_positions=jnp.asarray(ids))
        tl, tcache = tt.decode_step(tp, tcfg, tcache, T(tok).long(), 20 + i,
                                    mrope_positions=T(ids).long())
        _close(jl, tl)
    _close(jcache["k"], tcache["k"])
    full = tt.forward(tp, tcfg, _torch(batch))
    np.testing.assert_allclose(tl[:, 0].numpy(), full[:, -1].numpy(), atol=STEP_TOL)


def test_default_ids_step_is_another_function_under_the_layout():
    """Standing divergence: under Qwen2-VL's layout a text token's ids (4 +
    j here) are not its slot (8 + j), so ``decode_step``'s default ids
    (``pos`` in all three) turn q and k by other angles than ``forward``.
    Both packages' default step lands 1e-1 or more from ``forward``'s last
    logits; both explicit steps within the reference's 5e-4."""
    jcfg, jp, tcfg, tp = _models()
    batch = _batch(jcfg, 13)
    pre = {"tokens": batch["tokens"][:, :12], "patches": batch["patches"],
           "positions": batch["positions"][:, :20]}
    tok, ids = batch["tokens"][:, 12:], batch["positions"][:, 20:]
    jfull = np.asarray(jt.forward(jp, jcfg, _jax(batch), remat=False))[:, -1]
    tfull = tt.forward(tp, tcfg, _torch(batch))[:, -1].numpy()
    for explicit in (False, True):
        _, jcache = jt.prefill(jp, jcfg, _jax(pre), max_len=32)
        _, tcache = tt.prefill(tp, tcfg, _torch(pre), max_len=32)
        jl, _ = jt.decode_step(jp, jcfg, jcache, jnp.asarray(tok), jnp.asarray(20),
                               mrope_positions=jnp.asarray(ids) if explicit else None)
        tl, _ = tt.decode_step(tp, tcfg, tcache, T(tok).long(), 20,
                               mrope_positions=T(ids).long() if explicit else None)
        jerr = float(np.abs(np.asarray(jl)[:, 0] - jfull).max())
        terr = float(np.abs(tl[:, 0].numpy() - tfull).max())
        if explicit:
            assert jerr <= STEP_TOL and terr <= STEP_TOL
        else:
            assert jerr >= 1e-1 and terr >= 1e-1
            _close(jl, tl)                       # the same other function


# --------------------------------------------------------------------------- #
# twins of tests/test_models_smoke.py
# --------------------------------------------------------------------------- #

def _smoke_batch(cfg):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    batch = make_batch_for(cfg, toks, toks)
    batch.pop("labels")
    return batch


def test_forward_shapes_no_nan():
    jcfg, jp, tcfg, tp = _models()
    batch = _smoke_batch(jcfg)
    logits = tt.forward(tp, tcfg, _torch(batch))
    assert logits.shape == (B, S + tcfg.vision_tokens, tcfg.padded_vocab)
    assert not bool(torch.isnan(logits).any())
    _close(jt.forward(jp, jcfg, _jax(batch), remat=False), logits)


def test_prefill_decode_consistency():
    """decode continuation (default ids) matches teacher-forced forward on
    the smoke test's trivial layout, and the port matches the JAX package."""
    jcfg, jp, tcfg, tp = _models()
    batch = _smoke_batch(jcfg)
    jl, jcache = jt.prefill(jp, jcfg, _jax(batch), max_len=32)
    logits, cache = tt.prefill(tp, tcfg, _torch(batch), max_len=32)
    _close(jl, logits)
    new = np.full((B, 1), 5, np.int32)
    pos = logits.shape[1]
    jlg, _ = jt.decode_step(jp, jcfg, jcache, jnp.asarray(new), jnp.asarray(pos))
    lg, _ = tt.decode_step(tp, tcfg, cache, T(new).long(), pos)
    _close(jlg, lg)
    b2 = dict(_torch(batch), tokens=torch.cat([_torch(batch)["tokens"], T(new).long()], 1))
    St = b2["tokens"].shape[1] + tcfg.vision_tokens
    b2["positions"] = torch.arange(St)[None, :, None].expand(B, St, 3)
    full = tt.forward(tp, tcfg, b2)
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, -1].numpy(), atol=STEP_TOL)


# --------------------------------------------------------------------------- #
# serving: the token path
# --------------------------------------------------------------------------- #

def test_kv_prefix_engine_matches_jax_engine():
    """The reduced demo config (2 layers, d_model 128) on the token path:
    the port's engine gives the JAX engine's greedy tokens and reuse counts
    on both turns, and a cold engine the hit's tokens."""
    jcfg, jp, tcfg, tp = _models(d_model=128)

    def engine():
        return RealExecutionEngine(tcfg, tp, KVStore(64e6, POLICIES["lcs"],
                                                     tcfg.kv_bytes_per_token),
                                   max_len=128, dtype=torch.float32, device="cpu")
    jeng = JEngine(jcfg, jp, JKVStore(64e6, JPOLICIES["lcs"], jcfg.kv_bytes_per_token),
                   max_len=128)
    teng = engine()
    rng = np.random.default_rng(1)
    ctx = [int(t) for t in rng.integers(0, tcfg.vocab_size, 24)]
    extra = [int(t) for t in rng.integers(0, tcfg.vocab_size, 8)]
    results = []
    for prompt in (ctx, None):
        prompt = prompt or ctx + results[0].tokens + extra
        j, t = jeng.generate("c", prompt, num_new=4), teng.generate("c", prompt, num_new=4)
        assert (t.tokens, t.reused_tokens, t.prefill_tokens_computed) == \
            (j.tokens, j.reused_tokens, j.prefill_tokens_computed)
        results.append(t)
    assert (results[1].reused_tokens, results[1].prefill_tokens_computed) == (24, 12)
    cold = engine().generate("other", ctx + results[0].tokens + extra, num_new=4)
    assert cold.reused_tokens == 0 and cold.tokens == results[1].tokens
    np.testing.assert_allclose(cold.last_logits.numpy(), results[1].last_logits.numpy(),
                               atol=TOL)


def test_serve_demo_runs_on_cpu(capsys):
    serve.main(["--real", "--arch", ARCH, "--device", "cpu", "--reduced"])
    out = capsys.readouterr().out
    assert "turn 2: computed 12 prefill tokens, reused 24" in out
    assert "cache hit verified" in out


def test_full_width_takes_yi_6b_conversation_and_fits():
    assert serve.FULL_TURNS[ARCH] == serve.FULL_TURNS["yi-6b"] == (2048, 504, 8, 4096)
    assert 3.5e9 < serve.weight_bytes(get_config(ARCH)) < 3.6e9


@pytest.mark.parametrize("arch", multiarch.ARCHS)
def test_multiarch_twin_matches_reference_demo(arch):
    """``examples/multiarch_decode.py``'s conversation per arch on the JAX
    weights: the twin's engine gives the JAX engine's tokens and counts."""
    cfg = multiarch.demo_config(arch)
    jcfg = jget_config(arch)
    jcfg = jcfg.reduced(num_layers=4 if jcfg.family == "hybrid" else 2, d_model=128)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu", torch.float32)
    _, ctx2, r1, r2 = multiarch.serve_arch(arch, "cpu", params=tp)
    jeng = JEngine(jcfg, jp, JKVStore(64e6, JPOLICIES["lcs"],
                                      max(jcfg.kv_bytes_per_token, 1.0)),
                   max_len=multiarch.MAX_LEN)
    j1 = jeng.generate(f"{arch}-c0", ctx2[:20], num_new=3)
    j2 = jeng.generate(f"{arch}-c0", ctx2, num_new=3)
    assert (r1.tokens, r2.tokens) == (j1.tokens, j2.tokens)
    assert (r2.reused_tokens, r2.prefill_tokens_computed) == \
        (j2.reused_tokens, j2.prefill_tokens_computed) == (20, 9)


# --------------------------------------------------------------------------- #
# init and convert
# --------------------------------------------------------------------------- #

def test_init_params_shapes_and_scales_match_reference():
    jcfg, jp, tcfg, _ = _models()
    tp = tt.init_params(torch.Generator().manual_seed(0), tcfg, torch.float32)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jp))[0]:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
        assert abs(float(t.std()) - float(leaf.std())) <= 0.1 * float(leaf.std()) + 1e-6
    assert serve.weight_bytes(tcfg, torch.float32) == sum(
        x.size * 4 for x in jax.tree.leaves(jax.tree.map(np.asarray, jp)))


def test_convert_wants_patch_proj():
    jcfg, jp, tcfg, _ = _models()
    np_params = jax.tree.map(np.asarray, jp)
    np_params.pop("patch_proj")
    with pytest.raises(ValueError, match="patch_proj"):
        params_from_jax(np_params, tcfg, "cpu")
    dense = dataclasses.replace(tcfg, family="dense")
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(jax.tree.map(np.asarray, jp), dense, "cpu")


def test_family_kernel_rows_follow_the_configs():
    """The card's rows of the vlm paths (``shapes.family_shapes``): the
    conversation is yi-6b's at qwen2-vl-2b's 12/2 heads, the vision phase's
    prefill covers the image and the text, and the hit pair's rows are a row."""
    flash, decode, identity = shapes.family_shapes()
    assert flash[f"{ARCH} turn 2"] == (1, 12, 2, 512, 2560, 128, 2048, None, True)
    assert flash[f"{ARCH} vision prefill"] == (1, 12, 2, 3072, 3072, 128, 0, None, True)
    assert flash[f"{ARCH} vision forward"] == (1, 12, 2, 3076, 3076, 128, 0, None, True)
    assert decode[f"{ARCH} turn 2"] == (1, 12, 2, 4096, 128, 2568, 0)
    assert [decode[f"{ARCH} vision step {i}"][5] for i in (1, 2, 3, 4)] == \
        [3073, 3074, 3075, 3076]
    assert identity == [(flash[f"{ARCH} cold"], 2048)]
    cold, first = identity[0]
    assert cold[:3] + (cold[3] - first, cold[4], cold[5], first) + cold[7:] == \
        flash[f"{ARCH} turn 2"]
    pos = shapes.vision_positions(32, 32, 2048)
    assert pos.shape == (1, 3072, 3) and pos[0, 1023].tolist() == [0, 31, 31]
    assert pos[0, 1024].tolist() == [32, 32, 32]
