"""Real-execution serving of the PyTorch port against the JAX engine, on
the CPU: the same weights (converted through numpy), the same prompts, the
same greedy tokens and reuse counts; plus the port's KV store against the
reference's, and the port's rules (no jax at import, no CPU fallback)."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

from repro.configs import get_config as jget_config
from repro.core.kvstore import KVStore as JKVStore
from repro.core.policies import POLICIES as JPOLICIES
from repro.models.transformer import init_params as jinit_params
from repro.models.transformer import prefill as jprefill
from repro.serving.realexec import RealExecutionEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.kvstore import KVStore
from repro_torch.core.policies import POLICIES
from repro_torch.launch import serve
from repro_torch.models.transformer import prefill
from repro_torch.serving.realexec import RealExecutionEngine

ROOT = Path(__file__).resolve().parents[1]


def make_engines(seed=0, max_len=128):
    """JAX engine and port engine over the same reduced yi-6b weights."""
    jcfg = jget_config("yi-6b").reduced(num_layers=2, d_model=128)
    cfg = get_config("yi-6b").reduced(num_layers=2, d_model=128)
    jp = jinit_params(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu", torch.float32)
    jeng = JEngine(jcfg, jp, JKVStore(64e6, JPOLICIES["lcs"], jcfg.kv_bytes_per_token),
                   max_len=max_len)
    teng = RealExecutionEngine(cfg, tp, KVStore(64e6, POLICIES["lcs"],
                                                cfg.kv_bytes_per_token),
                               max_len=max_len, dtype=torch.float32, device="cpu")
    return jcfg, jp, jeng, cfg, tp, teng


def _same(jr, tr):
    assert tr.tokens == jr.tokens
    assert tr.reused_tokens == jr.reused_tokens
    assert tr.prefill_tokens_computed == jr.prefill_tokens_computed


def test_prefix_prefill_matches_full_prefill():
    """prefill(suffix | cached prefix KV) == prefill(full prompt), and both
    equal the JAX package's full prefill."""
    jcfg, jp, _, cfg, tp, _ = make_engines()
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 24))
    t = torch.from_numpy(toks).long()
    full_logits, full_cache = prefill(tp, cfg, {"tokens": t}, max_len=64)
    _, pre_cache = prefill(tp, cfg, {"tokens": t[:, :16]}, max_len=64)
    suf_logits, suf_cache = prefill(tp, cfg, {"tokens": t[:, 16:]}, max_len=64,
                                    prefix_cache=pre_cache, prefix_len=16)
    np.testing.assert_allclose(suf_logits.numpy(), full_logits[:, 16:].numpy(),
                               atol=3e-4)
    np.testing.assert_allclose(suf_cache["k"][:, :, :24].numpy(),
                               full_cache["k"][:, :, :24].numpy(), atol=3e-4)
    jlogits, _ = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)},
                          max_len=64)
    np.testing.assert_allclose(np.asarray(jlogits), full_logits.numpy(),
                               atol=3e-4, rtol=3e-4)


def test_multi_turn_reuse_identical_output():
    """Two turns on the port == two turns on the JAX engine, and the cached
    turn 2 == a cold engine's turn 2 (greedy tokens)."""
    jcfg, jp, jeng, cfg, tp, teng = make_engines()
    rng = np.random.default_rng(1)
    ctx = [int(t) for t in rng.integers(0, cfg.vocab_size, 20)]
    extra = [int(t) for t in rng.integers(0, cfg.vocab_size, 6)]

    j1, t1 = jeng.generate("c", ctx, num_new=3), teng.generate("c", ctx, num_new=3)
    _same(j1, t1)
    assert t1.reused_tokens == 0
    ctx2 = ctx + t1.tokens + extra
    j2, t2 = jeng.generate("c", ctx2, num_new=3), teng.generate("c", ctx2, num_new=3)
    _same(j2, t2)
    assert t2.reused_tokens == len(ctx)
    assert t2.prefill_tokens_computed == len(ctx2) - len(ctx)

    *_, cold = make_engines()
    tc = cold.generate("other", ctx2, num_new=3)
    assert tc.reused_tokens == 0
    assert tc.tokens == t2.tokens
    np.testing.assert_allclose(tc.last_logits.numpy(), t2.last_logits.numpy(),
                               atol=3e-4)


def test_store_tracks_real_payload_bytes():
    jcfg, jp, jeng, cfg, tp, teng = make_engines()
    ctx = [int(t) for t in np.random.default_rng(2).integers(0, cfg.vocab_size, 12)]
    _same(jeng.generate("a", ctx, num_new=2), teng.generate("a", ctx, num_new=2))
    assert len(teng.store.entries) == 1
    e = teng.store.entries["a"]
    je = jeng.store.entries["a"]
    assert (e.num_tokens, e.size_bytes) == (je.num_tokens, je.size_bytes) == \
        (12, 12 * cfg.kv_bytes_per_token)
    plen, pay = e.payload
    assert plen == 12
    # the payload holds exactly the accounted prefix: bf16 bytes == size_bytes
    nbytes = sum(t.numel() * 2 for t in pay.values())
    assert nbytes == e.size_bytes


def test_decode_does_not_corrupt_stored_prefix():
    """Decode writes the live cache in place; the stored prefix must stay
    the prompt's K/V, so hitting it again after decoding past it gives the
    JAX engine's tokens (whose arrays are immutable) and a cold run's."""
    *_, jeng, cfg, tp, teng = make_engines()
    rng = np.random.default_rng(4)
    ctx = [int(t) for t in rng.integers(0, cfg.vocab_size, 10)]
    _same(jeng.generate("x", ctx, num_new=1), teng.generate("x", ctx, num_new=1))
    plen, pay = teng.store.entries["x"].payload
    saved = {k: v.clone() for k, v in pay.items()}
    # a full-length hit whose suffix is empty is not servable, so extend by
    # one token and decode well past the prefix
    r = teng.generate("x", ctx + [3], num_new=6)
    _same(jeng.generate("x", ctx + [3], num_new=6), r)
    assert r.reused_tokens == 10
    for k in saved:
        assert torch.equal(pay[k], saved[k])
    r_again = teng.generate("x", ctx + [3, 5], num_new=6)
    _same(jeng.generate("x", ctx + [3, 5], num_new=6), r_again)
    assert r_again.reused_tokens == 11
    *_, cold = make_engines()
    assert cold.generate("y", ctx + [3, 5], num_new=6).tokens == r_again.tokens


def test_prompt_longer_than_cache_width():
    """A cold prompt longer than the ring is served as the JAX engine serves
    it; a hit on its stored prefix raises, since the ring has wrapped and the
    slots no longer hold positions 0..n-1 in order."""
    *_, jeng, cfg, tp, teng = make_engines(max_len=16)
    prompt = [int(t) for t in np.random.default_rng(6).integers(0, cfg.vocab_size, 20)]
    _same(jeng.generate("z", prompt, num_new=3), teng.generate("z", prompt, num_new=3))
    plen, pay = teng.store.entries["z"].payload
    assert plen == 20 and pay["k"].shape[2] == 16
    with pytest.raises(ValueError, match="cache width"):
        teng.generate("z", prompt + [1], num_new=1)


@pytest.mark.parametrize("seed,capacity", [(5, 5000.0), (6, 2000.0), (7, 12000.0)])
def test_kvstore_evicts_like_reference(seed, capacity):
    """A random lookup/insert sequence under eviction pressure leaves the
    same entries, in the same order, with the same stats, under LCS."""
    rng = np.random.default_rng(seed)
    a = JKVStore(capacity, JPOLICIES["lcs"], 10.0)
    b = KVStore(capacity, POLICIES["lcs"], 10.0)
    now = 0.0
    for step in range(400):
        now += float(rng.uniform(0.1, 3.0))
        key = f"k{int(rng.integers(0, 40))}"
        n = int(rng.integers(1, 120))
        if rng.random() < 0.5:
            ea, eb = a.lookup(key, n, now), b.lookup(key, n, now)
            assert (ea is None) == (eb is None)
            assert a.reusable_tokens(key, n) == b.reusable_tokens(key, n)
        else:
            turn = int(rng.integers(1, 5))
            ea = a.insert(key, n, now, turn=turn)
            eb = b.insert(key, n, now, turn=turn)
            assert (ea is None) == (eb is None)
        assert list(a.entries) == list(b.entries), step
        assert a.used_bytes == b.used_bytes
    sa, sb = a.stats, b.stats
    assert sb.evictions > 5
    assert (sa.lookups, sa.hits, sa.hit_tokens, sa.insertions, sa.evictions,
            sa.evicted_bytes, sa.written_bytes) == \
        (sb.lookups, sb.hits, sb.hit_tokens, sb.insertions, sb.evictions,
         sb.evicted_bytes, sb.written_bytes)


def test_serve_demo_runs_on_cpu(capsys):
    serve.main(["--real", "--arch", "yi-6b", "--device", "cpu", "--reduced"])
    out = capsys.readouterr().out
    assert "turn 2: computed 12 prefill tokens, reused 24" in out
    assert "cache hit verified" in out


def test_import_leaves_jax_out():
    code = ("import sys; import repro_torch.serving.realexec, "
            "repro_torch.launch.serve; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                   timeout=120)


def test_cuda_engine_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the engine runs there")
    *_, cfg, tp, _ = make_engines()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RealExecutionEngine(cfg, tp, KVStore(1e9, POLICIES["lcs"], 1.0),
                            dtype=torch.float32, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RealExecutionEngine(cfg, tp, KVStore(1e9, POLICIES["lcs"], 1.0),
                            dtype=torch.float32)


def test_first_hit_times_and_profiles_the_suffix_prefill(capsys):
    """The first-hit script's prefill on the reduced demo, unprofiled and
    under the profiler: a suffix-only prefill, timed, with its host calls."""
    from repro_torch.launch import first_hit
    cfg, eng = serve.build_engine("yi-6b", device="cpu", reduced=True)
    ctx, extra, num_new = serve.conversation(cfg, True)
    r1 = eng.generate("c", ctx, num_new=num_new)
    ctx2 = ctx + r1.tokens + extra
    ms, wall, prof = first_hit.timed_prefill(eng, "c", ctx2, profile=False)
    assert ms > 0 and wall is None and prof is None
    assert eng.store.entries["c"].payload[0] == len(ctx2)
    eng.generate("d", ctx, num_new=num_new)
    ms, wall, prof = first_hit.timed_prefill(eng, "d", ctx2, profile=True)
    assert 0 < ms <= wall
    first_hit.report("replay", ms, wall, prof, top=3)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("replay: prefill ") and "idle share" in out[1]
    assert len(out) == 5 and all(line.startswith("  host ") for line in out[2:])
