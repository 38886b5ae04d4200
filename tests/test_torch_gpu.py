"""The port on the card: each CUDA kernel against its plain PyTorch version
(the flash, wkv6 and rglru backwards through autograd), the kernels without
a backward refusing a tensor that requires grad, reduced training steps
against the CPU's (the attention families' and the two recurrent ones'),
the MoE FFN against its dense oracle, the reduced engines (yi-6b,
h2o-danube-1.8b, dbrx-132b, grok-1-314b, rwkv6-1.6b, recurrentgemma-2b,
qwen2-vl-2b) and the reduced enc-dec model functions on the card against
the same on the CPU.

Every test here carries the ``gpu`` marker and skips, inside the ``cuda``
fixture, when there is no card. The file imports no jax, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

from repro_torch.configs import get_config
from repro_torch.core.kvstore import KVStore
from repro_torch.core.policies import POLICIES
from repro_torch.kernels import cases, ops, ref
from repro_torch.launch import serve, shapes
from repro_torch.models import moe
from repro_torch.models import transformer as tt
from repro_torch.models.transformer import griffin_layout, init_params
from repro_torch.serving.realexec import RealExecutionEngine
from repro_torch.train import tree
from repro_torch.train.data import batch_iterator, batch_to
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.steps import loss_fn, make_train_step

DENSE_FLASH, DENSE_DECODE, DENSE_IDENTITY = shapes.dense_shapes()
FAMILY_FLASH, FAMILY_DECODE, FAMILY_IDENTITY = shapes.family_shapes()
FLASH_CASES = (cases.FLASH_SWEEP + cases.FLASH_RAGGED + cases.FLASH_EMPTY_BAND
               + cases.FLASH_GRIFFIN + cases.FLASH_TILES + cases.FLASH_TF32_TILES
               + list(DENSE_FLASH.values())
               + list(FAMILY_FLASH.values()))
DECODE_CASES = (cases.DECODE_SWEEP + cases.DECODE_RAGGED + cases.DECODE_GRIFFIN
                + cases.DECODE_MAIN + cases.DECODE_FLOOR + list(DENSE_DECODE.values())
                + list(FAMILY_DECODE.values()))
WKV6_CASES = (cases.WKV6_SWEEP + cases.WKV6_EDGE + cases.WKV6_SLICE + cases.WKV6_NO_TOKEN
              + cases.WKV6_STEP + cases.WKV6_FLOOR + cases.WKV6_BF16)
RGLRU_CASES = (cases.RGLRU_SWEEP + cases.RGLRU_EDGE + cases.RGLRU_CHUNK
               + cases.RGLRU_NO_TOKEN + cases.RGLRU_FLOOR)
WKV6_BF16_CASES = [c for c in cases.WKV6_SLICE + cases.WKV6_STEP + cases.WKV6_FLOOR
                   + cases.WKV6_BF16 + list(cases.WKV6_BWD_TRAIN.values())
                   if c[7] == "bf16"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, dtype, case):
    n = ops.flash_attention.launches
    cases.check_flash(case, dtype, cuda)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == n + 1


@pytest.mark.gpu
@pytest.mark.parametrize("case,first,dtype",
                         [(c, f, torch.bfloat16) for c, f in cases.FLASH_IDENTITY
                          + DENSE_IDENTITY + FAMILY_IDENTITY]
                         + [(c, f, torch.float32) for c, f in cases.FLASH_IDENTITY])
def test_flash_hit_rows_equal_cold_rows(cuda, case, first, dtype):
    """A cache hit's suffix rows equal the cold prefill's bit for bit, in
    bf16 and (at ``cases.FLASH_IDENTITY``) in fp32, whose blocks take as
    many rows as the call's shape gives them: a row's arithmetic does not
    depend on its block."""
    n = ops.flash_attention.launches
    assert cases.check_flash_hit_rows(case, first, dtype, cuda) == 0
    assert ops.flash_attention.launches == n + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_kernel_matches_plain_on_strided_cache(cuda, dtype, case):
    n = ops.decode_attention.launches
    cases.check_decode(case, dtype, cuda)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == n + 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", cases.DECODE_MAIN + list(DENSE_DECODE.values()))
def test_decode_occupancy_counts_the_plans_clusters(cuda, case):
    """The kernel's occupancy query at the main paths' plans: the grid's
    clusters (one per kv head and batch row at G <= 16), and at least one
    cluster of every plan on the card at once; it launches nothing."""
    from repro_torch.kernels import decode_attention as dmod
    q, k, _, _ = cases.decode_inputs(case, torch.bfloat16, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n = ops.decode_attention.launches
    for nsplit in (16, 8, 4, 1):
        chunk = -(-case[3] // (nsplit * dmod.TILE)) * dmod.TILE
        clusters, at_once = dmod.occupancy(q, k, nsplit, chunk)
        assert clusters == case[0] * case[2] and at_once >= 1
    assert dmod.occupancy(q, k, *dmod.split_plan(case[0], case[2], case[3], sms))[0] == \
        case[0] * case[2]
    assert ops.decode_attention.launches == n


@pytest.mark.gpu
def test_decode_kernel_repeats_bit_for_bit(cuda):
    """The merge keeps no state between calls: the same call gives the same
    bits after calls of other shapes (other cluster sizes) in between."""
    griffin = cases.decode_inputs(cases.DECODE_MAIN[1], torch.bfloat16, cuda)
    first = ops.decode_attention(*griffin)
    for case in (cases.DECODE_MAIN[0], cases.DECODE_FLOOR[0], cases.DECODE_RAGGED[4]):
        ops.decode_attention(*cases.decode_inputs(case, torch.bfloat16, cuda))
    assert torch.equal(ops.decode_attention(*griffin), first)


@pytest.mark.gpu
@pytest.mark.parametrize("case", WKV6_CASES)
def test_wkv6_kernel_matches_plain(cuda, case):
    n = ops.wkv6.launches
    cases.check_wkv6(case, cuda)
    torch.cuda.synchronize()
    assert ops.wkv6.launches == n + 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", WKV6_BF16_CASES)
def test_wkv6_bf16_and_fp32_calls_are_bit_identical(cuda, case):
    """The kernels upcast bf16 r, k, v in registers, exactly: the bf16 call
    and the fp32 call on the upcast values give the same bits."""
    inputs = cases.wkv6_inputs(case, cuda)
    y, sn = ops.wkv6(*inputs)
    y32, sn32 = ops.wkv6(*(t.float() for t in inputs[:3]), *inputs[3:])
    assert torch.equal(y, y32) and torch.equal(sn, sn32)


@pytest.mark.gpu
def test_wkv6_kernel_refuses_what_it_does_not_take(cuda):
    r, k, v, w, u, s0 = cases.wkv6_inputs((1, 1, 2, 129, None, 0.1, "bhsd"), cuda)
    n = ops.wkv6.launches
    with pytest.raises(ValueError, match="hd"):
        ops.wkv6(r, k, v, w, u, s0)
    with pytest.raises(TypeError, match="float32"):
        ops.wkv6(*(t.bfloat16() for t in (r, k, v, w, u, s0)))
    with pytest.raises(ValueError, match="contiguous"):
        ops.wkv6(r[..., ::2], k[..., ::2], v[..., ::2], w[..., ::2], u[:, ::2],
                 s0[..., ::2, ::2])
    assert ops.wkv6.launches == n


@pytest.mark.gpu
@pytest.mark.parametrize("case", RGLRU_CASES)
def test_rglru_kernel_matches_plain(cuda, case):
    n = ops.rglru_scan.launches
    cases.check_rglru(case, cuda)
    torch.cuda.synchronize()
    assert ops.rglru_scan.launches == n + 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", cases.RGLRU_STEP)
def test_rglru_step_kernel_matches_plain(cuda, case):
    """The fused step against ref.rglru_step_ref: h' at RGLRU_TOL, y at
    RGLRU_TOL in fp32 and TOL in bf16; one launch."""
    n, m = ops.rglru_step.launches, ops.rglru_scan.launches
    cases.check_rglru_step(case, cuda)
    torch.cuda.synchronize()
    assert (ops.rglru_step.launches, ops.rglru_scan.launches) == (n + 1, m)


@pytest.mark.gpu
@pytest.mark.parametrize("case", cases.RGLRU_CHUNK + [cases.RGLRU_BWD_TRAIN[
    "recurrentgemma-2b"][:4]])
def test_rglru_scan_holds_its_tolerance_and_repeats_past_a_chunk(cuda, case):
    """Past one 128-step chunk the two-pass scan folds the earlier chunks'
    states: within RGLRU_TOL of the plain version, two calls the same
    bits; at one chunk, the plain version's bits."""
    cases.check_rglru(case, cuda)
    cases.check_rglru_repeat(case, cuda)
    if case[1] <= 128:
        inputs = cases.rglru_inputs(case, cuda)
        for got, want in zip(ops.rglru_scan(*inputs), ref.rglru_scan_ref(*inputs)):
            assert torch.equal(got, want)


@pytest.mark.gpu
def test_plans_count_the_device_kernels_and_scratch(cuda):
    """``rglru.scan_plan`` and ``wkv6.fwd_plan``, asked of the C side: the
    carry pass only past one chunk, its scratch 2·B·K·D floats; wkv6 one
    kernel and no scratch; refusals as -1 → ValueError."""
    from repro_torch.kernels import rglru, wkv6
    assert rglru.scan_plan(1, 128, 2560) == (1, 0)
    assert rglru.scan_plan(1, 129, 2560) == (2, 2 * 1 * 2 * 2560)
    assert rglru.scan_plan(3, 8192, 77) == (2, 2 * 3 * 64 * 77)
    assert rglru.scan_plan(1, 0, 64) == (1, 0)
    assert wkv6.fwd_plan(1, 32, 4096, 64) == wkv6.fwd_plan(1, 32, 1, 64) == (1, 0)
    with pytest.raises(ValueError):
        rglru.scan_plan(65536, 2, 8)
    with pytest.raises(ValueError):
        wkv6.fwd_plan(1, 1, 2, 129)


@pytest.mark.gpu
def test_rglru_kernel_refuses_what_it_does_not_take(cuda):
    a, b, h0 = cases.rglru_inputs(cases.RGLRU_SWEEP[0], cuda)
    n = ops.rglru_scan.launches
    with pytest.raises(TypeError, match="float32"):
        ops.rglru_scan(a.bfloat16(), b.bfloat16(), h0.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        ops.rglru_scan(a[..., ::2], b[..., ::2], h0[..., ::2])
    with pytest.raises(ValueError, match="one device"):
        ops.rglru_scan(a, b, h0.cpu())
    assert ops.rglru_scan.launches == n


@pytest.mark.gpu
def test_device_ms_reads_a_whole_window(cuda):
    """The profiler is ready, and the window rule reads one launch per call
    with a positive device time."""
    from repro_torch.launch import device_time
    device_time.profiler_ready()
    sets = [[torch.zeros(1 << 16, device=cuda)] for _ in range(4)]
    ms, calls = device_time.device_ms(lambda x: x.add_(1), sets, 20)
    assert ms > 0 and [c for c, _ in calls.values()] == [20]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.gpu
def test_reduced_engine_on_card_matches_cpu(cuda):
    cfg, on_cpu = serve.build_engine("yi-6b", device="cpu", reduced=True)
    _, on_card = serve.build_engine("yi-6b", device=cuda, reduced=True,
                                    params=_to(on_cpu.params, cuda))
    _, c1, c2 = serve.two_turns(cfg, on_cpu, True)
    f0, d0 = ops.flash_attention.launches, ops.decode_attention.launches
    _, g1, g2 = serve.two_turns(cfg, on_card, True)
    num_new = serve.REDUCED_TURNS[2]
    assert ops.flash_attention.launches - f0 == 2 * cfg.num_layers
    assert ops.decode_attention.launches - d0 == 2 * num_new * cfg.num_layers
    for c, g in ((c1, g1), (c2, g2)):
        assert (g.tokens, g.reused_tokens) == (c.tokens, c.reused_tokens)
        np.testing.assert_allclose(g.last_logits.cpu().numpy(),
                                   c.last_logits.numpy(), atol=3e-4, rtol=3e-4)


@pytest.mark.gpu
def test_reduced_danube_engine_on_card_matches_cpu(cuda):
    """h2o-danube-1.8b reduced (window and ring 64): turn 2's prompt of 72
    passes the window, so the card's flash masks keys in the suffix
    prefill and its decode reads a wrapped ring, as on the CPU."""
    cfg = get_config("h2o-danube-1.8b").reduced(num_layers=2, d_model=128)
    params = init_params(torch.Generator().manual_seed(0), cfg, torch.float32)

    def engine(device, p):
        store = KVStore(64e9, POLICIES["lcs"], cfg.kv_bytes_per_token)
        return RealExecutionEngine(cfg, p, store, max_len=128, dtype=torch.float32,
                                   device=device)

    rng = np.random.default_rng(1)
    ctx = [int(t) for t in rng.integers(0, cfg.vocab_size, 48)]
    extra = [int(t) for t in rng.integers(0, cfg.vocab_size, 20)]
    results = {}
    for device, p in (("cpu", params), (cuda, _to(params, cuda))):
        eng = engine(device, p)
        f0, d0 = ops.flash_attention.launches, ops.decode_attention.launches
        r1 = eng.generate("c", ctx, num_new=4)
        r2 = eng.generate("c", ctx + r1.tokens + extra, num_new=4)
        results[str(device)] = (r1, r2, ops.flash_attention.launches - f0,
                                ops.decode_attention.launches - d0)
    (c1, c2, *_), (g1, g2, flash, decode) = results["cpu"], results[str(cuda)]
    assert len(ctx) + 4 + len(extra) > cfg.window_size == eng.width
    assert (flash, decode) == (2 * cfg.num_layers, 2 * 4 * cfg.num_layers)
    assert (g2.reused_tokens, g2.prefill_tokens_computed) == (48, 24)
    for c, g in ((c1, g1), (c2, g2)):
        assert (g.tokens, g.reused_tokens) == (c.tokens, c.reused_tokens)
        np.testing.assert_allclose(g.last_logits.cpu().numpy(),
                                   c.last_logits.numpy(), atol=3e-4, rtol=3e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["dbrx-132b", "grok-1-314b"])
def test_moe_ffn_on_card_matches_oracle_and_cpu(cuda, arch):
    """The MoE module at a small size: with nothing dropped (capacity factor
    E/K) against ``moe_ffn_ref`` at the fp32 kernel tolerance and the bf16
    one scaled to the output; at capacity factor 0.5, where assignments
    drop, the card's drop fraction and output equal the CPU's."""
    cfg = get_config(arch).reduced(d_model=256)
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, cfg, torch.float32)
    x = torch.randn((2, 64, cfg.d_model), generator=gen)
    nodrop = dataclasses.replace(cfg, moe_capacity_factor=cfg.num_experts / cfg.experts_per_token)
    for dtype in (torch.float32, torch.bfloat16):
        pc = {k: v.to(cuda, torch.float32 if k == "router" else dtype) for k, v in p.items()}
        xc = x.to(cuda, dtype)
        y, aux = moe.moe_ffn(pc, xc, nodrop)
        want = moe.moe_ffn_ref(pc, xc, nodrop)
        assert abs(float(aux["dropped_frac"])) <= 1e-6
        scale = float(want.float().abs().max())
        assert float((y.float() - want.float()).abs().max()) <= cases.TOL[dtype] * scale
    drops = dataclasses.replace(cfg, moe_capacity_factor=0.5)
    y, aux = moe.moe_ffn({k: v.to(cuda) for k, v in p.items()}, x.to(cuda), drops)
    y0, aux0 = moe.moe_ffn(p, x, drops)
    assert float(aux["dropped_frac"]) == float(aux0["dropped_frac"]) > 0
    np.testing.assert_allclose(y.cpu().numpy(), y0.numpy(), atol=3e-4, rtol=3e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["dbrx-132b", "grok-1-314b"])
def test_reduced_moe_engine_on_card_matches_cpu(cuda, arch):
    """The reduced demo (2 layers, d_model 128, 4 experts top-2) at the
    published capacity: the card's greedy tokens, reuse and logits are the
    CPU's, with one flash launch per layer and prefill and one decode launch
    per layer and token."""
    cfg, on_cpu = serve.build_engine(arch, device="cpu", reduced=True)
    _, on_card = serve.build_engine(arch, device=cuda, reduced=True,
                                    params=_to(on_cpu.params, cuda))
    _, c1, c2 = serve.two_turns(cfg, on_cpu, True)
    before = {n: getattr(ops, n).launches for n in ops.__all__}
    _, g1, g2 = serve.two_turns(cfg, on_card, True)
    launched = {n: getattr(ops, n).launches - before[n] for n in ops.__all__}
    num_new = serve.REDUCED_TURNS[2]
    assert launched == {"flash_attention": 2 * cfg.num_layers,
                        "decode_attention": 2 * num_new * cfg.num_layers,
                        "rglru_scan": 0, "rglru_step": 0, "wkv6": 0,
                        "flash_attention_bwd": 0, "wkv6_bwd": 0,
                        "rglru_scan_bwd": 0}
    for c, g in ((c1, g1), (c2, g2)):
        assert (g.tokens, g.reused_tokens) == (c.tokens, c.reused_tokens)
        np.testing.assert_allclose(g.last_logits.cpu().numpy(),
                                   c.last_logits.numpy(), atol=3e-4, rtol=3e-4)


@pytest.mark.gpu
def test_reduced_rwkv6_engine_on_card_matches_cpu(cuda):
    cfg, on_cpu = serve.build_engine("rwkv6-1.6b", device="cpu", reduced=True)
    _, on_card = serve.build_engine("rwkv6-1.6b", device=cuda, reduced=True,
                                    params=_to(on_cpu.params, cuda))
    _, c1, c2 = serve.two_turns(cfg, on_cpu, True)
    n = ops.wkv6.launches
    _, g1, g2 = serve.two_turns(cfg, on_card, True)
    ctx, new, num_new, _ = serve.REDUCED_TURNS
    # every fed prompt token and every decoded token is one step per layer
    steps = (ctx + num_new) + (num_new + new + num_new)
    assert ops.wkv6.launches - n == steps * cfg.num_layers
    for c, g in ((c1, g1), (c2, g2)):
        assert (g.tokens, g.reused_tokens) == (c.tokens, c.reused_tokens)
        np.testing.assert_allclose(g.last_logits.cpu().numpy(),
                                   c.last_logits.numpy(), atol=5e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("num_layers", [2, 4])
def test_reduced_griffin_engine_on_card_matches_cpu(cuda, num_layers):
    """2 layers (the --reduced demo) are two tail recurrent layers; the 4 of
    the reference's tests add one unit, whose local attention runs the
    decode kernel over a ring of 32 slots that the conversation passes."""
    cfg = get_config("recurrentgemma-2b").reduced(num_layers=num_layers, d_model=128)
    params = init_params(torch.Generator().manual_seed(0), cfg, torch.float32)

    def engine(device, p):
        store = KVStore(64e9, POLICIES["lcs"], cfg.kv_bytes_per_token)
        return RealExecutionEngine(cfg, p, store, max_len=serve.REDUCED_TURNS[3],
                                   dtype=torch.float32, device=device)

    _, c1, c2 = serve.two_turns(cfg, engine("cpu", params), True)
    before = {n: getattr(ops, n).launches for n in ops.__all__}
    _, g1, g2 = serve.two_turns(cfg, engine(cuda, _to(params, cuda)), True)
    launched = {n: getattr(ops, n).launches - before[n] for n in ops.__all__}
    ctx, new, num_new, _ = serve.REDUCED_TURNS
    steps = (ctx + num_new) + (num_new + new + num_new)
    units, tail = griffin_layout(cfg)
    # per fed or decoded token: one fused rglru step per recurrent layer, one
    # decode-attention launch per unit
    assert launched == {"flash_attention": 0, "decode_attention": steps * units,
                        "rglru_scan": 0, "rglru_step": steps * (2 * units + tail),
                        "wkv6": 0, "flash_attention_bwd": 0, "wkv6_bwd": 0,
                        "rglru_scan_bwd": 0}
    for c, g in ((c1, g1), (c2, g2)):
        assert (g.tokens, g.reused_tokens) == (c.tokens, c.reused_tokens)
        np.testing.assert_allclose(g.last_logits.cpu().numpy(),
                                   c.last_logits.numpy(), atol=5e-4)


@pytest.mark.gpu
def test_reduced_vlm_engine_on_card_matches_cpu(cuda):
    """qwen2-vl-2b's reduced demo on its token path: the card's greedy
    tokens, reuse and logits are the CPU's, one flash launch per layer and
    prefill and one decode launch per layer and token."""
    cfg, on_cpu = serve.build_engine("qwen2-vl-2b", device="cpu", reduced=True)
    _, on_card = serve.build_engine("qwen2-vl-2b", device=cuda, reduced=True,
                                    params=_to(on_cpu.params, cuda))
    _, c1, c2 = serve.two_turns(cfg, on_cpu, True)
    before = {n: getattr(ops, n).launches for n in ops.__all__}
    _, g1, g2 = serve.two_turns(cfg, on_card, True)
    launched = {n: getattr(ops, n).launches - before[n] for n in ops.__all__}
    num_new = serve.REDUCED_TURNS[2]
    assert launched == {"flash_attention": 2 * cfg.num_layers,
                        "decode_attention": 2 * num_new * cfg.num_layers,
                        "rglru_scan": 0, "rglru_step": 0, "wkv6": 0,
                        "flash_attention_bwd": 0, "wkv6_bwd": 0,
                        "rglru_scan_bwd": 0}
    for c, g in ((c1, g1), (c2, g2)):
        assert (g.tokens, g.reused_tokens) == (c.tokens, c.reused_tokens)
        np.testing.assert_allclose(g.last_logits.cpu().numpy(),
                                   c.last_logits.numpy(), atol=3e-4, rtol=3e-4)


@pytest.mark.gpu
def test_reduced_encdec_prefill_and_steps_on_card_match_cpu(cuda):
    """seamless-m4t-large-v2 reduced (2 decoder layers, 1 encoder layer over
    16 frames): prefill and three decode steps on the card against the CPU,
    logits and all four cache tensors, with the encoder's, the
    self-attention's and the cross-attention's launches counted."""
    cfg = get_config("seamless-m4t-large-v2").reduced(num_layers=2, d_model=128)
    params = init_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 15), generator=gen),
             "frames": 0.02 * torch.randn((2, cfg.source_len, cfg.d_model),
                                          generator=gen)}
    results = {}
    for device, p in (("cpu", params), (cuda, _to(params, cuda))):
        b = _to(batch, device)
        before = {n: getattr(ops, n).launches for n in ops.__all__}
        logits, cache = tt.prefill(p, cfg, dict(b, tokens=b["tokens"][:, :12]), 32)
        steps = [tt.decode_step(p, cfg, cache, b["tokens"][:, t:t + 1], t)[0]
                 for t in (12, 13, 14)]
        launched = {n: getattr(ops, n).launches - before[n] for n in ops.__all__}
        results[str(device)] = (logits, cache, steps, launched)
    (c_logits, c_cache, c_steps, _), (g_logits, g_cache, g_steps, launched) = \
        results["cpu"], results[str(cuda)]
    assert launched == {"flash_attention": cfg.encoder_layers + 2 * cfg.num_layers,
                        "decode_attention": 3 * 2 * cfg.num_layers,
                        "rglru_scan": 0, "rglru_step": 0, "wkv6": 0,
                        "flash_attention_bwd": 0, "wkv6_bwd": 0,
                        "rglru_scan_bwd": 0}
    for c, g in [(c_logits, g_logits)] + list(zip(c_steps, g_steps)) + \
            [(c_cache[k], g_cache[k]) for k in c_cache]:
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), atol=3e-4, rtol=3e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", cases.FLASH_BWD + list(cases.FLASH_BWD_TRAIN.values()))
def test_flash_bwd_kernel_matches_plain(cuda, dtype, case):
    """Autograd of ops.flash_attention on the card: one forward launch and
    one call of the backward entry, dq, dk, dv within cases.TOL."""
    n, m = ops.flash_attention.launches, ops.flash_attention_bwd.launches
    cases.check_flash_bwd(case, dtype, cuda)
    torch.cuda.synchronize()
    assert (ops.flash_attention.launches, ops.flash_attention_bwd.launches) == (n + 1, m + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", cases.FLASH_BWD + [c for c, _ in cases.FLASH_IDENTITY]
                         + list(cases.FLASH_BWD_TRAIN.values()))
def test_flash_train_entry_matches_serving_entry_and_plain_lse(cuda, dtype, case):
    """The training entry: the serving entry's output bit for bit, its lse
    within cases.TOL of the plain version's; both launches counted in
    flash_attention.launches."""
    n = ops.flash_attention.launches
    cases.check_flash_train(case, dtype, cuda)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == n + 2


@pytest.mark.gpu
@pytest.mark.parametrize("keys", [64, 128])
@pytest.mark.parametrize("case", [c for c in cases.FLASH_BWD if c[5] <= 128])
def test_flash_bwd_either_key_block_matches_plain(cuda, keys, case):
    """The tensor-core route with dK/dV blocks of 64 and of 128 keys,
    whichever the mask would choose: dq, dk, dv within cases.TOL."""
    cases.check_flash_bwd_keys(case, keys, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", cases.FLASH_BWD + list(cases.FLASH_BWD_TRAIN.values()))
def test_flash_bwd_kernel_gives_the_same_bits_twice(cuda, dtype, case):
    """Two backward calls on the same inputs: the same dq, dk, dv bits (no
    atomics on either route)."""
    cases.check_flash_bwd_repeat(case, dtype, cuda)


BWD_TF32 = ("flash_bwd_dq_tf32_kernel", "flash_bwd_dkdv_tf32_kernel")
BWD_BF16 = ("flash_bwd_dq_mma_kernel", "flash_bwd_dkdv_mma_kernel", "flash_bwd_dq_wide_kernel",
            "flash_bwd_dkdv_wide_kernel")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [cases.FLASH_BWD_TRAIN["100M twin"],
                                  (1, 32, 4, 37, 141, 128, 104, 24, True),
                                  (1, 8, 2, 33, 31, 80, 0, None, False)])
def test_flash_bwd_runs_its_routes_device_kernels(cuda, dtype, case):
    """The profiler's device kernels of backward calls (a whole window,
    launch/device_time.py): fp32 runs the split-TF32 kernels, one launch
    each a call, and no bf16 one; bf16 runs its tensor-core kernels and
    never the fp32 ones."""
    from repro_torch.launch import device_time
    q, k, v, dout = cases.flash_bwd_inputs(case, dtype, cuda)
    kw = dict(q_offset=case[6], window=case[7], causal=case[8])
    out, lse = ops.flash_attention_train(q, k, v, **kw)
    _, calls = device_time.device_ms(
        lambda *t: ops.flash_attention_bwd(*t, lse=lse, **kw), [[q, k, v, out, dout]], 2)
    ran = {name: [n for n in calls if name in n] for name in BWD_TF32 + BWD_BF16}
    if dtype == torch.float32:
        assert all(len(ran[name]) == 1 and calls[ran[name][0]][0] == 2 for name in BWD_TF32)
        assert not any(ran[name] for name in BWD_BF16), calls
    else:
        assert any(ran[name] for name in BWD_BF16) and not any(ran[n] for n in BWD_TF32), calls


def _guarded_calls(cuda):
    q, k, v, valid = cases.decode_inputs(cases.DECODE_SWEEP[0], torch.float32, cuda)
    return {"decode_attention": (ops.decode_attention, [q, k, v, valid], 0),
            "rglru_step": (ops.rglru_step, cases.rglru_step_inputs(cases.RGLRU_STEP[3], cuda),
                           5)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["decode_attention", "rglru_step"])
def test_kernel_without_backward_refuses_grad_on_card(cuda, name):
    """An input that requires grad, with grad enabled, raises (naming the
    backward's state) and launches nothing; under no_grad it launches."""
    fn, inputs, i = _guarded_calls(cuda)[name]
    inputs[i] = inputs[i].detach().requires_grad_(True)
    n = getattr(ops, name).launches
    with pytest.raises(RuntimeError, match=f"{name} has no backward kernel"):
        fn(*inputs)
    assert getattr(ops, name).launches == n
    with torch.no_grad():
        fn(*inputs)
    torch.cuda.synchronize()
    assert getattr(ops, name).launches == n + 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", cases.WKV6_BWD + list(cases.WKV6_BWD_TRAIN.values()))
def test_wkv6_bwd_kernel_matches_plain_and_repeats(cuda, case):
    """dr, dk, dv, dw, du and ds0 through autograd of ops.wkv6 (the training
    entry, then the backward kernel) against ref.wkv6_bwd_ref, fp32 ones
    within WKV6_TOL and bf16 ones within TOL[bf16]; two backward calls on
    the same inputs give the same bits (no atomics)."""
    n = ops.wkv6_bwd.launches
    cases.check_wkv6_bwd(case, cuda)
    cases.check_wkv6_bwd_repeat(case, cuda)
    torch.cuda.synchronize()
    assert ops.wkv6_bwd.launches == n + (3 if case[0] * case[1] else 0)


@pytest.mark.gpu
def test_recurrent_bwd_plans(cuda):
    """The C side's plans of the two backwards: wkv6 at rwkv6-1.6b's training
    shape runs 4 blocks a head and two launches (the sweep, then the sum of
    dv's partials, which the scratch holds), one launch and no scratch at
    S = 0; the RG-LRU backward one launch and no scratch up to one chunk of
    128 steps, past it two and a (carry, product) pair per chunk and
    channel; both refuse a shape their launch refuses."""
    from repro_torch.kernels import rglru, wkv6
    assert wkv6.bwd_plan(1, 32, 4096, 64) == (2, 32 * 4 * 4096 * 64)
    assert wkv6.bwd_plan(2, 3, 50, 80) == (2, 6 * 16 * 50 * 80)
    assert wkv6.bwd_plan(1, 2, 0, 32) == (1, 0)
    assert rglru.bwd_plan(1, 8192, 2560) == (2, 2 * 64 * 2560)
    assert rglru.bwd_plan(2, 128, 64) == (1, 0)
    assert rglru.bwd_plan(2, 129, 96) == (2, 2 * 2 * 2 * 96)
    for bad in ((1, 2, 16, 129), (0, 2, 16, 64)):
        with pytest.raises(ValueError):
            wkv6.bwd_plan(*bad)
    with pytest.raises(ValueError):
        rglru.bwd_plan(1, 16, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", WKV6_CASES + list(cases.WKV6_BWD_TRAIN.values()))
def test_wkv6_train_entry_matches_serving_entry_and_plain_checkpoints(cuda, case):
    """The training entry's y and s_n are the serving entry's bit for bit;
    its checkpoints are ref.wkv6_train_ref's within WKV6_TOL."""
    cases.check_wkv6_train(case, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("case", cases.RGLRU_BWD + list(cases.RGLRU_BWD_TRAIN.values()))
def test_rglru_bwd_kernel_matches_plain_and_repeats(cuda, case):
    """da, db and dh0 through autograd of ops.rglru_scan against
    ref.rglru_scan_bwd_ref within RGLRU_TOL; two calls the same bits."""
    n = ops.rglru_scan_bwd.launches
    cases.check_rglru_bwd(case, cuda)
    cases.check_rglru_bwd_repeat(case, cuda)
    torch.cuda.synchronize()
    assert ops.rglru_scan_bwd.launches == n + 3


@pytest.mark.gpu
@pytest.mark.parametrize("arch,layers", [("rwkv6-1.6b", 2), ("recurrentgemma-2b", 4)])
def test_reduced_recurrent_train_step_on_card_matches_cpu(cuda, arch, layers):
    """loss_fn's loss and every gradient of a reduced fp32 rwkv6-1.6b (2
    layers) and recurrentgemma-2b (4: one unit and a tail layer) on the card
    against the CPU's from the same weights, within 3e-4 of each gradient's
    largest entry (the port's fp32 model tolerance); per step two launches
    of each recurrent and attention forward (the forward and remat's
    recompute) and one backward per call."""
    cfg = get_config(arch).reduced(num_layers=layers, d_model=64)
    params = init_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    batch = next(batch_iterator(cfg, 2, 72, seed=0))
    out = {}
    for device, p in (("cpu", params), (cuda, _to(params, cuda))):
        p = tree.map_leaves(p, lambda t: t.detach().clone().requires_grad_(True))
        leaves = tree.leaves(p)
        before = {n: getattr(ops, n).launches for n in ops.__all__}
        loss, _ = loss_fn(p, cfg, batch_to(batch, device))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        launched = {n: getattr(ops, n).launches - before[n] for n in ops.__all__}
        out[str(device)] = (loss.detach().cpu(), [None if g is None else g.cpu()
                                                  for g in grads], launched)
    (lc, gc, _), (lg, gg, launched) = out["cpu"], out[str(cuda)]
    if cfg.family == "ssm":
        want = {"wkv6": 2 * cfg.num_layers, "wkv6_bwd": cfg.num_layers}
    else:
        units, tail = griffin_layout(cfg)
        want = {"rglru_scan": 2 * (2 * units + tail), "rglru_scan_bwd": 2 * units + tail,
                "flash_attention": 2 * units, "flash_attention_bwd": units}
    assert launched == dict({n: 0 for n in ops.__all__}, **want)
    np.testing.assert_allclose(float(lg), float(lc), rtol=3e-4)
    names = [k for k, _ in tree.items(params)]
    for name, c, g in zip(names, gc, gg):
        assert (c is None) == (g is None), name
        if c is not None:
            scale = max(float(c.abs().max()), 1e-30)
            np.testing.assert_allclose(g.numpy(), c.numpy(), rtol=3e-4, atol=3e-4 * scale,
                                       err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "dbrx-132b", "qwen2-vl-2b",
                                  "seamless-m4t-large-v2"])
def test_reduced_train_step_on_card_matches_cpu(cuda, arch):
    """One fp32 train step of a reduced attention-family model on the card
    and on the CPU from the same weights: loss and grad norm within 3e-4
    (the port's fp32 model tolerance), two flash launches per attention
    call (the forward and remat's recompute) and one backward call."""
    cfg = get_config(arch).reduced(num_layers=2, d_model=64)
    params = init_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    batch = next(batch_iterator(cfg, 2, 72, seed=0))
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, total_steps=10, warmup_steps=1))
    # attention calls per forward: self (and an enc-dec decoder's cross) per
    # layer, and the encoder's
    calls = cfg.num_layers * (2 if cfg.family == "encdec" else 1) + cfg.encoder_layers
    out = {}
    for device, p in (("cpu", params), (cuda, _to(params, cuda))):
        p = tree.map_leaves(p, lambda t: t.detach().clone())
        before = {n: getattr(ops, n).launches for n in ops.__all__}
        _, _, m = step(p, adamw_init(p), batch_to(batch, device))
        out[str(device)] = (m, {n: getattr(ops, n).launches - before[n] for n in ops.__all__})
    (mc, _), (mg, launched) = out["cpu"], out[str(cuda)]
    # the encoder is not rematerialised: its layers' flash runs once
    assert launched == {"flash_attention": 2 * calls - cfg.encoder_layers,
                        "flash_attention_bwd": calls, "decode_attention": 0,
                        "rglru_scan": 0, "rglru_step": 0, "wkv6": 0, "wkv6_bwd": 0,
                        "rglru_scan_bwd": 0}
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(mg[k]), float(mc[k]), rtol=3e-4)


@pytest.mark.gpu
def test_forward_under_inference_mode_on_card_launches_as_before(cuda):
    cfg = get_config("h2o-danube-1.8b").reduced(num_layers=2, d_model=64)
    params = _to(init_params(torch.Generator().manual_seed(0), cfg, torch.float32), cuda)
    batch = batch_to(next(batch_iterator(cfg, 2, 72, seed=0)), cuda)
    for p in tree.leaves(params):
        p.requires_grad_(True)
    before = {n: getattr(ops, n).launches for n in ops.__all__}
    with torch.inference_mode():
        out = tt.forward(params, cfg, batch)
    launched = {n: getattr(ops, n).launches - before[n] for n in ops.__all__}
    assert not out.requires_grad
    assert launched == dict({n: 0 for n in ops.__all__}, flash_attention=cfg.num_layers)
