"""Smoke run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py

1. Setup: card name and power limit, torch and nvcc versions; builds the
   CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc per source,
   in parallel) and times the build. TF32 is off for matmuls and cuDNN.
2. Kernels: each CUDA kernel against its plain PyTorch version, fp32 and
   bf16, at the sweep, ragged and empty-band shapes of
   ``repro_torch/kernels/cases.py`` and at every shape the main path gives
   it, with the tolerance stated there (2e-5 fp32, 2e-2 bf16, the absolute
   term scaled to the output). For each: kernel time, plain time,
   ``library_ms`` (``F.scaled_dot_product_attention`` on the same masked GQA
   problem, a yardstick only: the port never calls it) and the least time
   the card could take, max(operations / peak rate, bytes / 3.35 TB/s),
   with the term that binds. Times rotate over copies of the inputs that
   together exceed the 50 MB L2 cache, as each layer of the model reads its
   own inputs.
3. Engine: full-width yi-6b in bf16 on random weights (``torch.Generator``
   seed 0), ``max_len`` 4096: a 2,048-token context, then the same context
   plus the 8 generated and 504 new tokens, which must reuse 2,048 tokens
   and prefill 512. Launch counters are set to 0 just before and read just
   after. A cold engine on the turn-2 prompt must give the same greedy
   tokens, and last-position logits within the bf16 kernel tolerance scaled
   by the largest logit it measures. Then a profile of a replay of turn 2.
4. Prints a ``kernels`` JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero. Without a card, or without the rest
of the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_BYTES = 3.35e12                      # H100 SXM HBM3, bytes/s
PEAK_OPS = {torch.bfloat16: 989e12,       # dense tensor-core bf16
            torch.float32: 67e12}         # fp32 outside the tensor cores
L2_BYTES = 50e6
DTYPES = (torch.float32, torch.bfloat16)
SOURCES = {"flash_attention": "src/repro/kernels/flash_attention.py:106",
           "decode_attention": "src/repro/kernels/decode_attention.py:77"}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def rotated_ms(fn, sets, iters: int) -> float:
    """Mean ms of ``fn(*s)`` by CUDA events, cycling over the input sets."""
    for s in sets[:3]:
        fn(*s)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def copies(tensors):
    """Clones of the inputs, enough of them to exceed twice the L2 cache."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = max(1, min(16, math.ceil(2 * L2_BYTES / nbytes)))
    return [tensors] + [[t.clone() for t in tensors] for _ in range(n - 1)]


def bound(ops_n: float, nbytes: float, dtype):
    t_ops, t_bytes = ops_n / PEAK_OPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


# --------------------------------------------------------------------------- #
# kernels
# --------------------------------------------------------------------------- #

def flash_row(ops, ref, cases, case, dtype):
    err, (q, k, v) = cases.check_flash(case, dtype, "cuda")
    B, H, KV, Sq, Sk, hd, off, win, causal = case
    qpos = off + torch.arange(Sq, device="cuda")[:, None]
    kpos = torch.arange(Sk, device="cuda")[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device="cuda")
    if causal:
        mask &= kpos <= qpos
    if win is not None:
        mask &= kpos > qpos - win
    kw = dict(q_offset=off, window=win, causal=causal)
    sets = copies([q, k, v])
    ms = rotated_ms(lambda *t: ops.flash_attention(*t, **kw), sets, 20)
    plain = rotated_ms(lambda *t: ref.flash_attention_ref(*t, **kw), sets, 10)
    lib = rotated_ms(lambda *t: F.scaled_dot_product_attention(
        *t, attn_mask=mask, enable_gqa=True), sets, 20)
    pairs, empty = cases.flash_visible(case)
    ops_n = B * H * (4 * hd * pairs + 2 * hd * Sk * empty)
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                **dict(zip(("bound_ms", "bound_by"), bound(ops_n, nbytes, dtype))))


def decode_row(ops, ref, cases, case, dtype):
    err, (q, k, v, valid) = cases.check_decode(case, dtype, "cuda")
    B, H, KV, W, hd, nvalid, _ = case
    mask = valid.bool()[None, None, None, :]
    sets = copies([q, k, v, valid])
    ms = rotated_ms(ops.decode_attention, sets, 50)
    plain = rotated_ms(ref.decode_attention_ref, sets, 20)
    lib = rotated_ms(lambda q_, k_, v_, _: F.scaled_dot_product_attention(
        q_[:, :, None], k_, v_, attn_mask=mask, enable_gqa=True), sets, 50)
    slots = nvalid or W                   # no valid slot: the mean of all W
    ops_n = B * H * (4 if nvalid else 2) * hd * slots
    nbytes = q.element_size() * (2 * q.numel() + 2 * B * KV * slots * hd) + 4 * W
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                **dict(zip(("bound_ms", "bound_by"), bound(ops_n, nbytes, dtype))))


def main_path_shapes(cfg, serve):
    """Every shape the two-turn conversation (and the cold engine) gives
    each kernel. Flash: turn 1's cold prefill, turn 2's suffix prefill, the
    cold engine's prefill of the turn-2 prompt. Decode: the last step of
    turn 2, over the whole ring."""
    ctx, new, num_new, max_len = serve.FULL_TURNS
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    n2 = ctx + num_new + new
    flash = {"turn 1": (1, H, KV, ctx, ctx, hd, 0, None, True),
             "turn 2": (1, H, KV, n2 - ctx, n2, hd, ctx, None, True),
             "cold": (1, H, KV, n2, n2, hd, 0, None, True)}
    decode = {"turn 2": (1, H, KV, max_len, hd, n2 + num_new, 0)}
    return flash, decode


def kernels_phase(ops, ref, cases, flash_main, decode_main):
    """All rows, keyed by (kernel, dtype, label)."""
    rows = {}
    for dtype in DTYPES:
        for group, table in (("sweep", cases.FLASH_SWEEP), ("ragged", cases.FLASH_RAGGED),
                             ("empty band", cases.FLASH_EMPTY_BAND)):
            for i, case in enumerate(table):
                rows[("flash_attention", dtype, f"{group} {i}")] = (
                    case, flash_row(ops, ref, cases, case, dtype))
        for label, case in flash_main.items():
            rows[("flash_attention", dtype, label)] = (
                case, flash_row(ops, ref, cases, case, dtype))
        for group, table in (("sweep", cases.DECODE_SWEEP), ("ragged", cases.DECODE_RAGGED)):
            for i, case in enumerate(table):
                rows[("decode_attention", dtype, f"{group} {i}")] = (
                    case, decode_row(ops, ref, cases, case, dtype))
        for label, case in decode_main.items():
            rows[("decode_attention", dtype, label)] = (
                case, decode_row(ops, ref, cases, case, dtype))
    for (name, dtype, label), (case, r) in rows.items():
        log(f"{name} {str(dtype)[6:]} {label} {case}: max |err| {r['max_abs_err']:.3e}, "
            f"kernel {r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms, "
            f"sdpa {r['library_ms']:.5f} ms, bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']})")
    return rows


# --------------------------------------------------------------------------- #
# engine
# --------------------------------------------------------------------------- #

def engine_phase(serve, ops, cases):
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, eng = serve.build_engine("yi-6b", device="cuda")
    torch.cuda.synchronize()
    log(f"yi-6b full width: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, hd {cfg.head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}; {str(eng.dtype)[6:]} weights drawn in "
        f"{time.perf_counter() - t0:.3f} s")

    ops.flash_attention.launches = 0
    ops.decode_attention.launches = 0
    ctx2, r1, r2 = serve.two_turns(cfg, eng, False)
    launches = {"flash_attention": ops.flash_attention.launches,
                "decode_attention": ops.decode_attention.launches}

    ctx_len, new_len, num_new, _ = serve.FULL_TURNS
    L = cfg.num_layers
    if r1.reused_tokens != 0 or r2.reused_tokens != ctx_len \
            or r2.prefill_tokens_computed != num_new + new_len:
        raise AssertionError(f"reuse: turn 1 {r1.reused_tokens}, turn 2 "
                             f"{r2.reused_tokens}/{r2.prefill_tokens_computed}")
    # one flash launch per layer and prefill, one decode launch per layer and token
    if launches != {"flash_attention": 2 * L, "decode_attention": 2 * num_new * L}:
        raise AssertionError(f"launch counts {launches}")
    for i, r in ((1, r1), (2, r2)):
        if len(r.tokens) != num_new or r.last_logits.shape != (cfg.vocab_size,) \
                or not bool(torch.isfinite(r.last_logits).all()):
            raise AssertionError(f"turn {i}: bad output")
        log(f"turn {i}: prefill {r.prefill_tokens_computed} tokens "
            f"(reused {r.reused_tokens}) in {r.prefill_time_s * 1e3:.3f} ms; "
            f"decode {num_new} tokens in {r.decode_time_s * 1e3:.3f} ms "
            f"({r.decode_time_s / num_new * 1e3:.3f} ms/token) -> {r.tokens}")
    log(f"launches on the main path: {launches}")
    log(f"peak memory allocated: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    _, cold = serve.build_engine("yi-6b", device="cuda", params=eng.params)
    rc = cold.generate("cold", ctx2, num_new=num_new)
    if rc.reused_tokens != 0:
        raise AssertionError("cold engine hit its empty store")
    # Hit and cold compute the same function on the same weights; they differ
    # in the kernels' shapes (Sq 512 against 2,560, so another order of fp32
    # sums) and in the cuBLAS kernels the two GEMM shapes pick, each rounding
    # to bf16. Hold them to the bf16 kernel tolerance, scaled to the logits.
    scale = float(rc.last_logits.abs().max())
    tol = cases.TOL[torch.bfloat16] * scale
    err = float((rc.last_logits - r2.last_logits).abs().max())
    log(f"hit vs cold, last-position logits: max |err| {err:.6f} (limit {tol:.6f} = "
        f"2e-2 x max |logit| {scale:.4f}); cold prefill {rc.prefill_time_s * 1e3:.3f} ms "
        f"for {rc.prefill_tokens_computed} tokens; tokens {rc.tokens}")
    if rc.tokens != r2.tokens or not err <= tol:
        raise AssertionError("hit path and cold path disagree")
    profile_turn2(serve, eng.params, ctx2)
    return launches


def profile_turn2(serve, params, ctx2):
    """Device time by kernel and the device's idle share over a replay of
    turn 2 (turn 1 served unprofiled first, so turn 2 hits)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg, eng = serve.build_engine("yi-6b", device="cuda", params=params)
    ctx_len, _, num_new, _ = serve.FULL_TURNS
    eng.generate("replay", ctx2[:ctx_len], num_new=num_new)
    t0 = time.perf_counter()
    r = eng.generate("replay", ctx2, num_new=num_new)
    log(f"unprofiled replay of turn 2: {(time.perf_counter() - t0) * 1e3:.3f} ms "
        f"(prefill {r.prefill_time_s * 1e3:.3f}, decode {r.decode_time_s * 1e3:.3f})")
    eng.generate("prof", ctx2[:ctx_len], num_new=num_new)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = eng.generate("prof", ctx2, num_new=num_new)
        wall_us = (time.perf_counter() - t0) * 1e6
    if r.reused_tokens != ctx_len:
        raise AssertionError("profiled replay of turn 2 missed the cache")
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    if not busy:
        log("profile of turn 2: the profiler saw no device time (not measured)")
        return
    log(f"profile of turn 2: window {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.4f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {us / 1e3:9.3f} ms {us / wall_us:7.2%}  {name[:100]}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, cases, ops, ref
    from repro_torch.launch import serve

    t_start = time.perf_counter()
    log(f"card: {card_line()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([build.nvcc_path(), "--version"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[-1]
    log(f"nvcc: {nvcc}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.3f} s")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    flash_main, decode_main = main_path_shapes(get_config("yi-6b"), serve)
    t0 = time.perf_counter()
    rows = kernels_phase(ops, ref, cases, flash_main, decode_main)
    log(f"kernels phase: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    launches = engine_phase(serve, ops, cases)
    log(f"engine phase: {time.perf_counter() - t0:.3f} s; "
        f"whole run {time.perf_counter() - t_start:.3f} s")

    kernels = []
    for name, replaces in SOURCES.items():
        _, r = rows[(name, torch.bfloat16, "turn 2")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
