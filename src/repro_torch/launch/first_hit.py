"""Where a process's first cache-hit prefill spends its time, on the card.

    PYTHONPATH=src python -m repro_torch.launch.first_hit [--no-profile]

Serves full-width yi-6b's two-turn conversation (``serve.FULL_TURNS``,
random bf16 weights from ``serve.SEED``) as ``chip_smoke.py`` does, then a
warm replay of it in the same process under another context key. Prints the
prefill time of the conversation's turn 2 (the process's first suffix
prefill: 512 tokens at q_offset 2,048) and of the replay's turn 2. By
default both turn-2 prefills run under the profiler, which adds host time of
its own; for each it prints the window, the device's busy time and idle
share, and the host calls that took the most time (self time, calls,
longest call). ``--no-profile`` prints the unprofiled times alone.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import torch

from repro_torch.launch import serve


def timed_prefill(eng, key, prompt, profile: bool):
    """Serve ``prompt`` under ``key`` with no decode; returns (prefill ms,
    window ms, profiler), the last two None unprofiled."""
    if not profile:
        return eng.generate(key, prompt, num_new=0).prefill_time_s * 1e3, None, None
    from torch.profiler import ProfilerActivity, profile as run_profiled
    with run_profiled(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = eng.generate(key, prompt, num_new=0)
        wall = (time.perf_counter() - t0) * 1e3
    return r.prefill_time_s * 1e3, wall, prof


def report(label, ms, wall, prof, top: int = 12):
    print(f"{label}: prefill {ms:.3f} ms")
    if prof is None:
        return
    from torch.autograd import DeviceType
    busy, host = 0.0, {}
    for e in prof.events():
        us = e.time_range.elapsed_us()
        if e.device_type == DeviceType.CUDA:
            busy += us
            continue
        total, n, longest = host.get(e.name, (0.0, 0, 0.0))
        host[e.name] = (total + e.self_cpu_time_total, n + 1, max(longest, us))
    print(f"  window {wall:.3f} ms, device busy {busy / 1e3:.3f} ms, "
          f"idle share {1 - busy / 1e3 / wall:.4f}")
    for name, (total, n, longest) in sorted(host.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  host {total / 1e3:9.3f} ms self {n:6d} calls, longest "
              f"{longest / 1e3:8.3f} ms  {name[:80]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-profile", action="store_true",
                    help="time the two prefills without the profiler")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("first_hit: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    cfg, eng = serve.build_engine("yi-6b", device="cuda")
    ctx, extra, num_new = serve.conversation(cfg, False)
    r1 = eng.generate("conv-0", ctx, num_new=num_new)
    ctx2 = ctx + r1.tokens + extra
    profile = not args.no_profile
    report("first turn-2 prefill", *timed_prefill(eng, "conv-0", ctx2, profile))
    eng.generate("replay", ctx, num_new=num_new)
    report("warm replay's turn-2 prefill", *timed_prefill(eng, "replay", ctx2, profile))


if __name__ == "__main__":
    main()
