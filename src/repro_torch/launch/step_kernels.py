"""Device kernels, device time and host time per decode step of the
recurrent models, and of their bf16 prefill, on the card.

    PYTHONPATH=src python -m repro_torch.launch.step_kernels [--steps N]

For rwkv6-1.6b and recurrentgemma-2b at full width in bf16 on random
weights (``torch.Generator`` seed 0), feeds ``--warmup`` tokens through
``decode_step`` from the empty state, as the state-snapshot engine feeds
every uncached token, then times ``--steps`` more three times by the host
clock and by the process's CPU time (each run ending in
``torch.cuda.synchronize()``), then profiles ``--steps`` more by
``device_time.device_ms``, the rule ``chip_smoke.py`` reads device time by
(behind a ~5 ms spin kernel, whole windows only, ten tries). Prints per
model and step: host ms and CPU ms (the three runs; on a shared host the CPU
time varies less), device kernels and other device operations (copies,
fills) the profiler records, device busy ms, and the kernels with the most
device time with their launches per step; the recurrence must have run one
launch per recurrent layer and step. Then the model phase's bf16 ``prefill`` of
``PREFILL`` tokens (as ``chip_smoke.py`` times it): host ms of three runs
after a warm-up, and the device busy ms of a fourth under the profiler.
Ends with the card's name and power limit.

It uses only entry points that every slice of the port has had, and
``device_time``, so two trees can be compared on one card by running this
file with the other tree's ``src`` on ``PYTHONPATH``, once this tree's
``device_time.py`` is copied into that tree's ``repro_torch/launch/``:

    PYTHONPATH=<other tree>/src python3 src/repro_torch/launch/step_kernels.py
"""
from __future__ import annotations

import argparse
import subprocess
import time

import torch

from repro_torch.launch import device_time

ARCHS = ("rwkv6-1.6b", "recurrentgemma-2b")
PREFILL = {"rwkv6-1.6b": 2048, "recurrentgemma-2b": 2560}   # chip_smoke.py's lengths
# the recurrence's device kernels, one launch per recurrent layer and step
RECURRENCE = ("wkv6", "rglru")


def _steps(tt, params, cfg, cache, pos: int, n: int, gen):
    toks = torch.randint(0, cfg.vocab_size, (n, 1, 1), device="cuda", generator=gen)
    for t in range(n):
        _, cache = tt.decode_step(params, cfg, cache, toks[t], pos + t)
    return cache


def _recurrent_layers(cfg, tt) -> int:
    if cfg.family == "ssm":
        return cfg.num_layers
    units, tail = tt.griffin_layout(cfg)
    return 2 * units + tail


def profile_steps(tt, params, cfg, cache, pos: int, n: int, gen):
    """Device operations of ``n`` decode steps, by name: (launches, ms per
    step), from a whole profiler window (``device_time.device_ms``); the
    recurrence must have run one launch per recurrent layer and step."""
    tries = device_time.WINDOWS + device_time.SESSIONS
    per_try = n + device_time.LEAD_CALLS
    toks = torch.randint(0, cfg.vocab_size, (tries * per_try + 1, 1, 1), device="cuda",
                         generator=gen)       # the warm-up step and every try
    state = {"cache": cache, "t": 0}

    def step():
        t = state["t"]
        _, state["cache"] = tt.decode_step(params, cfg, state["cache"], toks[t], pos + t)
        state["t"] = t + 1

    _, by_name = device_time.device_ms(step, [()], n)
    rec = sum(c for name, (c, _) in by_name.items() if any(k in name for k in RECURRENCE))
    if rec != n * _recurrent_layers(cfg, tt):
        raise AssertionError(f"{rec} recurrence launches in {n} steps, want "
                             f"{n * _recurrent_layers(cfg, tt)}")
    return by_name


def prefill_ms(tt, params, cfg, n: int, gen):
    """Log three host-timed bf16 prefills of ``n`` tokens after a warm-up,
    and the device busy ms of a fourth under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, n), device="cuda",
                                     generator=gen)}
    with torch.inference_mode():
        tt.prefill(params, cfg, batch, max_len=n)                 # warm-up
        host = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tt.prefill(params, cfg, batch, max_len=n)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            tt.prefill(params, cfg, batch, max_len=n)
            torch.cuda.synchronize()
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3
    print(f"{cfg.name}: bf16 prefill of {n} tokens, host {', '.join(f'{t:.3f}' for t in host)}"
          f" ms; device busy {busy:.3f} ms", flush=True)


def run(arch: str, warmup: int, steps: int, top: int):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tt

    cfg = get_config(arch)
    params = tt.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                            torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.inference_mode():
        cache = tt.init_cache(cfg, 1, 1024, torch.bfloat16, "cuda")
        cache = _steps(tt, params, cfg, cache, 0, warmup, gen)
        pos = warmup
        host, cpu = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), time.process_time()
            cache = _steps(tt, params, cfg, cache, pos, steps, gen)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3 / steps)
            cpu.append((time.process_time() - c0) * 1e3 / steps)
            pos += steps
        by_name = profile_steps(tt, params, cfg, cache, pos, steps, gen)
    copies = {n: v for n, v in by_name.items() if n.startswith(("Memcpy", "Memset"))}
    kernels = {n: v for n, v in by_name.items() if n not in copies}
    busy = sum(ms for _, ms in by_name.values())
    print(f"{arch}: per decode step, host {', '.join(f'{t:.3f}' for t in host)} ms, CPU "
          f"{', '.join(f'{t:.3f}' for t in cpu)} ms; "
          f"device kernels {sum(c for c, _ in kernels.values()) / steps:.2f}, other "
          f"device operations {sum(c for c, _ in copies.values()) / steps:.2f}; device "
          f"busy {busy:.5f} ms", flush=True)
    for name, (c, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"  {ms:9.5f} ms {c / steps:6.2f} per step  {name[:100]}")
    del cache
    prefill_ms(tt, params, cfg, PREFILL[arch], gen)
    del params
    torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_kernels: no CUDA device")
    for arch in ARCHS:
        run(arch, args.warmup, args.steps, args.top)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
