"""Device time of the training kernels by kernel, at the training shapes,
on the card.

    python3 src/repro_torch/launch/bwd_kernels.py [--dtype float32 bfloat16]
        [--only flash recurrent]

flash: for every ``cases.FLASH_BWD_TRAIN`` shape and dtype, runs
``ops.flash_attention_bwd`` on the training entry's output and lse (the
inputs of ``cases.flash_bwd_inputs``), and the training entry
``ops.flash_attention_train`` on the same q, k, v. recurrent: the wkv6
training entry ``ops.wkv6_train`` and serving entry ``ops.wkv6`` at
``cases.WKV6_BWD_TRAIN`` (bf16 r, k, v) and at the fp32 prefill
``RWKV_PREFILL``, and the RG-LRU scan ``ops.rglru_scan`` at
``cases.RGLRU_BWD_TRAIN`` and at the prefill ``GRIFFIN_PREFILL``, each
rotated over ``COPIES`` copies of its inputs (more bytes than the L2
cache), with its event time a call beside the device time. Each line gives
the device time per call of each kernel a call launched, read by
``device_time.device_ms``, the rule ``chip_smoke.py`` reads device time by
(behind a ~5 ms spin kernel, whole windows only), and their sum. Ends with
the card's name and power limit.

It uses only entry points that every slice of the port since the
backward's has had, and ``device_time``, so two trees can be compared on
one card by running this file with the other tree's ``src`` on
``PYTHONPATH``, once this tree's ``device_time.py`` is copied into that
tree's ``repro_torch/launch/``:

    PYTHONPATH=<other tree>/src python3 src/repro_torch/launch/bwd_kernels.py
"""
from __future__ import annotations

import argparse
import re
import subprocess

import torch

from repro_torch.kernels import cases, ops
from repro_torch.launch import device_time

ITERS = 5
COPIES = 4
RWKV_PREFILL = (1, 32, 2048, 64, None, 0.1, "bshd", "fp32")    # rwkv6-1.6b's fp32 prefill
GRIFFIN_PREFILL = (1, 2560, 2560, "bsd")                       # recurrentgemma-2b's


def kernel_name(name: str) -> str:
    """A device kernel's name with its template arguments, without its
    namespaces and parameters."""
    m = re.search(r"\w+_kernel(<[^>]*>)?", name)
    return m.group(0) if m else name[:48]


def row(case, dtype):
    """{"backward" and "forward": (device ms per call, {kernel: ms per
    call})} at case: the backward, and the forward's training entry."""
    q, k, v, dout = cases.flash_bwd_inputs(case, dtype, "cuda")
    kw = dict(q_offset=case[6], window=case[7], causal=case[8])
    out, lse = ops.flash_attention_train(q, k, v, **kw)
    timed = {"backward": device_time.device_ms(
        lambda *t: ops.flash_attention_bwd(*t, lse=lse, **kw), [[q, k, v, out, dout]], ITERS),
        "forward": device_time.device_ms(
        lambda *t: ops.flash_attention_train(*t, **kw), [[q, k, v]], ITERS)}
    return {what: (ms, {kernel_name(n): c[1] for n, c in calls.items()})
            for what, (ms, calls) in timed.items()}


def event_ms(fn, sets, iters: int) -> float:
    """Mean ms a call of ``fn(*s)`` over the rotated sets, by CUDA events."""
    for s in sets:
        fn(*s)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def recurrent_rows():
    """[(label, event ms, device ms, {kernel: ms})] of the wkv6 entries and
    the RG-LRU scan at the training and prefill shapes."""
    rows = []
    wkv6 = {"training shape": cases.WKV6_BWD_TRAIN["rwkv6-1.6b"][:8],
            "fp32 prefill": RWKV_PREFILL}
    for label, case in wkv6.items():
        inputs = cases.wkv6_inputs(case, "cuda")
        sets = [inputs] + [[t.clone() for t in inputs] for _ in range(COPIES - 1)]
        for name, fn in (("wkv6_train", ops.wkv6_train), ("wkv6", ops.wkv6)):
            ms, calls = device_time.device_ms(fn, sets, ITERS)
            rows.append((f"{name} {label} {case}", event_ms(fn, sets, ITERS), ms,
                         {kernel_name(n): c[1] for n, c in calls.items()}))
        del inputs, sets
        torch.cuda.empty_cache()
    scans = {"training shape": cases.RGLRU_BWD_TRAIN["recurrentgemma-2b"][:4],
             "prefill": GRIFFIN_PREFILL}
    for label, case in scans.items():
        inputs = cases.rglru_inputs(case, "cuda")
        sets = [inputs] + [[t.clone() for t in inputs] for _ in range(COPIES - 1)]
        ms, calls = device_time.device_ms(ops.rglru_scan, sets, 2 * ITERS)
        rows.append((f"rglru_scan {label} {case}", event_ms(ops.rglru_scan, sets, 2 * ITERS),
                     ms, {kernel_name(n): c[1] for n, c in calls.items()}))
        del inputs, sets
        torch.cuda.empty_cache()
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", nargs="+", default=["float32", "bfloat16"])
    ap.add_argument("--only", nargs="+", choices=("flash", "recurrent"),
                    default=["flash", "recurrent"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bwd_kernels: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in (getattr(torch, d) for d in args.dtype if "flash" in args.only):
        for label, case in cases.FLASH_BWD_TRAIN.items():
            for what, (ms, split) in row(case, dtype).items():
                print(f"flash {what} {str(dtype)[6:]} {label} {case}: device {ms:.5f} ms a "
                      "call (" + ", ".join(f"{n} {t:.5f}" for n, t in split.items()) + ")",
                      flush=True)
            torch.cuda.empty_cache()
    if "recurrent" in args.only:
        for label, event, ms, split in recurrent_rows():
            print(f"{label}: event {event:.5f} ms a call, device {ms:.5f} ms a call ("
                  + ", ".join(f"{n} {t:.5f}" for n, t in split.items()) + ")", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
