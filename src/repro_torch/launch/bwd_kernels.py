"""Device time of the flash backward and of the forward's training entry by
kernel, at the training shapes, on the card.

    python3 src/repro_torch/launch/bwd_kernels.py [--dtype float32 bfloat16]

For every ``cases.FLASH_BWD_TRAIN`` shape and dtype, runs
``ops.flash_attention_bwd`` on the training entry's output and lse (the
inputs of ``cases.flash_bwd_inputs``), and the training entry
``ops.flash_attention_train`` on the same q, k, v, and reads the device
time per call of each kernel each launched by ``device_time.device_ms``,
the rule ``chip_smoke.py`` reads device time by (behind a ~5 ms spin
kernel, whole windows only): two lines a shape and dtype, the kernels' ms
per call and their sum. Ends with the card's name and power limit.

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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", nargs="+", default=["float32", "bfloat16"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bwd_kernels: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in (getattr(torch, d) for d in args.dtype):
        for label, case in cases.FLASH_BWD_TRAIN.items():
            for what, (ms, split) in row(case, dtype).items():
                print(f"flash {what} {str(dtype)[6:]} {label} {case}: device {ms:.5f} ms a "
                      "call (" + ", ".join(f"{n} {t:.5f}" for n, t in split.items()) + ")",
                      flush=True)
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
