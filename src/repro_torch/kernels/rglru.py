"""RG-LRU linear recurrence: wrapper of ``csrc/rglru_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/rglru.py`` (``rglru_scan`` /
``_rglru_kernel``): per (batch, channel), ``h_t = a_t * h_{t-1} + b_t`` from
``h0``, every ``h_t`` returned as ``y`` and the last as ``h_S``.

On the H100 the kernel is bound by bytes, ``4·(3·B·S·D + 2·B·D)`` at
3.35 TB/s: 0.015 µs at the engine's step (1,1,2560), where launch latency
decides, and 23 µs at a 2,560-token prefill (1,2560,2560). The CUDA kernel
gives each channel one thread, blocks of 256 channels over (d-block, batch),
coalesced along D, and loads ``a`` and ``b`` eight steps ahead so that only
the multiply-add chain is serial. At batch 1 and D 2,560 that is 10 blocks
for 132 SMs, so a long S sits far above the bound (see ``PERF.md``).

``a``, ``b`` and ``h0`` go by strides with the channel dimension contiguous,
so the model's tensors (the step's ``a[:, None]``, the cache's ``h`` rows)
are read in place; ``y`` is allocated in ``a``'s memory layout
(``torch.empty_like``), ``h_S`` contiguous. fp32 only, as the reference's
signature says; any ``D`` (no block size has to divide it), any ``S >= 0``
(at ``S = 0``, ``y`` is empty and ``h_S`` equals ``h0``), ``B`` up to 65,535.

A tensor on the CPU goes to the plain version (``ref.rglru_scan_ref``); a
CUDA tensor launches the kernel or raises. ``rglru_scan.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

MAX_BATCH = 65535          # the grid's y dimension


def _check(a, b, h0):
    if a.dim() != 3:
        raise ValueError(f"rglru_scan wants a, b (B,S,D); got a {tuple(a.shape)}")
    B, S, D = a.shape
    if b.shape != a.shape:
        raise ValueError(f"b {tuple(b.shape)} does not match a {tuple(a.shape)}")
    if h0.shape != (B, D):
        raise ValueError(f"want h0 ({B}, {D}); got {tuple(h0.shape)}")
    tensors = (a, b, h0)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("rglru_scan takes float32 only; got "
                        f"{', '.join(str(t.dtype) for t in tensors)}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("a, b and h0 must be on one device")


def _launch(a, b, h0):
    B, S, D = a.shape
    if B > MAX_BATCH:
        raise ValueError(f"kernel takes B <= {MAX_BATCH}; got B={B}")
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if D > 1 and t.numel() and t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous; "
                             f"strides {t.stride()}")
    y = torch.empty_like(a)
    hn = torch.empty((B, D), dtype=torch.float32, device=a.device)
    if B * D == 0:
        return y, hn
    lib = build.load("rglru_scan")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.rglru_scan_launch(
            a.data_ptr(), b.data_ptr(), h0.data_ptr(), y.data_ptr(), hn.data_ptr(),
            B, S, D, *a.stride()[:2], *b.stride()[:2], *y.stride()[:2],
            h0.stride(0), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"rglru kernel launch failed: CUDA error {err}")
    rglru_scan.launches += 1
    return y, hn


def rglru_scan(a, b, h0):
    """a, b: (B, S, D) fp32 decay and input; h0: (B, D) fp32.
    Returns (y (B, S, D), h_S (B, D))."""
    _check(a, b, h0)
    if a.device.type == "cpu":
        return ref.rglru_scan_ref(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cpu or cuda, not {a.device}")
    return _launch(a, b, h0)


rglru_scan.launches = 0
