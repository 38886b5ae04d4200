"""Single-token decode attention: wrapper of ``csrc/decode_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``decode_attention`` / ``_decode_kernel``): one query token per sequence
against the ring KV cache, with the slot mask given as ``valid (W,)``.

On the H100 decode attention is bound by memory: every valid slot's K and
V are read once for a handful of operations each. The CUDA kernel reads the
model's ``(B, W, KV, hd)`` cache in place through the strides of a permuted
view (no copy per step), skips key tiles without a valid slot, and masks a
ragged tail of ``W``. One block per ``(batch, kv_head)`` would use 4 of the
132 SMs at batch 1 for yi-6b, so ``W`` is split across blocks
(flash-decoding): ``split_plan`` picks enough chunks for about two blocks per
SM, each block reduces its chunk to ``(m, l, acc)`` in fp32 scratch that
this wrapper allocates, and a second kernel merges the chunks. With no valid
slot at all the result is the mean of V over all ``W`` slots, as the
reference gives.

A tensor on the CPU goes to the plain version (``ref.decode_attention_ref``);
a CUDA tensor launches the kernel or raises. ``decode_attention.launches``
counts kernel launches (one per call, which runs both passes).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64                   # slots per key tile (kBK in the source)
BLOCKS_PER_SM = 2


def split_plan(B: int, KV: int, W: int, num_sms: int):
    """(nsplit, chunk): ``W`` in ``nsplit`` chunks of ``chunk`` slots, a
    multiple of the tile, with about ``BLOCKS_PER_SM`` blocks per SM over
    the ``B * KV`` rows of the grid."""
    tiles = -(-W // TILE)
    want = max(1, -(-BLOCKS_PER_SM * num_sms // (B * KV)))
    per_split = -(-tiles // min(tiles, want))
    return -(-tiles // per_split), per_split * TILE


def _check(q, k_cache, v_cache, valid):
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError("decode_attention wants q (B,H,hd), caches (B,KV,W,hd); "
                         f"got {tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, H, hd = q.shape
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[3] != hd):
        raise ValueError(f"caches {tuple(k_cache.shape)} / {tuple(v_cache.shape)} "
                         f"do not match q {tuple(q.shape)}")
    KV, W = k_cache.shape[1], k_cache.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    if valid.shape != (W,) or valid.dtype != torch.int32:
        raise ValueError(f"valid must be int32 of shape ({W},); got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if (q.dtype not in DTYPES or k_cache.dtype != q.dtype
            or v_cache.dtype != q.dtype):
        raise TypeError(f"dtypes {q.dtype}, {k_cache.dtype}, {v_cache.dtype}: "
                        "want float32 or bfloat16 for all three")
    if not (q.device == k_cache.device == v_cache.device == valid.device):
        raise ValueError("q, caches and valid must be on one device")


def _launch(q, k_cache, v_cache, valid):
    B, H, hd = q.shape
    KV, W = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dimension must be contiguous; "
                             f"strides {t.stride()}")
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = build.load("decode_attention")
    nsplit, chunk = split_plan(
        B, KV, W, torch.cuda.get_device_properties(q.device).multi_processor_count)
    valid = valid.contiguous()
    part_ml = torch.empty((B, KV, nsplit, G, 2), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((B, KV, nsplit, G, hd), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_launch(
            DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            valid.data_ptr(), out.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(),
            B, H, KV, W, hd, nsplit, chunk,
            *q.stride()[:2], *k_cache.stride()[:3], *v_cache.stride()[:3],
            *out.stride()[:2], ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err}")
    decode_attention.launches += 1
    return out


def decode_attention(q, k_cache, v_cache, valid):
    """q: (B, H, hd); k_cache, v_cache: (B, KV, W, hd); valid: (W,) int32.
    Returns (B, H, hd)."""
    _check(q, k_cache, v_cache, valid)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, valid)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda, not {q.device}")
    return _launch(q, k_cache, v_cache, valid)


decode_attention.launches = 0
