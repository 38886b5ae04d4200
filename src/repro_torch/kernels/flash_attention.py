"""Prefix-aware GQA flash attention: wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` / ``_flash_kernel``), the suffix prefill of a cache hit:
queries at absolute positions ``q_offset + i`` attend to cached-prefix plus
suffix keys, causal, with an optional sliding window.

One C entry, two routes chosen by dtype alone (no route falls back):

* bf16, the serving path: ``flash_mma_kernel``, both products on the
  tensor cores (``wgmma``, fp32 accumulation, P rounded to bf16 for the PV
  product as SDPA and FlashAttention round it). At the main path's shapes
  (yi-6b's 32 query heads of 512 suffix tokens against 2,560 keys, hd 128;
  Griffin's 10 heads of 256 over 2,560 keys, window 2,048) the call does
  900-1,400 flops per byte it must move, above the card's balance point of
  295, so the tensor cores' 989 TFLOP/s bound it. A block packs 128 query
  rows (the G heads that share a kv head times 128/G positions), so each
  K/V tile is read once for the group; 64-key tiles arrive by TMA, issued
  by one thread and completed on ``mbarrier``s, into a ring of
  shared-memory slots while the previous ones are multiplied. What holds
  it above that bound is the softmax between the two products, on the
  CUDA cores (``repro_torch.kernels.phases`` splits a tile's time); the
  kernel cuts it to one FFMA and one ``ex2`` per score.
* fp32: ``flash_kernel``, fp32 FMA on the CUDA cores, for the fp32 model
  phases and the 2e-5 tolerance, which TF32 products would miss; it is
  bound by the CUDA cores' 67 TFLOP/s.

Both skip key tiles outside the causal/window band of a block unless a row
of the block sees no key at all, mask ragged tails in-kernel, and give a
row the same bits whichever block it lands in, so a cache hit's suffix
rows equal the cold prefill's.

It computes the reference's function on every input, including rows whose
band is empty (a window that ends before the keys begin): those get the mean
of V over all ``Sk`` keys, as ``repro.kernels.ref.flash_attention_ref`` and
the Pallas kernel give them.

A tensor on the CPU goes to the plain version (``ref.flash_attention_ref``),
whose autograd is its gradient; a CUDA tensor launches the kernel or
raises. ``flash_attention.launches`` counts kernel launches.

The gradient on the card: where grad is enabled and q, k or v requires it,
``flash_attention`` runs through ``FlashAttentionFn``, whose forward is the
same launch (it saves q, k, v and the output) and whose backward is
``flash_attention_bwd``, the C entry of ``csrc/flash_attention_bwd.cu``
(two kernels: dQ with the logsumexp and D = rowsum(dO * O), then dK and dV
per key block; see the source's note for the bound and the design).
Everywhere else, the serving engine's ``inference_mode`` included, the
call is the plain launch, which saves nothing. ``flash_attention_bwd
.launches`` counts calls of that entry.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_GROUP = 64          # query heads per kv head that one block packs
INT32_MAX = 2**31 - 1


def _check(q, k, v, q_offset, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention wants q (B,H,Sq,hd), k/v (B,KV,Sk,hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    KV = k.shape[1]
    if KV == 0 or H % KV:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: want "
                        "float32 or bfloat16 for all three")
    if not (q.device == k.device == v.device):
        raise ValueError(f"devices differ: {q.device}, {k.device}, {v.device}")
    # the kernel holds positions in int32: q_offset + Sq and Sk + |window|
    # must fit
    if abs(q_offset) + Sq + k.shape[2] + abs(window or 0) > INT32_MAX:
        raise ValueError(f"q_offset={q_offset}, window={window} out of int32 range")


def _entry_args(q, k, v, out, q_offset, causal, window, stream):
    """The arguments of the C entry ``flash_attention_launch`` for this
    call (pointers, shapes, strides in elements, masking, the stream)."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    return (DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, KV, Sq, Sk, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            int(q_offset), int(causal), int(window is not None), int(window or 0),
            ctypes.c_void_p(stream))


def _launch(q, k, v, q_offset, causal, window):
    B, H, Sq, hd = q.shape
    KV = k.shape[1]
    if hd > MAX_HEAD_DIM or H // KV > MAX_GROUP:
        raise ValueError(f"kernel takes hd <= {MAX_HEAD_DIM} and H/KV <= "
                         f"{MAX_GROUP}; got hd={hd}, H/KV={H // KV}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dimension must be contiguous; "
                             f"strides {t.stride()}")
    out = torch.empty((B, H, Sq, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = build.load("flash_attention")
    err = build.on_device(q.device, lambda stream: lib.flash_attention_launch(
        *_entry_args(q, k, v, out, q_offset, causal, window, stream)))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


def _launch_bwd(q, k, v, out, dout, q_offset, causal, window):
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if dout.shape != out.shape or dout.dtype != q.dtype or out.dtype != q.dtype:
        raise ValueError(f"out {out.dtype} {tuple(out.shape)} and dout {dout.dtype} "
                         f"{tuple(dout.shape)} must match q {q.dtype} {tuple(q.shape)}")
    if hd > 1 and dout.stride(-1) != 1:        # an expanded or sliced gradient
        dout = dout.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if hd > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dimension must be contiguous; "
                             f"strides {t.stride()}")
    dq = torch.empty((B, H, Sq, hd), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:                        # no query row: nothing flows
        return dq, torch.zeros_like(k), torch.zeros_like(v)
    dk = torch.empty((B, KV, Sk, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dsum = torch.empty_like(lse)
    lib = build.load("flash_attention_bwd")
    err = build.on_device(q.device, lambda stream: lib.flash_attention_bwd_launch(
        DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
        dsum.data_ptr(), B, H, KV, Sq, Sk, hd, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *out.stride()[:3], *dout.stride()[:3], int(q_offset),
        int(causal), int(window is not None), int(window or 0), ctypes.c_void_p(stream)))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """The kernel with its gradient: the forward launch, and
    ``flash_attention_bwd`` for the backward. CUDA tensors only."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, causal, window):
        out = _launch(q, k, v, q_offset, causal, window)
        ctx.save_for_backward(q, k, v, out)
        ctx.mask = (q_offset, causal, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        q_offset, causal, window = ctx.mask
        dq, dk, dv = _launch_bwd(q, k, v, out, dout, q_offset, causal, window)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, q_offset: int = 0, causal: bool = True,
                    window: Optional[int] = None):
    """q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd) with H % KV == 0.
    Returns (B, H, Sq, hd). q_offset: absolute position of q[:, :, 0]."""
    _check(q, k, v, q_offset, window)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, q_offset=q_offset,
                                       causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, q_offset, causal, window)
    return _launch(q, k, v, q_offset, causal, window)


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, out, dout, *, q_offset: int = 0, causal: bool = True,
                        window: Optional[int] = None):
    """The gradients (dq, dk, dv) of ``flash_attention`` at (q, k, v), whose
    output is ``out``, for the output gradient ``dout`` (both (B,H,Sq,hd)).
    On the CPU the plain version (``ref.flash_attention_bwd_ref``, which
    recomputes the output); a CUDA tensor launches the kernel or raises."""
    _check(q, k, v, q_offset, window)
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, dout, q_offset=q_offset,
                                           causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cpu or cuda, not {q.device}")
    return _launch_bwd(q, k, v, out, dout, q_offset, causal, window)


flash_attention_bwd.launches = 0
