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
* fp32: ``flash_tf32_kernel``, ``mma.sync`` on the tensor cores in
  split-TF32 products, as the fp32 backward's kernels: each operand split
  into a TF32 big part and a TF32 small part, every product taken as
  big·small + small·big + big·big, every 32 of its shared dimension summed
  from zero and then added in fp32 (one TF32 product would miss the fp32
  tolerance 2e-5). Bound by 495/3 = 165 TFLOP/s. A first kernel,
  ``flash_tf32_split_kernel``, splits q, k and v once a call into a
  scratch the wrapper allocates (``split_floats``), so that no block
  repeats a split another block makes; ``fwd_tf32_rows`` sizes the
  attention kernel's blocks from the shape so that the grid fills the
  card.

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
``flash_attention`` runs through ``FlashAttentionFn``, whose forward is
``flash_attention_train``, the C entry ``flash_attention_train_launch``: the
same kernels, which also write each row's logsumexp (``lse``, (B,H,Sq)
fp32, base 2 of the scores times ``hd ** -0.5 * log2(e)``), and it saves q,
k, v, the output and ``lse``. Its backward is ``flash_attention_bwd``, the C
entry of ``csrc/flash_attention_bwd.cu``: two kernels, dQ with D =
rowsum(dO * O), then dK and dV per key block, routed by ``bwd_route``
from the dtype alone, both on the tensor cores at every hd. bf16: ``wgmma``;
the tensor cores' 989 TFLOP/s bound it at the training shapes (about
2,000-3,000 flops per byte moved). Up to hd 128 a warpgroup holds the fp32
dK and dV of its keys; past it they would need 256 registers a thread, so
the wide kernels give each warpgroup half of hd's columns and split the
products over hd between the two (the source's note has the design);
``bwd_keys`` sizes the dK/dV block from the mask and hd. fp32: ``mma.sync``
in split-TF32 products, each operand split into a TF32 big part and a TF32
small part and every product taken as big·small + small·big + big·big with
fp32 sums (one TF32 product would miss the fp32 tolerance 2e-5 by two
orders), bound by 495/3 = 165 TFLOP/s; ``bwd_tf32_blocks`` sizes both
kernels' blocks from the shape so that the grid fills the card.
Everywhere else, the serving engine's ``inference_mode`` included, the
call is the serving launch, which saves nothing. A launch of either
forward entry counts in ``flash_attention.launches``; ``flash_attention_bwd
.launches`` counts calls of the backward entry.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_GROUP = 64          # query heads per kv head that one block packs
INT32_MAX = 2**31 - 1
NARROW_BWD_MAX_HEAD_DIM = 128   # wider heads run the backward's wide kernels
BWD_ROUTES = {"tensor cores": 1, "tensor cores, split tf32": 2}   # the C entry's route argument
SMS = 132                        # the H100's streaming multiprocessors
# the fp32 forward's grid fills the card from 128 blocks: one block an SM at
# every size it takes (shared memory), and a block of 16 rows keeps two of
# an SM's four warp schedulers busy, so 128 blocks of 32 rows in one wave
# beat 256 of 16 in two (the 100M twin's shape)
FWD_FILL = 128


def bwd_route(dtype: torch.dtype, hd: int) -> str:
    """The backward kernels a call of (dtype, hd) runs, at every hd up to
    ``MAX_HEAD_DIM``: "tensor cores" (``wgmma`` in bf16) for bf16, "tensor
    cores, split tf32" (``mma.sync`` in three TF32 products a product) for
    fp32, whose 2e-5 tolerance one TF32 product would miss. The C entry
    takes the route as an argument (``BWD_ROUTES``) and refuses a route
    that is not the dtype's."""
    return "tensor cores" if dtype == torch.bfloat16 else "tensor cores, split tf32"


def bwd_tf32_blocks(B: int, H: int, KV: int, Sq: int, Sk: int, hd: int) -> tuple:
    """(rows, keys) of the split-TF32 route's blocks: the positions of one
    query head that a dQ block takes and the keys of a dK/dV block, each the
    largest of 128, 64, 32 and 16 whose grid has at least ``SMS`` blocks (16
    if none has), within what a block holds: rows at most 128 up to hd 128,
    64 up to 192, 32 past it; keys at most 128 up to hd 80, 64 up to 192, 32
    past it (8 warps a block; Q and dO of 64 rows at hd 256 alone fill 133 KB
    of shared memory)."""
    def size(n, per, most):
        return next((s for s in (128, 64, 32, 16) if s <= most and -(-n // s) * per >= SMS), 16)

    rows = size(Sq, H * B, 128 if hd <= 128 else 64 if hd <= 192 else 32)
    return rows, size(Sk, KV * B, 128 if hd <= 80 else 64 if hd <= 192 else 32)


@functools.lru_cache(maxsize=None)
def fwd_tf32_rows(B: int, H: int, KV: int, Sq: int, hd: int) -> int:
    """The packed query rows of a block of the forward's fp32 route
    (``flash_tf32_kernel``): a multiple of 16 (a warp's 16 rows) and at
    least G = H/KV (the G heads of a kv head share a block, head-major),
    the largest whose grid has at least ``FWD_FILL`` blocks (the smallest
    if none has), within what a block holds: 128 up to hd 128, 64 up to
    192, 32 past it (8 warps, two a 16 rows past hd 128; Q's big and small
    copies and a 32-key tile of K and V, both split, in 227 KB of shared
    memory). Past hd 192 a group of more than 32 heads is taken 32 heads a
    block."""
    most = 128 if hd <= 128 else 64 if hd <= 192 else 32
    G = H // KV

    def grid(rows):
        heads = min(G, rows)
        return -(-Sq // (rows // heads)) * KV * -(-G // heads) * B

    sizes = [r for r in range(most, 0, -16) if r >= min(G, most)]
    return next((r for r in sizes if grid(r) >= FWD_FILL), sizes[-1])


def bwd_blocks(hd: int) -> tuple:
    """The dK/dV blocks (keys) that the bf16 route has at ``hd``:
    64 and 128 up to ``NARROW_BWD_MAX_HEAD_DIM``; above it the wide kernels,
    64 only (two 64-key tiles of K and V at 256 columns, and the ring of
    Q/dO tiles, fill shared memory)."""
    return (64, 128) if hd <= NARROW_BWD_MAX_HEAD_DIM else (64,)


def bwd_keys(causal: bool, window: Optional[int], hd: int) -> int:
    """The keys of a dK/dV block on the backward's bf16 route. At
    hd > ``NARROW_BWD_MAX_HEAD_DIM`` 64, the wide kernels' only block.
    Otherwise 64 under a causal mask without a window: the first keys see
    every row and the last one tile, so a block of 128 would take twice the
    mean, and 64 halve the longest for twice the Q/dO tile loads. Else 128,
    64 a warpgroup on the same tiles: every block sees about the same rows
    (at most the window and a tile), and each tile loaded serves twice the
    keys."""
    if hd > NARROW_BWD_MAX_HEAD_DIM:
        return 64
    return 64 if causal and window is None else 128


def rows16(t: torch.Tensor) -> torch.Tensor:
    """``t`` (B,N,S,hd) if it starts on 16 bytes and every stride but the
    head dimension's (which must be 1) is a whole number of 16-byte chunks
    or spans one entry, as the TMA unit and 16-byte copies (``cp.async``)
    need; else a copy whose rows are padded to 16 bytes, as a view of ``hd``
    columns."""
    per = 16 // t.element_size()
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
            n == 1 or (s > 0 and s % per == 0) for s, n in zip(t.stride()[:3], t.shape[:3])):
        return t
    hd = t.shape[-1]
    buf = t.new_zeros(*t.shape[:-1], -(-hd // per) * per)
    buf[..., :hd] = t
    return buf[..., :hd]


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


@functools.lru_cache(maxsize=None)
def split_floats(B: int, H: int, KV: int, Sq: int, Sk: int, hd: int) -> int:
    """Floats of the fp32 route's scratch: a big and a small copy of q, k
    and v (``flash_tf32_split_kernel``) in the attention kernel's tile
    layout: rows of hd padded to 64, 80, 128, 192 or 256, + 4; k and v with
    Sk padded to a 32-key tile."""
    ld = next(w for w in (64, 80, 128, 192, MAX_HEAD_DIM) if hd <= w) + 4
    return 2 * (B * H * Sq + 2 * B * KV * -(-Sk // 32) * 32) * ld


def _entry_args(q, k, v, out, q_offset, causal, window, stream, lse=None, scratch=None):
    """The arguments of the C entry ``flash_attention_launch`` for this
    call (pointers, shapes, strides in elements, masking, the fp32 route's
    rows a block from ``fwd_tf32_rows`` and its scratch of
    ``split_floats`` (0 and null for bf16), the stream); with ``lse``, those
    of ``flash_attention_train_launch``, which takes its pointer after the
    output's."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    rows = fwd_tf32_rows(B, H, KV, Sq, hd) if q.dtype == torch.float32 else 0
    return (DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *(() if lse is None else (lse.data_ptr(),)), B, H, KV, Sq, Sk, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            int(q_offset), int(causal), int(window is not None), int(window or 0), rows,
            0 if scratch is None else scratch.data_ptr(), ctypes.c_void_p(stream))


def _launch(q, k, v, q_offset, causal, window, with_lse=False):
    """The serving entry's output, or with ``with_lse`` the training
    entry's (output, lse)."""
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
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if with_lse else None
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    scratch = torch.empty(split_floats(B, H, KV, Sq, k.shape[2], hd), dtype=torch.float32,
                          device=q.device) if q.dtype == torch.float32 else None
    lib = build.load("flash_attention")
    entry = lib.flash_attention_train_launch if with_lse else lib.flash_attention_launch
    err = build.on_device(q.device, lambda stream: entry(
        *_entry_args(q, k, v, out, q_offset, causal, window, stream, lse, scratch)))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return (out, lse) if with_lse else out


def _bwd_args(q, k, v, out, dout, dq, dk, dv, lse, dsum, q_offset, causal, window, stream,
              keys=None):
    """The arguments of the C entry ``flash_attention_bwd_launch``: the
    dtype, the route ``bwd_route`` chooses, the dK/dV block and the dQ
    block (bf16: ``keys``, else ``bwd_keys``'s, and 0; fp32:
    ``bwd_tf32_blocks``'s keys and rows), pointers, shapes, strides in
    elements, masking and the stream."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16:
        rows, keys = 0, bwd_keys(causal, window, hd) if keys is None else keys
    else:
        rows, keys = bwd_tf32_blocks(B, H, KV, Sq, Sk, hd)
    return (DTYPES[q.dtype], BWD_ROUTES[bwd_route(q.dtype, hd)], keys, rows, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), dsum.data_ptr(), B, H, KV, Sq, Sk, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            *dout.stride()[:3], int(q_offset), int(causal), int(window is not None),
            int(window or 0), ctypes.c_void_p(stream))


def _launch_bwd(q, k, v, out, lse, dout, q_offset, causal, window, keys=None):
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if dout.shape != out.shape or dout.dtype != q.dtype or out.dtype != q.dtype:
        raise ValueError(f"out {out.dtype} {tuple(out.shape)} and dout {dout.dtype} "
                         f"{tuple(dout.shape)} must match q {q.dtype} {tuple(q.shape)}")
    if lse is None or lse.shape != (B, H, Sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd on the card takes the training forward's lse, "
                         f"(B,H,Sq) fp32 contiguous; got "
                         f"{None if lse is None else (lse.dtype, tuple(lse.shape))}")
    if hd > 1 and dout.stride(-1) != 1:        # an expanded or sliced gradient
        dout = dout.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if hd > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dimension must be contiguous; "
                             f"strides {t.stride()}")
    dq = torch.empty((B, H, Sq, hd), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:                        # no query row: nothing flows
        return dq, torch.zeros_like(k), torch.zeros_like(v)
    q, k, v, dout = (rows16(t) for t in (q, k, v, dout))   # TMA and 16-byte copies
    dk = torch.empty((B, KV, Sk, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    dsum = torch.empty_like(lse)
    lib = build.load("flash_attention_bwd")
    err = build.on_device(q.device, lambda stream: lib.flash_attention_bwd_launch(
        *_bwd_args(q, k, v, out, dout, dq, dk, dv, lse, dsum, q_offset, causal, window,
                   stream, keys)))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """The kernel with its gradient: the training entry's launch, and
    ``flash_attention_bwd`` on its lse for the backward. CUDA tensors only."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, causal, window):
        out, lse = _launch(q, k, v, q_offset, causal, window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (q_offset, causal, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        q_offset, causal, window = ctx.mask
        dq, dk, dv = _launch_bwd(q, k, v, out, lse, dout, q_offset, causal, window)
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


def flash_attention_train(q, k, v, *, q_offset: int = 0, causal: bool = True,
                          window: Optional[int] = None):
    """``flash_attention``'s output and each row's logsumexp, lse (B,H,Sq)
    fp32 in base 2 (``ref.flash_attention_lse_ref`` on the CPU; on the card
    the training entry, counted in ``flash_attention.launches``). No
    autograd: ``flash_attention`` is the differentiable call."""
    _check(q, k, v, q_offset, window)
    if q.device.type == "cpu":
        return ref.flash_attention_lse_ref(q, k, v, q_offset=q_offset, causal=causal,
                                           window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_train runs on cpu or cuda, not {q.device}")
    return _launch(q, k, v, q_offset, causal, window, with_lse=True)


def flash_attention_bwd(q, k, v, out, dout, *, lse=None, q_offset: int = 0,
                        causal: bool = True, window: Optional[int] = None,
                        keys: Optional[int] = None):
    """The gradients (dq, dk, dv) of ``flash_attention`` at (q, k, v), whose
    output is ``out`` and logsumexp ``lse`` (``flash_attention_train``'s),
    for the output gradient ``dout`` (both (B,H,Sq,hd)). On the CPU the
    plain version (``ref.flash_attention_bwd_ref``, which recomputes the
    output and needs neither); a CUDA tensor launches the kernels or
    raises, and needs ``lse``. ``keys`` (one of ``bwd_blocks(hd)``)
    overrides ``bwd_keys`` on the bf16 route, to time the other block; the
    fp32 route takes none."""
    _check(q, k, v, q_offset, window)
    blocks = bwd_blocks(q.shape[-1])
    if keys is not None and keys not in blocks:
        raise ValueError(f"keys={keys}: a dK/dV block takes "
                         f"{' or '.join(map(str, blocks))} keys at hd {q.shape[-1]}")
    if keys is not None and q.dtype != torch.bfloat16:
        raise ValueError(f"keys={keys}: only the bf16 route takes a dK/dV block")
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, dout, q_offset=q_offset,
                                           causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cpu or cuda, not {q.device}")
    return _launch_bwd(q, k, v, out, lse, dout, q_offset, causal, window, keys)


flash_attention_bwd.launches = 0
