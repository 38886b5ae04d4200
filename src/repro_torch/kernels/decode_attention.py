"""Single-token decode attention: wrapper of ``csrc/decode_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``decode_attention`` / ``_decode_kernel``): one query token per sequence
against the ring KV cache, with the slot mask given as ``valid (W,)``.

On the H100 decode attention is bound by memory, and at the serving shapes
by latency: every valid slot's K and V are read once for a handful of
operations each. The CUDA kernel reads the model's ``(B, W, KV, hd)`` cache
in place through the strides of a permuted view (no copy per step), loads
no K/V for a 16-slot tile without a valid slot, and masks a ragged tail of
``W``. One block per ``(batch, kv_head)`` would use 1 to 4 of the 132 SMs
at batch 1, so ``W`` is split into chunks (flash-decoding), one block each;
the blocks of a ``(batch, kv_head)`` form one thread-block cluster, keep
their chunk's ``(m, l, acc)`` in shared memory and merge through each
other's shared memory in the same launch, so the call needs no scratch.
``split_plan`` picks the chunks. A cluster lies in one GPC, so the card
holds fewer clusters of 16 blocks than its SMs suggest; ``occupancy`` asks
the kernel's library how many clusters of a plan run at once (launching
nothing), and ``chip_smoke.py``'s plan sweep logs it beside each plan's
time. ``split_plan`` does not consult it yet (ROADMAP Queue 2 item d).
bf16 runs both products on the tensor cores (``decode_mma_kernel``); fp32
runs on the CUDA cores. With no valid
slot at all the result is the mean of V over all ``W`` slots, as the
reference gives.

A tensor on the CPU goes to the plain version (``ref.decode_attention_ref``);
a CUDA tensor launches the kernel or raises. ``decode_attention.launches``
counts kernel launches (one per call, which runs both the chunks and the
merge). The kernel has no backward (decoding does not train): a CUDA input
that requires grad, with grad enabled, raises (``build.refuse_grad``)
rather than return an output that cuts the graph; on the CPU the plain
version stays differentiable.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 16                   # slots per key tile (kBK in the source)
MIN_TILES = 4               # tiles per chunk, at least (unless W is shorter)
MAX_SPLITS = 16             # chunks: the blocks of one cluster (kMaxCluster)
BLOCKS_PER_SM = 1

_sm_count: dict = {}        # device index -> SMs


def split_plan(B: int, KV: int, W: int, num_sms: int):
    """(nsplit, chunk): ``W`` in ``nsplit`` chunks of ``chunk`` slots, a
    multiple of the tile: as many chunks as a cluster takes, as long as each
    holds ``MIN_TILES`` tiles and the grid's ``B * KV * nsplit`` blocks stay
    within about ``BLOCKS_PER_SM`` per SM."""
    tiles = -(-W // TILE)
    want = -(-BLOCKS_PER_SM * num_sms // (B * KV))
    per_split = -(-tiles // max(1, min(MAX_SPLITS, tiles // MIN_TILES, want)))
    return -(-tiles // per_split), per_split * TILE


def occupancy(q, k_cache, nsplit: int, chunk: int):
    """(clusters of the call's grid, clusters the card holds at once) for
    the plan ``nsplit`` x ``chunk`` of the call on ``q`` (B,H,hd) and
    ``k_cache`` (B,KV,W,hd), on their card; launches nothing."""
    B, H, hd = q.shape
    KV, W = k_cache.shape[1], k_cache.shape[2]
    occ = (ctypes.c_int * 2)()
    err = build.on_device(q.device, lambda _: build.load("decode_attention")
                          .decode_attention_occupancy(DTYPES[q.dtype], B, H, KV, W, hd,
                                                      nsplit, chunk, occ))
    if err != 0:
        raise RuntimeError(f"decode_attention occupancy query failed: CUDA error {err}")
    return occ[0], occ[1]


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
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dimension must be contiguous; "
                             f"strides {t.stride()}")
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = build.load("decode_attention")
    dev = q.device.index
    sms = _sm_count.get(dev)
    if sms is None:
        sms = _sm_count[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    nsplit, chunk = split_plan(B, KV, W, sms)
    valid = valid.contiguous()
    args = (DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            valid.data_ptr(), out.data_ptr(), B, H, KV, W, hd, nsplit, chunk,
            *q.stride()[:2], *k_cache.stride()[:3], *v_cache.stride()[:3],
            *out.stride()[:2])
    err = build.on_device(q.device, lambda stream: lib.decode_attention_launch(
        *args, stream))
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
    build.refuse_grad("decode_attention", "none is queued: decoding does not train",
                      q, k_cache, v_cache)
    return _launch(q, k_cache, v_cache, valid)


decode_attention.launches = 0
