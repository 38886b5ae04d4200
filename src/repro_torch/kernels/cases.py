"""Shapes at which the kernels are held against their plain versions, and
the check itself.

One table for every check: ``tests/test_torch_kernels.py`` runs the plain
versions against the JAX package on the CPU at these shapes,
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` run the CUDA kernels
against the plain versions on the card through ``check_flash``,
``check_flash_bwd``, ``check_decode``, ``check_rglru``, ``check_wkv6``,
``check_wkv6_bwd`` and ``check_rglru_bwd``, and the flash kernel's
cache-hit rows against its cold rows through ``check_flash_hit_rows``.

Flash cases are ``(B, H, KV, Sq, Sk, hd, q_offset, window, causal)``.
Decode cases are ``(B, H, KV, W, hd, nvalid, start)``: the valid slots are
``start, start + 1, ... (mod W)``, ``nvalid`` of them, as a ring cache holds
a window of positions. An eighth entry, where there is one, is the storage
offset in elements at which the caches' data starts (1: off every 16-byte
boundary).

Tolerance: ``|out - want| <= tol * (scale + |want|)`` elementwise, with
``tol`` 2e-5 in fp32 and 2e-2 in bf16 (those of ``tests/test_kernels.py``)
and ``scale = min(1, max |want|)``. For unit-scale outputs that is the
reference's ``atol = rtol = tol``. An attention output averages many values
of V, so at long ``Sk`` its largest entries are far below 1 (about 0.15 at
the main path's shapes), and a fixed ``atol`` of 2e-2 would pass a bf16
fault of several percent; the absolute term therefore shrinks with the
output's own scale. Both accumulate in fp32 and round the output once; in
bf16 the kernel also rounds P to bf16 before the PV product (as SDPA and
FlashAttention do) while the plain version keeps P in fp32. So they differ
by about one bf16 ulp of the output (2**-8 of the value) plus P's rounding,
a relative 2**-9 per weight that averages out over the keys: well inside
``2e-2 * (scale + |want|)``.

``FLASH_TILES`` puts lengths, offsets and windows on either side of the
bf16 kernel's tile edges (64 keys, 128 packed query rows);
``FLASH_IDENTITY`` pairs a cold call with the cache hit on its last rows,
which ``check_flash_hit_rows`` holds equal bit for bit. The calls of the
dense archs after yi-6b and of the long-context phase are not listed here:
``repro_torch.launch.shapes`` computes them from the configs and the turns.

The flash backward (``ops.flash_attention_bwd``, reached through autograd
of ``ops.flash_attention``) is held by ``check_flash_bwd`` at ``FLASH_BWD``,
the forward's sweep, ragged, empty-band and tile-edge cases and
``FLASH_BWD_TILES``, either side of the backward's own tiles and blocks
(bf16's and the fp32 route's), and at
``FLASH_BWD_TRAIN``, the training shapes: h2o-danube-1.8b's layer at 8,192
tokens (its window binds), yi-6b's at 4,096, the 100M twin's
(``repro_torch.launch.train_100m``: yi-6b reduced to 12 layers of d_model
768, 4 heads of 192, batch 4 of 256 tokens), an enc-dec cross-attention
(not causal, Sq != Sk) and recurrentgemma-2b's local attention at 8,192
tokens (hd 256: in bf16 the wide tensor-core kernels). The output gradient is
normal, drawn from ``seed + 1``. dq, dk and dv are each held to ``TOL`` in the form above (2e-5
fp32, 2e-2 bf16, the sweep of tests/test_kernels.py) against
``ref.flash_attention_bwd_ref``, autograd of the plain forward. Both sides
compute in fp32 on the same input values; the kernel takes D = rowsum(dO *
O) from the saved output, which in bf16 is rounded (a relative 2**-9 of D,
far below dO V^T - D's size), and rounds each gradient once; in bf16 it also
rounds P and dS to bf16 before the products that take them (as
FlashAttention-2 and -3 do), a relative 2**-9 per term that averages out
over the rows and keys of each sum. In fp32 every product runs in three TF32
products (big·small + small·big + big·big of each operand's TF32 split),
well inside the tolerance, which one TF32 product misses
(tests/test_torch_flash_bwd_tf32.py). ``check_flash_bwd_repeat`` holds two
backward calls on the same inputs to the same bits. ``check_flash_train``
holds the training entry (``ops.flash_attention_train``, whose lse the
backward takes) to the serving entry's output bit for bit and its lse to
the plain version's (``ref.flash_attention_lse_ref``) within ``TOL`` of
fp32.

WKV6 cases are ``(B, H, S, hd, decay, s0_scale, layout[, rkv])``:
``decay`` None draws ``w`` uniform in [0.8, 0.999) as
``tests/test_kernels.py`` does, a number sets every ``w`` to it; ``s0`` is
normal times ``s0_scale``; ``layout`` "bhsd" gives contiguous ``(B,H,S,hd)``
tensors, "bshd" the model's ``(B,S,H,hd)`` activations passed as permuted
views, "off" contiguous tensors whose data starts one element into their
storage (off every 16-byte boundary: the step kernel's element path);
``rkv`` "bf16" passes ``r``, ``k`` and ``v`` in bf16 (drawn in fp32 and
rounded, so the fp32 arrays hold the same values), "fp32" or absent in fp32.
``WKV6_STEP`` holds the one-token calls (the step kernel),
``WKV6_FLOOR`` the smallest, whose time is a launch's fixed cost,
``WKV6_SLICE`` the time loop's edges (its 8-column slices and staging
chunks, on grids of one to three heads). Held at
``WKV6_TOL`` = 1e-4 in the same form (the ``atol = rtol = 1e-4`` of
``tests/test_kernels.py:95-98``), on ``y`` and ``s_n``.

RG-LRU cases are ``(B, S, D, layout)``: ``a`` uniform in [0.7, 0.999),
``b`` normal times 0.1 and ``h0`` normal, as ``tests/test_kernels.py``
draws them; ``layout`` "bsd" gives contiguous tensors, "wide" passes ``a``
and ``b`` as the two halves of one (B,S,2D) buffer and ``h0`` as half of a
(B,2D) buffer, so rows are read by strides. fp32 only, at ``RGLRU_TOL`` =
1e-5 in the same form (the ``atol`` 1e-5 of ``tests/test_kernels.py:79-80``),
on ``y`` and ``h_S``. ``RGLRU_CHUNK`` holds the edges of the scan's 128-step
chunks (past one chunk the kernel's folded states are not the plain
version's bits; ``check_rglru_repeat`` holds two calls to the same bits).
``RGLRU_FLOOR`` is the smallest call, a launch's fixed cost.

The recurrent backwards. ``WKV6_BWD`` cases are the WKV6 cases with two
more entries, ``(..., layout, rkv, ds_n)``: ``ds_n`` "random" passes a normal
gradient of s_n, "zero" passes None (as the model's training does: it
reads no s_n); the output gradient dy is normal, in the case's layout, both
drawn from ``seed + 1``. ``check_wkv6_bwd`` holds dr, dk, dv, dw, du and
ds0 through autograd of ``ops.wkv6`` (on the card: the training entry
``ops.wkv6_train``, then ``ops.wkv6_bwd``) against ``ref.wkv6_bwd_ref`` on
the plain training entry's checkpoints, fp32 gradients at ``WKV6_TOL`` and
those returned in bf16 (dr, dk, dv of bf16 r, k, v: accumulated in fp32,
rounded once) at ``TOL[bf16]``; the plain version computes in float64, so
the tolerance judges the kernel's fp32 sums alone. ``check_wkv6_bwd_repeat``
holds two backward calls to the same bits, ``check_wkv6_train`` the
training entry's y and s_n to the serving entry's bit for bit and its
checkpoints to ``ref.wkv6_train_ref``'s at ``WKV6_TOL``. ``WKV6_BWD_TRAIN``
is rwkv6-1.6b's layer at 4,096 tokens. ``RGLRU_BWD`` cases are the scan's
with a fifth entry, ``dh_S`` "random" or "zero" (None); ``check_rglru_bwd``
holds da, db and dh0 through autograd of ``ops.rglru_scan`` against
``ref.rglru_scan_bwd_ref`` at ``RGLRU_TOL`` (the kernel rounds every
product and sum of a step as the plain version does, but past one chunk of
128 steps the carry into a chunk is composed from the later chunks' carries
and products, so the result is not the plain version's bit for bit),
``check_rglru_bwd_repeat``
two calls to the same bits; ``RGLRU_BWD_TRAIN`` is recurrentgemma-2b's
recurrent layer at 8,192 tokens.

RG-LRU step cases (``ops.rglru_step``) are ``(B, D, x dtype, layout)``:
``gx_a`` and ``gx_x`` normal times 2, ``ba`` and ``bx`` normal times 0.5,
``lam`` uniform in [0.0013, 0.132) as the model draws it, ``x`` and ``h``
normal; channel 0 has ``ba`` -1e4 (r = 0: a = 1 and the clamped scale
1e-6) and channel 1 ``lam`` 25 (softplus's linear branch). ``layout`` "bd"
gives contiguous tensors, "wide" passes ``gx_a``/``gx_x``, ``x`` and ``h``
as halves of (B,2D) buffers (rows by strides), "off" every tensor one
element into its storage (the element path). ``h'`` is held at
``RGLRU_TOL``, ``y`` at ``RGLRU_TOL`` in fp32 and ``TOL`` in bf16 (one
bf16 rounding of ``h'``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops, ref

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
WKV6_TOL = 1e-4
RGLRU_TOL = 1e-5

FLASH_SWEEP = [                           # the sweep of tests/test_kernels.py:23-28
    (1, 4, 4, 32, 32, 32, 0, None, True),       # MHA causal
    (2, 4, 2, 64, 128, 32, 64, None, True),     # GQA + prefix offset
    (1, 8, 1, 32, 64, 16, 32, 24, True),        # MQA + sliding window
    (2, 6, 2, 96, 96, 64, 0, None, True),       # non-pow2 heads (G=3)
]
# ragged lengths, engine-like suffixes, odd head widths (not Pallas-shaped)
FLASH_RAGGED = [
    (1, 8, 2, 37, 141, 32, 104, 24, True),
    (1, 32, 4, 37, 141, 128, 104, 24, True),    # the same at yi-6b's heads
    (1, 4, 2, 9, 29, 80, 20, None, True),       # danube-like hd=80, 9-token suffix
    (2, 6, 3, 20, 20, 48, 0, None, True),
    (1, 4, 1, 1, 70, 16, 69, None, True),       # one query row
    (1, 2, 2, 5, 5, 7, 0, None, True),          # odd hd
    (1, 2, 1, 3, 300, 256, 297, None, True),    # widest head the kernel takes
    (1, 4, 2, 20, 33, 32, 0, None, False),      # not causal
]
# rows whose causal/window band holds no key: the reference gives them the
# mean of V over all Sk keys
FLASH_EMPTY_BAND = [
    (1, 4, 2, 4, 6, 32, 10, 2, True),           # every row's band is empty
    (1, 8, 2, 12, 20, 16, 16, 4, True),         # one block: rows 0-6 see keys, 7-11 none
    (2, 6, 3, 40, 30, 64, 24, 6, True),         # a mixed block and an all-empty block
    (1, 4, 2, 12, 20, 32, 20, 8, False),        # not causal: rows 7-11 see none
    (1, 4, 4, 8, 16, 16, 0, 0, True),           # window 0: no row sees a key
]
# either side of the bf16 kernel's tiles: 64-key K/V tiles, 128 packed
# query rows (G heads x 128/G positions)
FLASH_TILES = [
    (1, 8, 2, 63, 65, 64, 2, None, True),         # Sq one below, Sk one above a tile
    (1, 8, 2, 65, 63, 64, 0, None, True),         # and the other way round
    (1, 4, 1, 127, 129, 128, 2, None, True),      # around two tiles
    (1, 4, 1, 129, 127, 128, 0, None, False),
    (1, 32, 4, 70, 301, 128, 231, None, True),    # q_offset no multiple of a tile
    (1, 64, 1, 5, 90, 64, 85, None, True),        # G = 64, the largest: 2 rows per head
    (1, 10, 1, 30, 40, 256, 30, 16, True),        # rows 24-29 share a block: 24 sees a key, 25-29 none
    (1, 4, 2, 50, 200, 80, 150, 37, True),        # hd 80, the window edge inside a tile
    (1, 10, 1, 40, 300, 256, 260, 100, True),     # hd 256, the window edge inside a tile
    (1, 4, 2, 33, 100, 136, 67, None, True),      # hd 136: a 64-column block wholly past hd
]
# (cold case, first hit row): the suffix rows of a cold prefill against the
# hit's call on the same keys with q_offset at that row
FLASH_IDENTITY = [
    ((1, 32, 4, 2560, 2560, 128, 0, None, True), 2048),   # yi-6b, turn 2
    ((1, 10, 1, 2560, 2560, 256, 0, 2048, True), 2048),   # recurrentgemma-2b
    ((1, 10, 1, 700, 700, 256, 0, 300, True), 333),       # a hit row off the blocks' edges
]
# recurrentgemma-2b's local attention: 10 query heads on one kv head of 256,
# window 2048; the model phase's prefill of 2,560 tokens, where the window
# masks keys
FLASH_GRIFFIN = [(1, 10, 1, 2560, 2560, 256, 0, 2048, True)]
# either side of the bf16 backward's tiles. Up to hd 128: 128 packed
# query rows a dQ block (G heads x 128/G positions) over 64-key K/V tiles; a
# dK/dV block of 64 keys (causal without a window) or 128 keys (64 a
# warpgroup: a window, or no causal mask) over 64-row Q/dO tiles; hd 64, 80
# and 128. Past it the wide kernels at 256 columns: 64 packed rows a dQ
# block (G = 10: 6 positions), 64-key dK/dV blocks; hd 136, 192 and 256
FLASH_BWD_TILES = [
    (1, 4, 4, 127, 129, 64, 2, None, True),       # G = 1: rows one below a dQ block, keys one above a dK/dV block
    (1, 4, 4, 129, 127, 128, 0, None, True),      # G = 1: the other way round
    (1, 8, 2, 33, 65, 80, 32, None, True),        # G = 4 (32 positions a dQ block): one above; keys one above a warpgroup
    (1, 8, 2, 31, 63, 80, 32, 40, True),          # one below both; the window edge inside a tile
    (1, 32, 4, 65, 200, 128, 135, 100, True),     # G = 8: rows one above a Q/dO tile, window 100
    (1, 64, 1, 3, 131, 64, 128, None, True),      # G = 64: 2 positions a dQ block; a dK/dV block of 3 keys
    (1, 8, 2, 63, 129, 80, 66, None, False),      # not causal: rows one below a Q/dO tile
    (1, 4, 1, 40, 100, 64, 100, 20, True),        # rows 19-39 see no key: a dQ block of both kinds, one of empty rows
    (1, 4, 2, 65, 129, 128, 0, None, True),       # hd 128, the tensor cores' widest ...
    (1, 4, 2, 65, 129, 136, 0, None, True),       # ... and hd 136, the wide kernels' narrowest: a column block zeroed
    (1, 8, 2, 127, 127, 80, 0, 64, True),         # window: keys one below a 128-key dK/dV block
    (1, 4, 4, 129, 129, 128, 0, 96, True),        # window: keys one above it, rows one above a dQ block
    (1, 16, 4, 50, 65, 64, 15, None, False),      # not causal: one key in the second warpgroup's 64
    (1, 10, 1, 5, 65, 256, 60, None, True),       # G = 10: rows one below a wide dQ block (6 positions), keys one above a dK/dV block
    (1, 10, 1, 7, 63, 256, 56, None, True),       # rows one above it, keys one below
    (1, 10, 1, 70, 200, 256, 130, 37, True),      # the window edge inside a tile
    (1, 2, 1, 65, 129, 256, 64, None, False),     # not causal: rows one above a Q/dO tile, keys one above two blocks
    (1, 10, 1, 40, 100, 192, 60, 50, True),       # hd 192: the fourth column block zero; window 50
    (1, 10, 1, 13, 64, 136, 50, 20, True),        # hd 136 at G = 10: 13 positions, two dQ blocks and one of a third
    # the fp32 route's own blocks and tiles (flash_attention.bwd_tf32_blocks):
    # dQ blocks of 16, 32, 64 or 128 positions of one head over 32-key K/V
    # tiles; dK/dV blocks of 16, 32, 64 or 128 keys over 32-row Q/dO tiles;
    # (rows, keys) in the comments
    (1, 4, 4, 31, 33, 64, 2, None, True),         # G = 1, (16, 16): rows one below a Q/dO tile, keys one above a K/V tile
    (1, 8, 2, 33, 31, 80, 0, None, False),        # G = 4, (16, 16), not causal: the other way round
    (2, 64, 8, 129, 129, 80, 0, None, True),      # G = 8, (128, 16): rows one above a dQ block of 128
    (2, 16, 8, 31, 1151, 80, 1120, 500, True),    # G = 2, (16, 128): keys one below nine dK/dV blocks of 128; window 500
    (2, 40, 8, 127, 127, 160, 0, None, True),     # G = 5 at hd 160, (64, 16): rows one below two dQ blocks of 64
    (1, 40, 8, 97, 161, 128, 64, 100, True),      # G = 5, (32, 16): rows one above three dQ blocks of 32; window 100
    (2, 16, 16, 127, 575, 128, 448, None, True),  # G = 1, (16, 64): keys one below nine dK/dV blocks of 64 and a tile
    (1, 10, 1, 33, 95, 192, 62, None, True),      # G = 10 past hd 128, (16, 16): rows one above a tile, keys one below
    (4, 4, 4, 63, 65, 192, 2, None, True),        # G = 1 at the 100M twin's hd, (16, 16)
    (1, 16, 8, 65, 1089, 192, 1024, 300, True),   # G = 2, (16, 64): keys one above 17 blocks of 64; window 300
    (2, 24, 4, 65, 97, 256, 32, None, True),      # G = 6 at hd 256, (32, 16): rows one above two dQ blocks of 32
    (2, 4, 4, 31, 543, 256, 512, None, True),     # G = 1 at hd 256, (16, 32): keys one below 17 blocks of 32
]
# either side of the fp32 forward's blocks and tiles (flash_tf32_kernel):
# blocks of 16, 32, ... 128 packed rows (flash_attention.fwd_tf32_rows: the
# G heads times rows/G positions; past hd 192 a group of more than 32 heads
# in parts of 32) over 32-key K/V tiles; hd 64, 80, 136 (the two-warp
# columns, HDP 192) and 256; (rows, positions a block) in the comments
FLASH_TF32_TILES = [
    (1, 4, 4, 31, 33, 80, 2, None, True),         # G = 1, (16, 16): rows one below two blocks, keys one above a tile
    (1, 4, 4, 33, 31, 80, 0, None, False),        # not causal: rows one above two blocks, keys one below a tile
    (2, 64, 8, 129, 129, 80, 0, None, True),      # G = 8, (128, 16): rows one above eight blocks of 128
    (4, 4, 4, 255, 257, 192, 2, None, True),      # the 100M twin's heads, (32, 32): one below eight blocks
    (1, 16, 16, 383, 383, 64, 0, None, True),     # G = 1, (48, 48): rows one below eight blocks of 48
    (1, 16, 16, 511, 511, 64, 0, None, True),     # G = 1, (64, 64): rows one below eight blocks of 64
    (1, 16, 16, 513, 1024, 64, 0, None, False),   # G = 1, (64, 64), not causal: one above eight blocks
    (1, 16, 16, 641, 641, 64, 0, 100, True),      # G = 1, (80, 80): one above eight blocks; window 100
    (1, 16, 16, 767, 767, 64, 0, None, True),     # G = 1, (96, 96): one below eight blocks of 96
    (1, 16, 16, 785, 785, 64, 0, None, True),     # G = 1, (112, 112): one above seven blocks of 112
    (1, 4, 2, 40, 100, 80, 100, 20, True),        # G = 2, (16, 8): rows 19-39 see no key, a block of both kinds
    (1, 8, 2, 33, 100, 136, 67, None, True),      # hd 136, G = 4, (16, 4): rows one above eight blocks
    (1, 8, 2, 50, 200, 136, 150, 45, True),       # hd 136: the window edge inside a tile
    (1, 64, 1, 4, 65, 136, 61, None, True),       # G = 64 at hd 136, (64, 1): keys one above two tiles
    (1, 64, 1, 5, 90, 80, 85, None, True),        # G = 64 at hd 80, (64, 1)
    (1, 10, 1, 70, 200, 256, 130, 37, True),      # hd 256, G = 10, (16, 1): the window edge inside a tile
    (1, 64, 1, 3, 70, 256, 67, None, True),       # G = 64 at hd 256: two blocks of 32 heads a position
]
# the backward at the forward's cases, its own tiles' edges, and at the
# training shapes
FLASH_BWD = (FLASH_SWEEP + FLASH_RAGGED + FLASH_EMPTY_BAND + FLASH_TILES
             + FLASH_TF32_TILES + FLASH_BWD_TILES)
FLASH_BWD_TRAIN = {
    "h2o-danube-1.8b": (1, 32, 8, 8192, 8192, 80, 0, 4096, True),
    "yi-6b": (1, 32, 4, 4096, 4096, 128, 0, None, True),
    "100M twin": (4, 4, 4, 256, 256, 192, 0, None, True),
    "enc-dec cross": (1, 16, 16, 512, 1024, 64, 0, None, False),
    # its 8 local-attention layers at 8,192 tokens, hd 256: the wide kernels
    "recurrentgemma-2b": (1, 10, 1, 8192, 8192, 256, 0, 2048, True),
}
DECODE_SWEEP = [                          # the sweep of tests/test_kernels.py:42-46
    (1, 4, 4, 64, 32, 64, 0),
    (2, 8, 2, 256, 64, 100, 0),
    (1, 4, 1, 128, 16, 1, 0),
]
DECODE_RAGGED = [
    (2, 6, 2, 77, 80, 40, 60),            # no tile divides W; hd=80; wraps the ring
    (1, 4, 2, 50, 8, 0, 0),               # no valid slot: mean of V over W
    (1, 8, 2, 300, 32, 0, 0),             # no valid slot, W over several chunks
    (1, 32, 4, 1000, 128, 700, 900),      # yi-6b's heads, a wrapped window
    (1, 40, 2, 300, 64, 170, 250),        # G = 20: two groups of 16 query rows
    (2, 8, 2, 130, 72, 90, 100),          # hd 72, not a multiple of 16
    (2, 4, 2, 1, 32, 1, 0),               # W = 1
    (1, 8, 2, 300, 32, 1, 299),           # one valid slot, in the last chunk only
    (1, 8, 2, 200, 64, 120, 150, 1),      # caches one element off a 16-byte boundary
    (1, 2, 1, 40, 320, 30, 5),            # hd 320: bf16 on the CUDA-core kernel
    (1, 4, 2, 90, 7, 60, 20),             # odd hd: element-by-element fill, scalar merge
]
# the two main paths' shapes: yi-6b's step at the end of turn 2 (4,096 slots,
# 2,568 valid), recurrentgemma-2b's (a ring of 1,024, 584 valid)
DECODE_MAIN = [
    (1, 32, 4, 4096, 128, 2568, 0),
    (1, 10, 1, 1024, 256, 584, 0),
]
# the fixed cost of a call that does almost no work: one kv head, W = 64,
# one valid slot
DECODE_FLOOR = [(1, 8, 1, 64, 128, 1, 0)]
DECODE_GRIFFIN = [                        # recurrentgemma-2b's heads, a ring of 2,048
    (1, 10, 1, 2048, 256, 2048, 1500),    # full, wrapped: the window at pos > 2048
    (1, 10, 1, 2048, 256, 700, 1800),     # fewer valid slots, across the wrap
]

WKV6_SWEEP = [                            # the sweep of tests/test_kernels.py:83-84
    (1, 2, 16, 16, None, 0.1, "bhsd"),
    (2, 4, 32, 32, None, 0.1, "bhsd"),
    (1, 1, 64, 64, None, 0.1, "bhsd"),
]
WKV6_EDGE = [
    (2, 3, 1, 64, None, 0.1, "bhsd"),           # one token: the engine's call
    (1, 2, 33, 32, None, 0.1, "bhsd"),          # S not a multiple of the staging
    (1, 3, 20, 48, None, 0.1, "bhsd"),          # hd below its template width
    (1, 2, 24, 128, None, 0.1, "bhsd"),         # the widest head the kernel takes
    (1, 2, 20, 32, 0.0, 0.1, "bhsd"),           # decay 0: the state forgets at once
    (1, 2, 20, 32, 0.07, 0.1, "bhsd"),
    (1, 2, 20, 32, 0.999, 0.1, "bhsd"),
    (1, 2, 40, 32, 1.0, 0.1, "bhsd"),           # no decay: the state only grows
    (2, 2, 16, 32, None, 0.0, "bhsd"),          # zero initial state
    (2, 3, 19, 64, None, 0.1, "bshd"),          # the model's layout, read in place
]
# the time loop's 8-column slices and its staging chunks (16 steps, 8 at hd
# 128; csrc/wkv6.cu) either side, B·H so small that the grid is one to three
# heads' slices
WKV6_SLICE = [
    (1, 1, 15, 64, None, 0.1, "bshd", "bf16"),  # one step short of a chunk
    (1, 1, 16, 64, 0.0, 0.1, "bshd", "bf16"),   # one whole chunk, decay 0
    (1, 1, 17, 64, 1.0, 0.1, "bshd", "fp32"),   # a chunk and a step, no decay
    (1, 2, 33, 64, None, 0.1, "bshd", "bf16"),  # two chunks and a step
    (1, 2, 17, 48, None, 0.1, "bshd", "bf16"),  # 6 slices of 8 in a 64-wide kernel
    (2, 1, 33, 100, None, 0.1, "bshd", "bf16"),  # a partial slice, rows past hd
    (1, 1, 16, 100, 1.0, 0.1, "bhsd", "fp32"),
    (1, 3, 33, 64, None, 0.1, "off", "bf16"),   # off 16 bytes: element path
    (1, 1, 17, 128, None, 0.1, "bshd", "bf16"),  # chunks of 8 at hd 128
]
# no token: y is empty and s_n is s0 (the Pallas kernel takes no S = 0)
WKV6_NO_TOKEN = [(1, 2, 0, 32, None, 0.1, "bhsd")]
# one token: the step kernel (8-column slices, one warp each)
WKV6_STEP = [
    (1, 32, 1, 64, None, 0.1, "bshd", "bf16"),  # rwkv6-1.6b's engine step
    (1, 32, 1, 64, None, 0.1, "bshd", "fp32"),
    (2, 32, 1, 64, None, 0.1, "bhsd", "bf16"),  # B·H 64
    (1, 4, 1, 128, None, 0.1, "bshd", "bf16"),  # the widest head: 8 slices
    (2, 3, 1, 100, None, 0.1, "bshd", "bf16"),  # a partial slice, rows past hd
    (1, 5, 1, 32, None, 0.1, "bhsd", "fp32"),
    (1, 2, 1, 48, 0.0, 0.0, "bshd", "bf16"),    # decay 0, zero state
    (1, 3, 1, 64, None, 0.1, "off", "bf16"),    # off 16 bytes: element path
    (1, 3, 1, 64, None, 0.1, "off", "fp32"),
    (1, 2, 1, 7, None, 0.1, "bhsd", "fp32"),    # odd hd: element path
    (1, 1, 1, 1, None, 0.1, "bhsd", "bf16"),    # hd 1
]
# the fixed cost of a step call: one head of 32
WKV6_FLOOR = [(1, 1, 1, 32, None, 0.1, "bhsd", "bf16")]
# the time loop with bf16 r, k, v, as the model's prefill passes them
WKV6_BF16 = [(1, 3, 20, 64, None, 0.1, "bshd", "bf16")]
# the backward (and the training entry): every forward case above, with a
# random ds_n, then S = 1 and 0, the checkpoint interval (16) and one step
# more, hd 1 and 80, bf16 and fp32 r/k/v, ds_n zero (None) and random, the
# model's views and the off-16-byte element path
WKV6_BWD = [c[:7] + (c[7] if len(c) > 7 else "fp32", "random")
            for c in (WKV6_SWEEP + WKV6_EDGE + WKV6_SLICE + WKV6_NO_TOKEN + WKV6_STEP
                      + WKV6_FLOOR + WKV6_BF16)] + [
    (1, 2, 0, 32, None, 0.1, "bhsd", "fp32", "zero"),    # no token: ds0 = 0
    (1, 2, 1, 64, None, 0.1, "bshd", "bf16", "zero"),    # one token (the step kernel)
    (1, 3, 16, 64, None, 0.1, "bshd", "bf16", "zero"),   # one whole chunk
    (1, 3, 17, 64, None, 0.1, "bshd", "bf16", "random"),  # and a chunk of one step
    (2, 2, 33, 1, None, 0.1, "bhsd", "fp32", "random"),  # hd 1
    (1, 2, 40, 80, None, 0.1, "bshd", "bf16", "random"),  # hd 80: the 128-wide kernels
    (1, 2, 37, 80, None, 0.1, "off", "fp32", "zero"),
    (2, 3, 50, 64, None, 0.1, "bshd", "fp32", "zero"),
    (1, 2, 40, 32, 0.0, 0.1, "bhsd", "bf16", "random"),  # decay 0
    (1, 2, 48, 64, 1.0, 0.1, "bhsd", "fp32", "random"),  # no decay
]
# rwkv6-1.6b's layer at 4,096 tokens, r, k, v bf16 as the model passes them;
# the model reads no s_n, so ds_n is None
WKV6_BWD_TRAIN = {"rwkv6-1.6b": (1, 32, 4096, 64, None, 0.1, "bshd", "bf16", "zero")}

RGLRU_SWEEP = [                           # the sweep of tests/test_kernels.py:70-71
    (1, 16, 64, "bsd"),
    (2, 33, 128, "bsd"),
    (3, 8, 96, "bsd"),
]
RGLRU_EDGE = [
    (1, 1, 2560, "bsd"),                  # recurrentgemma-2b's engine step
    (1, 2560, 2560, "bsd"),               # its model phase's prefill
    (3, 12, 77, "bsd"),                   # no block size divides D
    (2, 9, 300, "bsd"),                   # two channel blocks, the last partial
    (2, 19, 200, "wide"),                 # rows read by strides
]
# the forward's 128-step chunks (csrc/rglru_scan.cu) either side: one whole
# chunk (the plain version's bits), one step into a second, a partial third;
# odd D, strided rows, three batches
RGLRU_CHUNK = [
    (1, 128, 77, "bsd"),
    (3, 129, 77, "wide"),
    (3, 257, 200, "bsd"),
    (2, 257, 96, "wide"),
]
# no token: y is empty and h_S is h0 (the Pallas kernel takes no S = 0)
RGLRU_NO_TOKEN = [(1, 0, 64, "bsd")]
# the fixed cost of a scan call: one step of 32 channels
RGLRU_FLOOR = [(1, 1, 32, "bsd")]
# the scan's backward: every scan case above with a random dh_S, and a few
# with none (dh_S zero, as the model's training passes it); then the edges
# of the backward's 128-step chunks (csrc/rglru_scan.cu): one whole chunk, one
# step into a second, and a partial last chunk
RGLRU_BWD = [c + ("random",) for c in RGLRU_SWEEP + RGLRU_EDGE + RGLRU_CHUNK
             + RGLRU_NO_TOKEN + RGLRU_FLOOR] + [
    (2, 33, 128, "bsd", "zero"),
    (2, 19, 200, "wide", "zero"),
    (1, 0, 64, "bsd", "zero"),            # no token: dh0 = 0
    (1, 128, 64, "bsd", "random"),
    (2, 129, 96, "wide", "zero"),
    (3, 300, 77, "bsd", "random"),
]
# recurrentgemma-2b's recurrent layer at 8,192 tokens
RGLRU_BWD_TRAIN = {"recurrentgemma-2b": (1, 8192, 2560, "bsd", "zero")}
RGLRU_STEP = [
    (1, 2560, "bf16", "bd"),              # recurrentgemma-2b's engine step
    (1, 2560, "fp32", "bd"),
    (2, 77, "bf16", "wide"),              # B 2, odd D, rows by strides
    (2, 77, "fp32", "bd"),
    (3, 1030, "fp32", "wide"),            # three blocks, D % 4 = 2
    (2, 300, "bf16", "off"),              # off 16 bytes: element path
    (1, 32, "bf16", "bd"),                # the step's floor
]


def flash_visible(case):
    """(visible (query, key) pairs, rows whose band is empty) of a case."""
    B, H, KV, Sq, Sk, hd, off, win, causal = case
    pairs = empty = 0
    for i in range(Sq):
        pos = off + i
        lo = 0 if win is None else max(0, pos - win + 1)
        hi = min(Sk - 1, pos) if causal else Sk - 1
        if lo > hi:
            empty += 1
        else:
            pairs += hi - lo + 1
    return pairs, empty


def decode_valid(W: int, nvalid: int, start: int) -> np.ndarray:
    """int32 (W,): 1 on the ``nvalid`` slots from ``start`` around the ring."""
    valid = np.zeros(W, np.int32)
    valid[(start + np.arange(nvalid)) % W] = 1
    return valid


def _randn(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def flash_inputs(case, dtype, device, seed=0):
    """q (B,H,Sq,hd), k, v (B,KV,Sk,hd), drawn with numpy from ``seed``."""
    B, H, KV, Sq, Sk, hd = case[:6]
    return [torch.from_numpy(x).to(device=device, dtype=dtype)
            for x in _randn(seed, (B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd))]


def at_offset(t, offset: int):
    """A copy of contiguous ``t`` whose data starts ``offset`` elements into
    its storage."""
    if not offset:
        return t
    buf = t.new_empty(t.numel() + offset)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def decode_inputs(case, dtype, device, seed=0):
    """q (B,H,hd), caches as the model holds them, (B,W,KV,hd), passed as
    permuted (B,KV,W,hd) views (at the case's storage offset), and
    ``valid``."""
    B, H, KV, W, hd, nvalid, start = case[:7]
    offset = case[7] if len(case) > 7 else 0
    q, kc, vc = (torch.from_numpy(x).to(device=device, dtype=dtype)
                 for x in _randn(seed, (B, H, hd), (B, W, KV, hd), (B, W, KV, hd)))
    kc, vc = at_offset(kc, offset), at_offset(vc, offset)
    valid = torch.from_numpy(decode_valid(W, nvalid, start)).to(device)
    return q, kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3), valid


def _bf16_values(x):
    """fp32 ``x`` rounded to bf16 (to nearest even) and back: exact in bf16."""
    return torch.from_numpy(x).bfloat16().float().numpy()


def _rkv_bf16(case) -> bool:
    return len(case) > 7 and case[7] == "bf16"


def _layout(t, layout):
    """Contiguous (B,H,S,hd) ``t`` in a WKV6 case's layout: "bshd" a
    permuted view of a (B,S,H,hd) buffer, "off" a copy one element into its
    storage."""
    if layout == "bshd":
        return t.transpose(1, 2).contiguous().transpose(1, 2)
    return at_offset(t, 1) if layout == "off" else t


def wkv6_arrays(case, seed=0):
    """numpy r, k, v, w (B,H,S,hd), u (H,hd), s0 (B,H,hd,hd), all fp32; for
    a bf16 case r, k and v hold bf16 values."""
    B, H, S, hd, decay, s0_scale = case[:6]
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, S, hd)).astype(np.float32) for _ in range(3))
    if _rkv_bf16(case):
        r, k, v = map(_bf16_values, (r, k, v))
    if decay is None:
        w = rng.uniform(0.8, 0.999, (B, H, S, hd)).astype(np.float32)
    else:
        w = np.full((B, H, S, hd), decay, np.float32)
    u = rng.uniform(0.0, 1.0, (H, hd)).astype(np.float32)
    s0 = (rng.standard_normal((B, H, hd, hd)) * s0_scale).astype(np.float32)
    return r, k, v, w, u, s0


def wkv6_inputs(case, device, seed=0):
    """The arrays of ``wkv6_arrays`` as torch tensors on ``device``, r, k, v
    in the case's dtype; in the "bshd" layout r, k, v, w are permuted views
    of (B,S,H,hd) buffers, in "off" every tensor starts one element into its
    storage."""
    r, k, v, w, u, s0 = (torch.from_numpy(x).to(device) for x in wkv6_arrays(case, seed))
    if _rkv_bf16(case):
        r, k, v = (t.bfloat16() for t in (r, k, v))
    r, k, v, w = (_layout(t, case[6]) for t in (r, k, v, w))
    if case[6] == "off":
        u, s0 = at_offset(u, 1), at_offset(s0, 1)
    return [r, k, v, w, u, s0]


def rglru_arrays(case, seed=0):
    """numpy a, b (B,S,D) and h0 (B,D), all fp32."""
    B, S, D, _ = case
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.7, 0.999, (B, S, D)).astype(np.float32)
    b = (rng.standard_normal((B, S, D)) * 0.1).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    return a, b, h0


def rglru_inputs(case, device, seed=0):
    """The arrays of ``rglru_arrays`` as torch tensors on ``device``; in the
    "wide" layout a and b are the halves of one (B,S,2D) buffer and h0 half
    of a (B,2D) buffer."""
    a, b, h0 = (torch.from_numpy(x).to(device) for x in rglru_arrays(case, seed))
    if case[3] == "wide":
        D = a.shape[-1]
        ab = torch.cat([a, b], dim=-1)
        a, b = ab[..., :D], ab[..., D:]
        h0 = torch.cat([h0, torch.zeros_like(h0)], dim=-1)[:, :D]
    return [a, b, h0]


def rglru_step_arrays(case, seed=0):
    """numpy gx_a, gx_x (B,D), ba, bx, lam (D,), x (B,D) (bf16 values for a
    bf16 case) and h (B,D), all fp32, as the table above draws them."""
    B, D = case[:2]
    rng = np.random.default_rng(seed)
    gx_a, gx_x = ((rng.standard_normal((B, D)) * 2).astype(np.float32) for _ in range(2))
    ba, bx = ((rng.standard_normal(D) * 0.5).astype(np.float32) for _ in range(2))
    lam = rng.uniform(0.0013, 0.1320, D).astype(np.float32)
    ba[0] = -1e4
    if D > 1:
        lam[1] = 25.0
    x, h = (rng.standard_normal((B, D)).astype(np.float32) for _ in range(2))
    if case[2] == "bf16":
        x = _bf16_values(x)
    return gx_a, gx_x, ba, bx, lam, x, h


def rglru_step_inputs(case, device, seed=0):
    """The arrays of ``rglru_step_arrays`` as tensors on ``device``, x in the
    case's dtype, laid out as the case says."""
    gx_a, gx_x, ba, bx, lam, x, h = (torch.from_numpy(a).to(device)
                                     for a in rglru_step_arrays(case, seed))
    if case[2] == "bf16":
        x = x.bfloat16()
    if case[3] == "wide":
        D = x.shape[1]
        g = torch.cat([gx_a, gx_x], dim=1)
        gx_a, gx_x = g[:, :D], g[:, D:]
        x, h = (torch.cat([t, torch.zeros_like(t)], dim=1)[:, :D] for t in (x, h))
    elif case[3] == "off":
        gx_a, gx_x, ba, bx, lam, x, h = (at_offset(t, 1)
                                         for t in (gx_a, gx_x, ba, bx, lam, x, h))
    return [gx_a, gx_x, ba, bx, lam, x, h]


def held(name, case, out, want, tol=None) -> float:
    """max |out - want|; raises unless ``out`` is within the tolerance above
    (``TOL`` of the dtype unless ``tol`` is given)."""
    if out.shape != want.shape or out.dtype != want.dtype:
        raise AssertionError(f"{name} {case}: {out.dtype} {tuple(out.shape)}, "
                             f"want {want.dtype} {tuple(want.shape)}")
    if want.numel() == 0:
        return 0.0
    a, b = out.float(), want.float()
    err = (a - b).abs()
    tol = TOL[want.dtype] if tol is None else tol
    scale = min(1.0, float(b.abs().max()))
    if not bool(torch.isfinite(a).all()) or bool((err > tol * (scale + b.abs())).any()):
        raise AssertionError(f"{name} {case} {want.dtype}: max |err| "
                             f"{float(err.max()):.3e}, output scale {scale:.3e}")
    return float(err.max())


def check_flash(case, dtype, device, seed=0):
    """The kernel against its plain version on ``case``; (max |err|, inputs)."""
    q, k, v = flash_inputs(case, dtype, device, seed)
    off, win, causal = case[6:]
    out = ops.flash_attention(q, k, v, q_offset=off, window=win, causal=causal)
    want = ref.flash_attention_ref(q, k, v, q_offset=off, window=win, causal=causal)
    return held("flash_attention", case, out, want), (q, k, v)


def flash_bwd_inputs(case, dtype, device, seed=0):
    """q, k, v as ``flash_inputs`` and the output gradient (B,H,Sq,hd),
    drawn with numpy from ``seed + 1``."""
    B, H, KV, Sq, Sk, hd = case[:6]
    (g,) = _randn(seed + 1, (B, H, Sq, hd))
    return flash_inputs(case, dtype, device, seed) + [
        torch.from_numpy(g).to(device=device, dtype=dtype)]


def check_flash_bwd(case, dtype, device, seed=0):
    """dq, dk, dv through autograd of ``ops.flash_attention`` (on the card:
    the forward kernel, then ``ops.flash_attention_bwd``) against the plain
    version's; (max |err|, (q, k, v, out, dout))."""
    q, k, v, dout = flash_bwd_inputs(case, dtype, device, seed)
    off, win, causal = case[6:]
    kw = dict(q_offset=off, window=win, causal=causal)
    with torch.enable_grad():
        leaves = [t.requires_grad_(True) for t in (q, k, v)]
        out = ops.flash_attention(*leaves, **kw)
        got = torch.autograd.grad(out, leaves, dout)
    q, k, v, out = (t.detach() for t in (q, k, v, out))
    want = ref.flash_attention_bwd_ref(q, k, v, dout, **kw)
    err = max(held(f"flash_attention_bwd d{n}", case, a, b)
              for n, a, b in zip("qkv", got, want))
    return err, (q, k, v, out, dout)


def check_flash_bwd_repeat(case, dtype, device, seed=0):
    """Two calls of ``ops.flash_attention_bwd`` on the same inputs (with the
    training entry's output and lse) must give the same bits; raises unless
    they do."""
    q, k, v, dout = flash_bwd_inputs(case, dtype, device, seed)
    kw = dict(q_offset=case[6], window=case[7], causal=case[8])
    out, lse = ops.flash_attention_train(q, k, v, **kw)
    first, second = (ops.flash_attention_bwd(q, k, v, out, dout, lse=lse, **kw)
                     for _ in range(2))
    for n, a, b in zip("qkv", first, second):
        if not torch.equal(a, b):
            raise AssertionError(f"flash_attention_bwd {case} {dtype}: d{n} differs between "
                                 f"two calls in {int((a != b).sum())} entries")


def check_flash_bwd_keys(case, keys, device, seed=0):
    """``ops.flash_attention_bwd`` in bf16 with dK/dV blocks of ``keys``
    (whichever ``bwd_keys`` would choose), on the training entry's output
    and lse, against the plain version; max |err|."""
    q, k, v, dout = flash_bwd_inputs(case, torch.bfloat16, device, seed)
    kw = dict(q_offset=case[6], window=case[7], causal=case[8])
    out, lse = ops.flash_attention_train(q, k, v, **kw)
    got = ops.flash_attention_bwd(q, k, v, out, dout, lse=lse, keys=keys, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, dout, **kw)
    return max(held(f"flash_attention_bwd keys={keys} d{n}", case, a, b)
               for n, a, b in zip("qkv", got, want))


def check_flash_train(case, dtype, device, seed=0):
    """The training entry against the serving entry (the same output bits)
    and its lse against the plain version's within ``TOL`` of fp32; max
    |lse err|."""
    q, k, v = flash_inputs(case, dtype, device, seed)
    kw = dict(q_offset=case[6], window=case[7], causal=case[8])
    out, lse = ops.flash_attention_train(q, k, v, **kw)
    with torch.no_grad():
        served = ops.flash_attention(q, k, v, **kw)
    if not torch.equal(out, served):
        raise AssertionError(f"flash_attention_train {case} {dtype}: the output differs from "
                             f"the serving entry's in {int((out != served).sum())} entries")
    _, want = ref.flash_attention_lse_ref(q, k, v, **kw)
    return held("flash_attention_train lse", case, lse, want)


def check_flash_hit_rows(case, first, dtype, device, seed=0):
    """Rows ``first..`` of a cold call on ``case`` against a hit call that
    starts its queries there (``q_offset=first``, the same K/V); the number
    of rows that differ, and raises unless there is none."""
    q, k, v = flash_inputs(case, dtype, device, seed)
    win, causal = case[7:]
    cold = ops.flash_attention(q, k, v, q_offset=0, window=win, causal=causal)
    hit = ops.flash_attention(q[:, :, first:], k, v, q_offset=first, window=win,
                              causal=causal)
    differ = int((cold[:, :, first:] != hit).any(dim=-1).sum())
    if differ:
        raise AssertionError(f"flash_attention {case} hit at {first}: {differ} rows "
                             "differ from the cold call's")
    return differ


def check_decode(case, dtype, device, seed=0):
    """The kernel against its plain version on ``case``; (max |err|, inputs)."""
    q, k, v, valid = decode_inputs(case, dtype, device, seed)
    out = ops.decode_attention(q, k, v, valid)
    want = ref.decode_attention_ref(q, k, v, valid)
    return held("decode_attention", case, out, want), (q, k, v, valid)


def check_wkv6(case, device, seed=0):
    """The kernel against its plain version on ``case``, on ``y`` and
    ``s_n``; (max |err|, inputs)."""
    inputs = wkv6_inputs(case, device, seed)
    y, sn = ops.wkv6(*inputs)
    want_y, want_sn = ref.wkv6_ref(*inputs)
    err = max(held("wkv6 y", case, y, want_y, WKV6_TOL),
              held("wkv6 s_n", case, sn, want_sn, WKV6_TOL))
    return err, inputs


def check_rglru(case, device, seed=0):
    """The kernel against its plain version on ``case``, on ``y`` and
    ``h_S``; (max |err|, inputs)."""
    inputs = rglru_inputs(case, device, seed)
    y, hn = ops.rglru_scan(*inputs)
    want_y, want_hn = ref.rglru_scan_ref(*inputs)
    err = max(held("rglru y", case, y, want_y, RGLRU_TOL),
              held("rglru h_S", case, hn, want_hn, RGLRU_TOL))
    return err, inputs


def check_rglru_repeat(case, device, seed=0):
    """Two calls of ``ops.rglru_scan`` on the same inputs must give the same
    bits; raises unless they do."""
    inputs = rglru_inputs(case, device, seed)
    first, second = (ops.rglru_scan(*inputs) for _ in range(2))
    for n, x, w in zip(("y", "h_S"), first, second):
        if not torch.equal(x, w):
            raise AssertionError(f"rglru_scan {case}: {n} differs between two calls in "
                                 f"{int((x != w).sum())} entries")


def check_rglru_step(case, device, seed=0):
    """The fused step against its plain version on ``case``, on ``y`` and
    ``h'``; (max |err|, inputs)."""
    inputs = rglru_step_inputs(case, device, seed)
    y, hn = ops.rglru_step(*inputs)
    want_y, want_hn = ref.rglru_step_ref(*inputs)
    y_tol = RGLRU_TOL if want_y.dtype == torch.float32 else None
    err = max(held("rglru_step y", case, y, want_y, y_tol),
              held("rglru_step h", case, hn, want_hn, RGLRU_TOL))
    return err, inputs


def wkv6_bwd_inputs(case, device, seed=0):
    """The forward's inputs of ``wkv6_inputs``, the output gradient dy
    (B,H,S,hd) fp32 in the case's layout, and ds_n (B,H,hd,hd) fp32, or
    None where the case says "zero"; both normal, drawn from ``seed + 1``."""
    B, H, S, hd = case[:4]
    dy, dsn = _randn(seed + 1, (B, H, S, hd), (B, H, hd, hd))
    dy = _layout(torch.from_numpy(dy).to(device), case[6])
    dsn = torch.from_numpy(dsn).to(device) if case[8] == "random" else None
    return wkv6_inputs(case[:8], device, seed), dy, dsn


def _bwd_tol(t):
    """The tolerance of a gradient returned in ``t``'s dtype: one bf16
    rounding of an fp32 sum (``TOL``) or WKV6_TOL in fp32."""
    return TOL[torch.bfloat16] if t.dtype == torch.bfloat16 else WKV6_TOL


def check_wkv6_bwd(case, device, seed=0):
    """dr, dk, dv, dw, du and ds0 through autograd of ``ops.wkv6`` (on the
    card: the training entry, then ``ops.wkv6_bwd``) against
    ``ref.wkv6_bwd_ref`` on the plain training entry's checkpoints; (max
    |err|, (inputs, dy, ds_n))."""
    inputs, dy, dsn = wkv6_bwd_inputs(case, device, seed)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        y, sn = ops.wkv6(*leaves)
        outs, grads = ((y, sn), (dy, dsn)) if dsn is not None else ((y,), (dy,))
        got = torch.autograd.grad(outs, leaves, grads, allow_unused=True)
    # at S = 0 the plain version's graph reaches neither k, v, w nor u
    got = [torch.zeros_like(t) if g is None else g for g, t in zip(got, inputs)]
    _, _, ckpt = ref.wkv6_train_ref(*inputs, ref.WKV6_EVERY)
    want = ref.wkv6_bwd_ref(*inputs, ckpt, dy, dsn)
    err = max(held(f"wkv6_bwd d{n}", case, a, b, _bwd_tol(b))
              for n, a, b in zip(("r", "k", "v", "w", "u", "s0"), got, want))
    return err, (inputs, dy, dsn)


def check_wkv6_bwd_repeat(case, device, seed=0):
    """Two calls of ``ops.wkv6_bwd`` on the same inputs (with the training
    entry's checkpoints) must give the same bits; raises unless they do."""
    inputs, dy, dsn = wkv6_bwd_inputs(case, device, seed)
    _, _, ckpt = ops.wkv6_train(*inputs)
    first, second = (ops.wkv6_bwd(*inputs, ckpt, dy, dsn) for _ in range(2))
    for n, a, b in zip(("r", "k", "v", "w", "u", "s0"), first, second):
        if not torch.equal(a, b):
            raise AssertionError(f"wkv6_bwd {case}: d{n} differs between two calls in "
                                 f"{int((a != b).sum())} entries")


def check_wkv6_train(case, device, seed=0):
    """The training entry against the serving entry (the same y and s_n
    bits) and its checkpoints against ``ref.wkv6_train_ref``'s within
    ``WKV6_TOL``; max |ckpt err|."""
    inputs = wkv6_inputs(case[:8], device, seed)
    y, sn, ckpt = ops.wkv6_train(*inputs)
    with torch.no_grad():
        served = ops.wkv6(*inputs)
    for n, a, b in (("y", y, served[0]), ("s_n", sn, served[1])):
        if not torch.equal(a, b):
            raise AssertionError(f"wkv6_train {case}: {n} differs from the serving entry's "
                                 f"in {int((a != b).sum())} entries")
    _, _, want = ref.wkv6_train_ref(*inputs, ref.WKV6_EVERY)
    return held("wkv6_train ckpt", case, ckpt, want, WKV6_TOL)


def rglru_bwd_inputs(case, device, seed=0):
    """The scan's inputs of ``rglru_inputs``, the output gradient dy (B,S,D)
    (in the "wide" layout half of a (B,S,2D) buffer) and dh_S (B,D), or
    None where the case says "zero"; both normal, drawn from ``seed + 1``."""
    B, S, D = case[:3]
    dy, dh = (torch.from_numpy(x).to(device) for x in _randn(seed + 1, (B, S, D), (B, D)))
    if case[3] == "wide":
        dy = torch.cat([dy, torch.zeros_like(dy)], dim=-1)[..., :D]
    return rglru_inputs(case[:4], device, seed), dy, dh if case[4] == "random" else None


def check_rglru_bwd(case, device, seed=0):
    """da, db and dh0 through autograd of ``ops.rglru_scan`` (on the card:
    the scan, then ``ops.rglru_scan_bwd``) against
    ``ref.rglru_scan_bwd_ref`` on the plain scan's output, at
    ``RGLRU_TOL``; (max |err|, (inputs, dy, dh_S))."""
    inputs, dy, dh = rglru_bwd_inputs(case, device, seed)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        y, hn = ops.rglru_scan(*leaves)
        outs, grads = ((y, hn), (dy, dh)) if dh is not None else ((y,), (dy,))
        got = torch.autograd.grad(outs, leaves, grads, allow_unused=True)
    # at S = 0 the plain version's graph reaches neither a nor b
    got = [torch.zeros_like(t) if g is None else g for g, t in zip(got, inputs)]
    a, b, h0 = inputs
    want = ref.rglru_scan_bwd_ref(a, h0, ref.rglru_scan_ref(a, b, h0)[0], dy, dh)
    err = max(held(f"rglru_scan_bwd d{n}", case, x, w, RGLRU_TOL)
              for n, x, w in zip(("a", "b", "h0"), got, want))
    return err, (inputs, dy, dh)


def check_rglru_bwd_repeat(case, device, seed=0):
    """Two calls of ``ops.rglru_scan_bwd`` on the same inputs must give the
    same bits; raises unless they do."""
    (a, b, h0), dy, dh = rglru_bwd_inputs(case, device, seed)
    y, _ = ops.rglru_scan(a, b, h0)
    first, second = (ops.rglru_scan_bwd(a, h0, y, dy, dh) for _ in range(2))
    for n, x, w in zip(("a", "b", "h0"), first, second):
        if not torch.equal(x, w):
            raise AssertionError(f"rglru_scan_bwd {case}: d{n} differs between two calls "
                                 f"in {int((x != w).sum())} entries")
