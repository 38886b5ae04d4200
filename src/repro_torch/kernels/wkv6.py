"""RWKV6 WKV recurrence: wrapper of ``csrc/wkv6.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/wkv6.py`` (``wkv6`` /
``_wkv_kernel``): per (batch, head) the hd×hd fp32 state is carried through
the sequence, ``y_t`` read from the state before the update plus the ``u``
bonus, then ``S_{t+1} = diag(w_t) S_t + k_t ⊗ v_t``.

On the H100 the engine's call (one token, 32 heads of 64) is bound by the
state's bytes, about 0.33 µs, far below the fixed cost of a launch, so what
it costs is latency; the prefill of 2,048 tokens is bound by bytes and fp32
operations alike, about 25 µs. Two kernels behind one entry:

* ``S == 1`` (every engine step): ``wkv6_step_kernel`` splits each head's
  state into 8-column slices, one warp each (256 CTAs at (1,32,1,64)); a
  lane holds 4 columns of hd/16 rows, issues every load of the call (16-byte
  ``float4`` state rows) before the first use, and sums ``y`` over rows by
  warp shuffles: no shared memory, no barrier.
* ``S == 0`` or ``S >= 2``: ``wkv6_kernel`` gives each (batch, head) one
  block that keeps the state in registers for the whole sequence and stages
  ``r, k, v, w`` in shared memory 16 steps at a time (8 at hd 128), loaded
  a chunk ahead as 4-element vectors when the views are aligned; with 32
  blocks for 132 SMs and a dependent chain of S steps it sits far above its
  bound at long S (see ``PERF.md``).

``r``, ``k`` and ``v`` may be bf16 (all three alike): the kernels read them
as they are and upcast in registers, which is exact, so the result is the
fp32 call's on the upcast values, bit for bit; the model passes its bf16
activations without a cast. ``w``, ``u`` and ``s0`` are fp32, and so are
``y`` and ``s_n``. Every tensor goes by strides with its last dimension
contiguous: the model passes its ``(B,S,H,hd)`` activations as permuted
``(B,H,S,hd)`` views and the kernel reads them in place. ``y`` is allocated
in ``r``'s memory layout (``torch.empty_like``), so for such views it is a
``(B,S,H,hd)`` buffer that the model reads back without a copy.
``1 <= hd <= MAX_HEAD_DIM``; any ``S >= 0`` (at ``S = 0``, ``y`` is empty
and ``s_n`` equals ``s0``).

A tensor on the CPU goes to the plain version (``ref.wkv6_ref``, which
upcasts first); a CUDA tensor launches a kernel or raises. ``wkv6.launches``
counts kernel launches. No backward kernel exists yet (queued): a CUDA
input that requires grad, with grad enabled, raises (``build.refuse_grad``)
rather than return an output that cuts the graph; on the CPU the plain
version stays differentiable.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

MAX_HEAD_DIM = 128
RKV_DTYPES = (torch.float32, torch.bfloat16)


def _check(r, k, v, w, u, s0):
    if r.dim() != 4:
        raise ValueError(f"wkv6 wants r, k, v, w (B,H,S,hd); got r {tuple(r.shape)}")
    B, H, S, hd = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match r {tuple(r.shape)}")
    if u.shape != (H, hd) or s0.shape != (B, H, hd, hd):
        raise ValueError(f"want u ({H}, {hd}) and s0 ({B}, {H}, {hd}, {hd}); got "
                         f"{tuple(u.shape)}, {tuple(s0.shape)}")
    if r.dtype not in RKV_DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError("wkv6 takes r, k, v in one dtype, float32 or bfloat16; got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if any(t.dtype != torch.float32 for t in (w, u, s0)):
        raise TypeError("wkv6 takes w, u and s0 in float32; got "
                        f"{w.dtype}, {u.dtype}, {s0.dtype}")
    if len({t.device for t in (r, k, v, w, u, s0)}) != 1:
        raise ValueError("r, k, v, w, u and s0 must be on one device")


def _launch(r, k, v, w, u, s0):
    B, H, S, hd = r.shape
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"kernel takes 1 <= hd <= {MAX_HEAD_DIM}; got hd={hd}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u), ("s0", s0)):
        if hd > 1 and t.numel() and t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous; "
                             f"strides {t.stride()}")
    y = torch.empty_like(r, dtype=torch.float32)
    sn = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    if B * H == 0:
        return y, sn
    lib = build.load("wkv6")
    err = build.on_device(r.device, lambda stream: lib.wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        s0.data_ptr(), y.data_ptr(), sn.data_ptr(), B, H, S, hd,
        int(r.dtype == torch.bfloat16),
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *w.stride()[:3],
        *y.stride()[:3], u.stride(0), *s0.stride()[:3], stream))
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")
    wkv6.launches += 1
    return y, sn


def wkv6(r, k, v, w, u, s0):
    """r, k, v: (B, H, S, hd) fp32 or bf16; w: (B, H, S, hd) fp32; u: (H, hd);
    s0: (B, H, hd, hd). Returns (y (B, H, S, hd), s_n (B, H, hd, hd)), fp32."""
    _check(r, k, v, w, u, s0)
    if r.device.type == "cpu":
        return ref.wkv6_ref(r, k, v, w, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 runs on cpu or cuda, not {r.device}")
    build.refuse_grad("wkv6", "a wkv6 backward kernel is queued in ROADMAP Queue 1",
                      r, k, v, w, u, s0)
    return _launch(r, k, v, w, u, s0)


wkv6.launches = 0
