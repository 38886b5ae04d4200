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
* ``S == 0`` or ``S >= 2``: ``wkv6_kernel`` cuts each head's state into
  the same 8-column slices, one block of 64 threads each (256 blocks at
  (1,32,S,64), where one block a head would leave most of the 132 SMs
  idle); a thread keeps 4 columns of hd/32 rows in registers for the whole
  sequence, so one shared read of a row's ``r, k, w`` feeds 4 columns. The
  chunk's ``r, k, w`` rows and the slice's ``v`` (16 steps, 8 at hd 128)
  arrive a chunk ahead by ``cp.async`` into a two-slot ring in shared
  memory when the views are aligned (element by element otherwise), and
  ``y`` is summed over the 32 row groups once a chunk. Each state element
  updates by one ``fmaf`` as in the step kernel, so ``s_n`` and the
  checkpoints do not depend on the layout; its time beside the bound is in
  ``PERF.md``. ``fwd_plan`` gives the kernels a call launches (one) and its
  scratch (none), from the C side.

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
upcasts first, and whose autograd is its gradient); a CUDA tensor launches
a kernel or raises. ``wkv6.launches`` counts kernel launches of either
forward entry.

The gradient on the card. Where grad is enabled and an input requires it,
``wkv6`` runs through ``Wkv6Fn``, whose forward is ``wkv6_train``, the C
entry ``wkv6_train_launch``: the same kernels with a template flag that also
writes the state before every ``ref.WKV6_EVERY``-th step (16:
(B,H,⌈S/16⌉,hd,hd) fp32, 134 MB at rwkv6-1.6b's (1,32,4096,64), and under
remat only one layer's are live in the backward); its y and s_n are the
serving entry's bit for bit. Its backward is ``wkv6_bwd``, the C entry of
``csrc/wkv6_bwd.cu``, a gradient the reference takes by autodiff of its
scans (``repro/models/rwkv6.py::wkv_scan``): each (b, h) is cut into
slices of 16 rows (8 at the 128-wide kernel), one block each (128 blocks at
rwkv6-1.6b's shape), which never wait for each
other; a block walks the chunks from the last, recomputes its rows of each
chunk's 16 states from the checkpoint into registers and sweeps back
through them with its rows of the state's gradient G in registers, fp32 on
the CUDA cores (TF32 would miss the 1e-4 tolerance), while helper warps
load the next chunk, take the per-step scalars and write the last chunk
out. dr, dk, dw are whole in a block; dv leaves each as a partial sum in a
scratch (B·H·P·S·hd fp32), and a second launch adds the partials in order
(``bwd_plan`` gives the launches a call and the scratch, from the C side,
which owns the layout). dr, dk, dv come back in r's
dtype, rounded once, in the inputs' layouts. It is bound by the CUDA
cores' fp32 rate and the bytes alike (0.11 ms at the training shape); its
time is in ``PERF.md``. ``wkv6_bwd.launches`` counts its calls.
Everywhere else, the serving engine's ``inference_mode`` included, the call
is the serving launch, which saves nothing.
"""
from __future__ import annotations

import ctypes

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


def _strides(*tensors):
    """The (batch, head, step) strides of each (B,H,S,hd) tensor, in order."""
    return [x for t in tensors for x in t.stride()[:3]]


def _check_layout(**tensors):
    hd = next(iter(tensors.values())).shape[-1]
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"kernel takes 1 <= hd <= {MAX_HEAD_DIM}; got hd={hd}")
    for name, t in tensors.items():
        if hd > 1 and t.numel() and t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous; "
                             f"strides {t.stride()}")


def _launch(r, k, v, w, u, s0, train=False):
    """The serving entry's (y, s_n), or with ``train`` the training entry's
    (y, s_n, ckpt)."""
    B, H, S, hd = r.shape
    _check_layout(r=r, k=k, v=v, w=w, u=u, s0=s0)
    y = torch.empty_like(r, dtype=torch.float32)
    sn = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    ckpt = torch.empty((B, H, -(-S // ref.WKV6_EVERY), hd, hd), dtype=torch.float32,
                       device=r.device) if train else None
    if B * H == 0:
        return (y, sn, ckpt) if train else (y, sn)
    lib = build.load("wkv6")
    entry = lib.wkv6_train_launch if train else lib.wkv6_launch
    extra = (ckpt.data_ptr(), ref.WKV6_EVERY) if train else ()
    err = build.on_device(r.device, lambda stream: entry(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        s0.data_ptr(), y.data_ptr(), sn.data_ptr(), *extra, B, H, S, hd,
        int(r.dtype == torch.bfloat16), *_strides(r, k, v, w, y), u.stride(0),
        *s0.stride()[:3], stream))
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")
    wkv6.launches += 1
    return (y, sn, ckpt) if train else (y, sn)


def fwd_plan(B: int, H: int, S: int, hd: int):
    """(device kernels, fp32 scratch) of one call of either forward entry at
    (B, H, S, hd), as ``csrc/wkv6.cu`` plans them (``wkv6_fwd_plan``): one
    kernel, ``wkv6_step_kernel`` at S = 1 and ``wkv6_kernel`` otherwise, and
    no scratch. Builds the library: on the card only."""
    n = ctypes.c_longlong()
    kernels = build.load("wkv6").wkv6_fwd_plan(B, H, S, hd, ctypes.addressof(n))
    if kernels < 0:
        raise ValueError(f"the wkv6 kernel takes no (B, H, S, hd) = {(B, H, S, hd)}")
    return kernels, n.value


def bwd_plan(B: int, H: int, S: int, hd: int):
    """(device kernels, fp32 scratch) of one backward call at (B, H, S, hd),
    as ``csrc/wkv6_bwd.cu`` plans them (``wkv6_bwd_plan``; its blocks a
    head are the source's): the sweep and, at S > 0, the sum of dv's
    partials, which the scratch holds. Builds the library: on the card
    only."""
    n = ctypes.c_longlong()
    kernels = build.load("wkv6_bwd").wkv6_bwd_plan(B, H, S, hd, ctypes.addressof(n))
    if kernels < 0:
        raise ValueError(f"the wkv6 backward kernel takes no (B, H, S, hd) = {(B, H, S, hd)}")
    return kernels, n.value


def _launch_bwd(r, k, v, w, u, ckpt, dy, ds_n):
    B, H, S, hd = r.shape
    every = ref.WKV6_EVERY
    if ckpt.shape != (B, H, -(-S // every), hd, hd) or ckpt.dtype != torch.float32 \
            or not ckpt.is_contiguous():
        raise ValueError("wkv6_bwd takes the training entry's checkpoints, (B,H,ceil(S/"
                         f"{every}),hd,hd) fp32 contiguous; got {ckpt.dtype} "
                         f"{tuple(ckpt.shape)}")
    if dy.shape != r.shape or dy.dtype != torch.float32:
        raise ValueError(f"dy {dy.dtype} {tuple(dy.shape)}: want fp32 {tuple(r.shape)}")
    if ds_n is not None and (ds_n.shape != (B, H, hd, hd) or ds_n.dtype != torch.float32):
        raise ValueError(f"ds_n {ds_n.dtype} {tuple(ds_n.shape)}: want fp32 "
                         f"{(B, H, hd, hd)}")
    if hd > 1 and dy.numel() and dy.stride(-1) != 1:    # an expanded or sliced gradient
        dy = dy.contiguous()
    ds_n = None if ds_n is None else ds_n.contiguous()
    _check_layout(r=r, k=k, v=v, w=w, u=u)
    dr, dk, dv, dw = (torch.empty_like(t) for t in (r, k, v, w))
    du = torch.empty((B, H, hd), dtype=torch.float32, device=r.device)
    ds0 = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    if B * H == 0:
        return dr, dk, dv, dw, du.sum(0), ds0
    # dv's partial sums, one per block of rows
    dvp = torch.empty(bwd_plan(B, H, S, hd)[1], dtype=torch.float32, device=r.device)
    lib = build.load("wkv6_bwd")
    err = build.on_device(r.device, lambda stream: lib.wkv6_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        ckpt.data_ptr(), dy.data_ptr(), None if ds_n is None else ds_n.data_ptr(),
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
        ds0.data_ptr(), dvp.data_ptr(), dvp.numel(), every, B, H, S, hd,
        int(r.dtype == torch.bfloat16),
        *_strides(r, k, v, w, dy, dr, dk, dv, dw), u.stride(0), stream))
    if err != 0:
        raise RuntimeError(f"wkv6_bwd kernel launch failed: CUDA error {err}")
    wkv6_bwd.launches += 1
    # the per-(b, h) partials of du, summed over b in one fixed order (at
    # B = 1, the training batch, no sum and no launch)
    return dr, dk, dv, dw, du[0] if B == 1 else du.sum(0), ds0


class Wkv6Fn(torch.autograd.Function):
    """The kernel with its gradient: the training entry's launch, and
    ``wkv6_bwd`` on its checkpoints for the backward. CUDA tensors only."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        y, sn, ckpt = _launch(r, k, v, w, u, s0, train=True)
        ctx.save_for_backward(r, k, v, w, u, ckpt)
        ctx.set_materialize_grads(False)
        return y, sn

    @staticmethod
    def backward(ctx, dy, ds_n):
        r, k, v, w, u, ckpt = ctx.saved_tensors
        if dy is None:                   # only s_n reached the loss
            dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        return _launch_bwd(r, k, v, w, u, ckpt, dy, ds_n)


def _device(r, name):
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {r.device}")
    return r.device.type


def wkv6(r, k, v, w, u, s0):
    """r, k, v: (B, H, S, hd) fp32 or bf16; w: (B, H, S, hd) fp32; u: (H, hd);
    s0: (B, H, hd, hd). Returns (y (B, H, S, hd), s_n (B, H, hd, hd)), fp32."""
    _check(r, k, v, w, u, s0)
    if _device(r, "wkv6") == "cpu":
        return ref.wkv6_ref(r, k, v, w, u, s0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w, u, s0)):
        return Wkv6Fn.apply(r, k, v, w, u, s0)
    return _launch(r, k, v, w, u, s0)


wkv6.launches = 0


def wkv6_train(r, k, v, w, u, s0):
    """``wkv6``'s (y, s_n) and the checkpoints ckpt (B, H, ⌈S/16⌉, hd, hd)
    fp32, the state before every ``ref.WKV6_EVERY``-th (16th) step
    (``ref.wkv6_train_ref`` on the CPU; on the card the training entry,
    counted in ``wkv6.launches``). No autograd: ``wkv6`` is the
    differentiable call."""
    _check(r, k, v, w, u, s0)
    if _device(r, "wkv6_train") == "cpu":
        return ref.wkv6_train_ref(r, k, v, w, u, s0, ref.WKV6_EVERY)
    return _launch(r, k, v, w, u, s0, train=True)


def wkv6_bwd(r, k, v, w, u, s0, ckpt, dy, ds_n=None):
    """The gradients (dr, dk, dv, dw, du, ds0) of ``wkv6`` at (r, k, v, w,
    u, s0), from ``wkv6_train``'s checkpoints ``ckpt``, for the output
    gradients dy (B,H,S,hd) fp32 and ds_n (B,H,hd,hd) fp32 (``None``: zero).
    dr, dk, dv in r's dtype and layout, dw in w's; du (H,hd), ds0
    (B,H,hd,hd), fp32. On the CPU the plain version
    (``ref.wkv6_bwd_ref``); a CUDA tensor launches the kernel or raises."""
    _check(r, k, v, w, u, s0)
    if _device(r, "wkv6_bwd") == "cpu":
        return ref.wkv6_bwd_ref(r, k, v, w, u, s0, ckpt, dy, ds_n, ref.WKV6_EVERY)
    return _launch_bwd(r, k, v, w, u, ckpt, dy, ds_n)


wkv6_bwd.launches = 0
