"""RG-LRU linear recurrence: wrappers of ``csrc/rglru_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/rglru.py`` (``rglru_scan`` /
``_rglru_kernel``): per (batch, channel), ``h_t = a_t * h_{t-1} + b_t`` from
``h0``, every ``h_t`` returned as ``y`` and the last as ``h_S``.

``rglru_scan`` (the sequence) is bound on the H100 by bytes,
``4·(3·B·S·D + 2·B·D)`` at 3.35 TB/s: 23 µs at a 2,560-token prefill
(1,2560,2560), 75 µs at the training shape (1,8192,2560). It is a chunked
two-pass scan, one thread a channel, blocks of 128 channels over (d-block,
chunk of 128 steps, batch), coalesced along D: ``rglru_fwd_carry_kernel``
scans each chunk but the last from a zero state and writes its last state
and the product of its a's (a scratch of 2·B·K·D fp32), then
``rglru_fwd_kernel`` folds ``h0`` through the earlier chunks' pairs into
each chunk's first state and walks the chunk's steps, each product and sum
rounded as the plain version rounds them (``scan_plan`` gives the launches
a call and the scratch, from the C side, which owns the chunk length). At
S <= 128 the second pass runs alone and the result is the plain version's
bit for bit; past one chunk the folded states round otherwise: it holds
``RGLRU_TOL``, and two calls give the same bits. Times in ``PERF.md``.

``rglru_step`` (the decode step, ``rglru_step_kernel``) takes the step's
whole elementwise chain in one launch, from the two fp32 GEMV outputs to
``y`` and ``h'`` (``ref.rglru_step_ref``), as XLA fuses it around the
reference's step on the TPU: at (1,2560) its bytes take 0.025 µs, far below
a launch's fixed cost, so the gain is the ~15 PyTorch launches it replaces.
Its host work per call is the checks (no device sync), ``y`` and ``h'``,
and the launch; the device guard is entered only when the tensors are not
on the current device.

``a``, ``b`` and ``h0`` go by strides with the channel dimension contiguous,
so the model's tensors (the coefficients, the cache's ``h`` rows) are read
in place; ``y`` is allocated in ``a``'s memory layout
(``torch.empty_like``), ``h_S`` contiguous. fp32 only, as the reference's
signature says; any ``D`` (no block size has to divide it), any ``S >= 0``
(at ``S = 0``, ``y`` is empty and ``h_S`` equals ``h0``), ``B`` up to 65,535.

A tensor on the CPU goes to the plain version (``ref.rglru_scan_ref``,
``ref.rglru_step_ref``), whose autograd is its gradient; a CUDA tensor
launches the kernel or raises. ``rglru_scan.launches`` and
``rglru_step.launches`` count calls that launch (a scan call launches
``scan_plan``'s one or two kernels; the profiler's device windows count
kernels).

The scan's gradient on the card. Where grad is enabled and an input
requires it, ``rglru_scan`` runs through ``RglruScanFn``: the same launch,
saving ``a``, ``h0`` and the output ``y``; its backward is
``rglru_scan_bwd`` (a gradient the reference takes by autodiff of its
``associative_scan``): per channel a reverse scan from ``g_{S-1} = dy_{S-1}
+ dh_S`` with ``g_t = dy_t + a_{t+1} g_{t+1}``, giving ``db_t = g_t``,
``da_t = g_t y_{t-1}`` and ``dh0 = a_0 g_0``, in the scan's layout, bound by
bytes, ``4·(5·B·S·D + 3·B·D)`` at 3.35 TB/s (0.125 ms at the training shape
(1,8192,2560)). The sequence is cut into chunks of 128 steps:
``rglru_bwd_carry_kernel`` writes each chunk's carry from a zero carry and
the product of its a's (a scratch of 2·B·K·D fp32), and ``rglru_bwd_kernel``
folds dh_S through the later chunks' pairs into each chunk's carry and
walks the chunk's steps with it (``bwd_plan`` gives the launches a call and
the scratch, from the C side, which owns the chunk length). The composed carries round differently from one long
chain: the result holds ``RGLRU_TOL`` against the plain version, not its
bits, and two calls give the same bits. ``rglru_scan_bwd.launches`` counts
its calls. The decode step has no backward: decoding does not train, and a
CUDA input of ``rglru_step`` that requires grad, with grad enabled, raises
(``build.refuse_grad``) rather than return an output that cuts the graph.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

MAX_BATCH = 65535          # the grid's batch dimension (z of the scans, y of the step)


def scan_plan(B: int, S: int, D: int):
    """(device kernels, fp32 scratch) of one scan call at (B, S, D), as
    ``csrc/rglru_scan.cu`` plans them (``rglru_scan_plan``; its chunk length
    is the source's): the carry pass and the steps' pass, or the steps' pass
    alone for one chunk. Builds the library: on the card only."""
    n = ctypes.c_longlong()
    kernels = build.load("rglru_scan").rglru_scan_plan(B, S, D, ctypes.addressof(n))
    if kernels < 0:
        raise ValueError(f"the rglru scan kernel takes no (B, S, D) = {(B, S, D)}")
    return kernels, n.value


def bwd_plan(B: int, S: int, D: int):
    """(device kernels, fp32 scratch) of one backward call at (B, S, D), as
    ``csrc/rglru_scan.cu`` plans them (``rglru_scan_bwd_plan``; its chunk
    length is the source's): the carry pass and the steps' pass, or the
    steps' pass alone for one chunk. Builds the library: on the card only."""
    n = ctypes.c_longlong()
    kernels = build.load("rglru_scan").rglru_scan_bwd_plan(B, S, D, ctypes.addressof(n))
    if kernels < 0:
        raise ValueError(f"the rglru backward kernel takes no (B, S, D) = {(B, S, D)}")
    return kernels, n.value


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
    # each chunk's (L, M): its last state from a zero state, and the product
    # of its a's (none at one chunk)
    _, floats = scan_plan(B, S, D)
    lm = torch.empty(floats, dtype=torch.float32, device=a.device) if floats else None
    lib = build.load("rglru_scan")
    err = build.on_device(a.device, lambda stream: lib.rglru_scan_launch(
        a.data_ptr(), b.data_ptr(), h0.data_ptr(), y.data_ptr(), hn.data_ptr(),
        None if lm is None else lm.data_ptr(), B, S, D, *a.stride()[:2],
        *b.stride()[:2], *y.stride()[:2], h0.stride(0), stream))
    if err != 0:
        raise RuntimeError(f"rglru kernel launch failed: CUDA error {err}")
    rglru_scan.launches += 1
    return y, hn


def _launch_bwd(a, h0, y, dy, dh_S):
    B, S, D = a.shape
    if y.shape != a.shape or dy.shape != a.shape or h0.shape != (B, D) or (
            dh_S is not None and dh_S.shape != (B, D)):
        raise ValueError(f"rglru_scan_bwd wants y, dy {tuple(a.shape)} and h0, dh_S "
                         f"{(B, D)}; got {tuple(y.shape)}, {tuple(dy.shape)}, "
                         f"{tuple(h0.shape)}, {None if dh_S is None else tuple(dh_S.shape)}")
    tensors = [t for t in (a, h0, y, dy, dh_S) if t is not None]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("rglru_scan_bwd takes float32 only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("a, h0, y, dy and dh_S must be on one device")
    if B > MAX_BATCH:
        raise ValueError(f"kernel takes B <= {MAX_BATCH}; got B={B}")
    if D > 1 and dy.numel() and dy.stride(-1) != 1:   # an expanded or sliced gradient
        dy = dy.contiguous()
    dh_S = None if dh_S is None else dh_S.contiguous()
    for name, t in (("a", a), ("h0", h0), ("y", y)):
        if D > 1 and t.numel() and t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous; "
                             f"strides {t.stride()}")
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty((B, D), dtype=torch.float32, device=a.device)
    if B * D == 0:
        return da, db, dh0
    # each chunk's (L, M): the carry it sends down from a zero carry, and the
    # product of its a's (none at one chunk)
    _, floats = bwd_plan(B, S, D)
    lm = torch.empty(floats, dtype=torch.float32, device=a.device) if floats else None
    lib = build.load("rglru_scan")
    err = build.on_device(a.device, lambda stream: lib.rglru_scan_bwd_launch(
        a.data_ptr(), h0.data_ptr(), y.data_ptr(), dy.data_ptr(),
        None if dh_S is None else dh_S.data_ptr(), da.data_ptr(), db.data_ptr(),
        dh0.data_ptr(), None if lm is None else lm.data_ptr(), B, S, D,
        *a.stride()[:2], *y.stride()[:2], *dy.stride()[:2], *da.stride()[:2],
        *db.stride()[:2], h0.stride(0), stream))
    if err != 0:
        raise RuntimeError(f"rglru backward kernel launch failed: CUDA error {err}")
    rglru_scan_bwd.launches += 1
    return da, db, dh0


class RglruScanFn(torch.autograd.Function):
    """The scan with its gradient: the scan's launch, saving ``a``, ``h0``
    and the output ``y``, and ``rglru_scan_bwd`` for the backward. CUDA
    tensors only."""

    @staticmethod
    def forward(ctx, a, b, h0):
        y, hn = _launch(a, b, h0)
        ctx.save_for_backward(a, h0, y)
        ctx.set_materialize_grads(False)
        return y, hn

    @staticmethod
    def backward(ctx, dy, dh_S):
        a, h0, y = ctx.saved_tensors
        if dy is None:                   # only h_S reached the loss
            dy = torch.zeros_like(y)
        return _launch_bwd(a, h0, y, dy, dh_S)


def rglru_scan(a, b, h0):
    """a, b: (B, S, D) fp32 decay and input; h0: (B, D) fp32.
    Returns (y (B, S, D), h_S (B, D))."""
    _check(a, b, h0)
    if a.device.type == "cpu":
        return ref.rglru_scan_ref(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cpu or cuda, not {a.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (a, b, h0)):
        return RglruScanFn.apply(a, b, h0)
    return _launch(a, b, h0)


rglru_scan.launches = 0


def rglru_scan_bwd(a, h0, y, dy, dh_S=None):
    """The gradients (da, db, dh0) of ``rglru_scan`` at (a, b, h0), whose
    output is ``y`` (B,S,D), for the output gradients ``dy`` (B,S,D) and
    ``dh_S`` (B,D) (``None``: zero), fp32; da and db in a's layout. On the
    CPU the plain version (``ref.rglru_scan_bwd_ref``); a CUDA tensor
    launches the kernel or raises."""
    if a.device.type == "cpu":
        return ref.rglru_scan_bwd_ref(a, h0, y, dy, dh_S)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan_bwd runs on cpu or cuda, not {a.device}")
    return _launch_bwd(a, h0, y, dy, dh_S)


rglru_scan_bwd.launches = 0


def _check_step(gx_a, gx_x, ba, bx, lam, x, h):
    if x.dim() != 2:
        raise ValueError(f"rglru_step wants x (B,D); got {tuple(x.shape)}")
    D = x.shape[1]
    for name, t in (("gx_a", gx_a), ("gx_x", gx_x), ("h", h)):
        if t.shape != x.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match x {tuple(x.shape)}")
    for name, t in (("ba", ba), ("bx", bx), ("lam", lam)):
        if t.shape != (D,):
            raise ValueError(f"want {name} ({D},); got {tuple(t.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rglru_step takes x in float32 or bfloat16; got {x.dtype}")
    if any(t.dtype != torch.float32 for t in (gx_a, gx_x, ba, bx, lam, h)):
        raise TypeError("rglru_step takes gx_a, gx_x, ba, bx, lam and h in float32")
    dev = x.device
    if any(t.device != dev for t in (gx_a, gx_x, ba, bx, lam, h)):
        raise ValueError("gx_a, gx_x, ba, bx, lam, x and h must be on one device")


def _launch_step(gx_a, gx_x, ba, bx, lam, x, h):
    B, D = x.shape
    if B > MAX_BATCH:
        raise ValueError(f"kernel takes B <= {MAX_BATCH}; got B={B}")
    if D > 1 and any(t.stride(-1) != 1 for t in (gx_a, gx_x, ba, bx, lam, x, h)):
        raise ValueError("rglru_step's channel dimensions must be contiguous")
    y = torch.empty((B, D), dtype=x.dtype, device=x.device)
    hn = torch.empty((B, D), dtype=torch.float32, device=x.device)
    if B * D == 0:
        return y, hn
    lib = build.load("rglru_scan")
    err = build.on_device(x.device, lambda stream: lib.rglru_step_launch(
        gx_a.data_ptr(), gx_x.data_ptr(), ba.data_ptr(), bx.data_ptr(), lam.data_ptr(),
        x.data_ptr(), h.data_ptr(), y.data_ptr(), hn.data_ptr(), B, D,
        int(x.dtype == torch.bfloat16), gx_a.stride(0), gx_x.stride(0), x.stride(0),
        h.stride(0), stream))
    if err != 0:
        raise RuntimeError(f"rglru step kernel launch failed: CUDA error {err}")
    rglru_step.launches += 1
    return y, hn


def rglru_step(gx_a, gx_x, ba, bx, lam, x, h):
    """One RG-LRU decode step. gx_a, gx_x: (B, D) fp32 products x·wa and
    x·wx; ba, bx, lam: (D,) fp32; x: (B, D) fp32 or bf16; h: (B, D) fp32.
    Returns (y (B, D) in x's dtype, h' (B, D) fp32)."""
    _check_step(gx_a, gx_x, ba, bx, lam, x, h)
    if x.device.type == "cpu":
        return ref.rglru_step_ref(gx_a, gx_x, ba, bx, lam, x, h)
    if x.device.type != "cuda":
        raise ValueError(f"rglru_step runs on cpu or cuda, not {x.device}")
    build.refuse_grad("rglru_step", "decoding does not train; the RG-LRU trains through "
                      "rglru_scan, whose backward is rglru_scan_bwd", gx_a, gx_x, ba, bx,
                      lam, x, h)
    return _launch_step(gx_a, gx_x, ba, bx, lam, x, h)


rglru_step.launches = 0
