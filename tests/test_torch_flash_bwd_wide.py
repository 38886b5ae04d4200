"""The bf16 flash backward's wide tensor-core route (hd 129-256), emulated
on the CPU.

``csrc/flash_attention_bwd.cu`` runs bf16 at 128 < hd <= 256 through
``flash_bwd_dq_wide_kernel`` and ``flash_bwd_dkdv_wide_kernel``. Neither
runs here, so this file replays their arithmetic in plain PyTorch: bf16
inputs; S and dP in fp32; P = 2^(S scale log2 e - lse) and dS = P (dP - D)
in fp32, each rounded to bf16 before the product that takes it; dQ summed
over 64-key tiles in ascending order, dK and dV over the 64-row Q/dO tiles
of each 64-key block (head by head, from the first row whose band reaches
the block), each tile in k-steps of 16 with fp32 sums; an empty-band row's
dO / Sk added to every key's dV at the end; each gradient rounded to bf16
once. The emulation is held within ``cases.TOL[bf16]`` against the
gradient of the attention in float64 and against ``ref.flash_attention_bwd_ref``
(the plain version the card's kernels are held to), on small MQA cases with
G = 10 and a window at hd 136, 192 and 256. The kernels themselves are held
on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""
import math

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

from repro_torch.kernels import cases, ref
from repro_torch.kernels.flash_attention import bwd_keys, bwd_route

TILE = 64        # keys a K/V tile and a dK/dV block; rows a Q/dO tile
KSTEP = 16       # the rows or keys of one wgmma k-step


def _band(Sq, Sk, off, causal, win):
    """(Sq, Sk) bool: the keys each row sees; and each row's liveness."""
    mask = ref.flash_mask(Sq, Sk, off, causal, win)
    return mask, mask.any(dim=-1)


def _tiled(acc, a, b):
    """acc += a @ b over the shared dimension in k-steps of KSTEP, fp32."""
    for j in range(0, a.shape[-1], KSTEP):
        acc = acc + a[..., j:j + KSTEP] @ b[..., j:j + KSTEP, :]
    return acc


def _bf16(x):
    return x.to(torch.bfloat16).float()


def wide_bwd_emulated(q, k, v, out, lse, dout, off, causal, win):
    """The wide kernels' dq, dk, dv (bf16) for one batch entry's MQA group
    laid out as the kernels see it."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    sl2 = np.float32(scale * ref.LOG2E)
    mask, live = _band(Sq, Sk, off, causal, win)
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, out, dout))
    D = (gf * of).sum(-1)                                       # (B, H, Sq)
    L = torch.where(live, lse, torch.full_like(lse, math.inf))  # +inf: P = 0
    dq = torch.zeros(B, H, Sq, hd)
    dk = torch.zeros(B, KV, Sk, hd)
    dv = torch.zeros(B, KV, Sk, hd)
    for kvh in range(KV):
        hs = slice(kvh * G, (kvh + 1) * G)
        # dQ kernel: every 64-key tile in ascending order
        for kt in range(0, Sk, TILE):
            ks = slice(kt, min(kt + TILE, Sk))
            s = qf[:, hs] @ kf[:, kvh, ks].transpose(-1, -2)[:, None]
            dp = gf[:, hs] @ vf[:, kvh, ks].transpose(-1, -2)[:, None]
            p = torch.exp2(s * sl2 - L[:, hs, :, None])
            p = torch.where(mask[:, ks], p, torch.zeros_like(p))
            ds = _bf16(p * (dp - D[:, hs, :, None]))
            dq[:, hs] = _tiled(dq[:, hs], ds, kf[:, kvh, ks][:, None])
        # dK/dV kernel: 64-key blocks over the heads' 64-row tiles of the
        # rows whose band reaches them
        for k0 in range(0, Sk, TILE):
            ks = slice(k0, min(k0 + TILE, Sk))
            klast = ks.stop - 1
            ibeg = min(max(k0 - off, 0), Sq) if causal else 0
            iend = min(max(klast + win - off, 0), Sq) if win is not None else Sq
            for g in range(G):
                h = kvh * G + g
                for it in range(ibeg, iend, TILE):
                    rs = slice(it, min(it + TILE, Sq))
                    st = kf[:, kvh, ks] @ qf[:, h, rs].transpose(-1, -2)
                    dpt = vf[:, kvh, ks] @ gf[:, h, rs].transpose(-1, -2)
                    pt = torch.exp2(st * sl2 - L[:, h, None, rs])
                    pt = torch.where(mask[rs, ks].T, pt, torch.zeros_like(pt))
                    dst = _bf16(pt * (dpt - D[:, h, None, rs]))
                    dv[:, kvh, ks] = _tiled(dv[:, kvh, ks], _bf16(pt), gf[:, h, rs])
                    dk[:, kvh, ks] = _tiled(dk[:, kvh, ks], dst, qf[:, h, rs])
        # empty-band rows: their dO over the group, / Sk, to every key's dV
        e = gf[:, hs][:, :, ~live].sum(dim=(1, 2))
        dv[:, kvh] = dv[:, kvh] + e[:, None, :] * np.float32(1.0 / Sk)
    return (dq * scale).to(q.dtype), (dk * scale).to(k.dtype), dv.to(v.dtype)


def attention_grads_f64(q, k, v, dout, off, causal, win):
    """dq, dk, dv of the masked softmax attention in float64 by autograd,
    on the same bf16 values (an empty-band row weighs every key 1/Sk, as
    the reference's finite mask value gives it)."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    leaves = [t.double().requires_grad_(True) for t in (q, k, v)]
    qg = leaves[0].reshape(B, KV, H // KV, Sq, hd)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, leaves[1]) * hd ** -0.5
    mask = ref.flash_mask(Sq, Sk, off, causal, win)
    s = torch.where(mask, s, torch.full_like(s, ref.NEG_INF))
    o = torch.einsum("bkgqs,bksd->bkgqd", torch.softmax(s, dim=-1), leaves[2])
    return torch.autograd.grad(o.reshape(B, H, Sq, hd), leaves, dout.double())


CASES = [
    (1, 10, 1, 96, 160, 64, 48, True),     # Sk ragged past two tiles, the window binds
    (1, 10, 1, 40, 100, 100, 20, True),    # rows from position 119 see no key
]


@pytest.mark.parametrize("hd", [136, 192, 256])
@pytest.mark.parametrize("shape", CASES)
def test_wide_route_roundings_hold_the_bf16_tolerance(shape, hd):
    """The wide kernels' roundings and tile order, emulated, within
    TOL[bf16] of the float64 gradient and of the plain version."""
    B, H, KV, Sq, Sk, off, win, causal = shape
    case = (B, H, KV, Sq, Sk, hd, off, win, causal)
    assert bwd_route(torch.bfloat16, hd) == "tensor cores" and bwd_keys(causal, win, hd) == 64
    q, k, v, dout = cases.flash_bwd_inputs(case, torch.bfloat16, "cpu")
    kw = dict(q_offset=off, window=win, causal=causal)
    out, lse = ref.flash_attention_lse_ref(q, k, v, **kw)
    got = wide_bwd_emulated(q, k, v, out, lse, dout, off, causal, win)
    exact = attention_grads_f64(q, k, v, dout, off, causal, win)
    plain = ref.flash_attention_bwd_ref(q, k, v, dout, **kw)
    for n, a, w64, w in zip("qkv", got, exact, plain):
        assert bool(torch.isfinite(a.float()).all())
        cases.held(f"emulated wide d{n} vs float64", case, a.float(), w64.float(),
                   cases.TOL[torch.bfloat16])
        cases.held(f"emulated wide d{n} vs plain", case, a, w)
