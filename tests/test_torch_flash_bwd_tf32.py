"""The fp32 flash backward's split-TF32 route, emulated on the CPU.

``csrc/flash_attention_bwd.cu`` runs fp32 through ``flash_bwd_dq_tf32_kernel``
and ``flash_bwd_dkdv_tf32_kernel``: ``mma.sync`` m16n8k8 on TF32 operands with
fp32 accumulation. Neither runs here, so this file replays their arithmetic
in plain PyTorch: every operand of every product (the recomputed S = Q K^T
and dP = dO V^T included) is split into big = tf32(x) and small = tf32(x -
big), TF32 being x rounded to nearest with ties away from zero (an ``int32``
view: add 0x1000, clear the low 13 bits, as ``cvt.rna.tf32.f32``), and each
k-step of 8 is three products, big·small and small·big, then big·big, added
to an fp32 sum; every 32 of a product's shared dimension (32 columns of hd
in S and dP, a tile's 32 keys or rows in the gradients) are summed from zero
(on the tensor cores) and then added to the running sum (on the CUDA cores,
round to nearest). dQ is summed over 32-key tiles in ascending order; dK and
dV, for each dK/dV block of ``bwd_tf32_blocks``'s keys, over the 32-row
Q/dO tiles from the first row whose band reaches the block, the farthest
tile first and head by head within it; P
and dS in fp32; an empty-band row's dO / Sk added to every key's dV at the
end; dK and dQ times hd ** -0.5 once. The emulation is held within
``cases.TOL[fp32]`` against the gradient of the attention in float64 and
against ``ref.flash_attention_bwd_ref`` (the plain version the card's
kernels are held to) at hd 80, 128, 192 and 256, on G = 10 with a window,
G = 1 (the 100M twin's layout) and rows whose band is empty; one TF32
product a k-step instead misses that tolerance. The kernels themselves are
held on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

from repro_torch.kernels import cases, ref
from repro_torch.kernels.flash_attention import bwd_route, bwd_tf32_blocks

TILE = 32        # keys a K/V tile (dq kernel), rows a Q/dO tile (dk/dv kernel)
KSTEP = 8        # the k of one mma.sync m16n8k8
CHUNK = 32       # the k-steps summed from zero on the tensor cores: 32 of hd, a tile


def tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    big = tf32(x)
    return big, tf32(x - big)


def product(acc, a, b, splits=True):
    """acc + a @ b over the shared dimension: each CHUNK of it summed from
    zero in k-steps of KSTEP with fp32 sums, big·small, small·big, then
    big·big per step (``splits``; else one product of the TF32-rounded
    operands), then added to acc."""
    for c in range(0, a.shape[-1], CHUNK):
        part = torch.zeros_like(acc)
        for j in range(c, min(c + CHUNK, a.shape[-1]), KSTEP):
            x, y = a[..., j:j + KSTEP], b[..., j:j + KSTEP, :]
            if splits:
                (xb, xs), (yb, ys) = split(x), split(y)
                part = part + xb @ ys
                part = part + xs @ yb
                part = part + xb @ yb
            else:
                part = part + tf32(x) @ tf32(y)
        acc = acc + part
    return acc


def tf32_bwd_emulated(q, k, v, out, lse, dout, off, causal, win, splits=True):
    """The split-TF32 kernels' dq, dk, dv (fp32)."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    scale = np.float32(hd ** -0.5)
    sl2 = np.float32(hd ** -0.5 * ref.LOG2E)
    mask = ref.flash_mask(Sq, Sk, off, causal, win)
    live = mask.any(dim=-1)
    D = (dout * out).sum(-1)                                     # (B, H, Sq)
    L = torch.where(live, lse, torch.full_like(lse, np.inf))     # +inf: P = 0
    dq = torch.zeros(B, H, Sq, hd)
    dk = torch.zeros(B, KV, Sk, hd)
    dv = torch.zeros(B, KV, Sk, hd)
    _, keys = bwd_tf32_blocks(B, H, KV, Sq, Sk, hd)
    for kvh in range(KV):
        hs = slice(kvh * G, (kvh + 1) * G)
        kf, vf = k[:, kvh, None], v[:, kvh, None]
        # dq kernel: every 32-key tile in ascending order
        for kt in range(0, Sk, TILE):
            ks = slice(kt, min(kt + TILE, Sk))
            z = torch.zeros(B, G, Sq, ks.stop - kt)
            s = product(z, q[:, hs], kf[:, :, ks].transpose(-1, -2), splits)
            dp = product(z, dout[:, hs], vf[:, :, ks].transpose(-1, -2), splits)
            p = torch.exp2(s * sl2 - L[:, hs, :, None])
            p = torch.where(mask[:, ks], p, torch.zeros_like(p))
            ds = p * (dp - D[:, hs, :, None])
            dq[:, hs] = product(dq[:, hs], ds, kf[:, :, ks], splits)
        # dk/dv kernel: blocks of `keys` keys over the 32-row tiles from the
        # first row whose band reaches the block, the farthest tile first,
        # head by head within it
        for k0 in range(0, Sk, keys):
            kb = slice(k0, min(k0 + keys, Sk))
            klast = kb.stop - 1
            ibeg = min(max(k0 - off, 0), Sq) if causal else 0
            iend = min(max(klast + win - off, 0), Sq) if win is not None else Sq
            for it in reversed(range(ibeg, iend, TILE)):
                for g in range(G):
                    h = kvh * G + g
                    rs = slice(it, min(it + TILE, Sq))
                    z = torch.zeros(B, kb.stop - k0, rs.stop - it)
                    st = product(z, k[:, kvh, kb], q[:, h, rs].transpose(-1, -2), splits)
                    dpt = product(z, v[:, kvh, kb], dout[:, h, rs].transpose(-1, -2), splits)
                    pt = torch.exp2(st * sl2 - L[:, h, None, rs])
                    pt = torch.where(mask[rs, kb].T, pt, torch.zeros_like(pt))
                    dst = pt * (dpt - D[:, h, None, rs])
                    dv[:, kvh, kb] = product(dv[:, kvh, kb], pt, dout[:, h, rs], splits)
                    dk[:, kvh, kb] = product(dk[:, kvh, kb], dst, q[:, h, rs], splits)
        # empty-band rows: their dO over the group, in order, / Sk, to every
        # key's dV
        e = torch.zeros(B, hd)
        for g in range(G):
            for r in torch.nonzero(~live).flatten().tolist():
                e = e + dout[:, kvh * G + g, r]
        dv[:, kvh] = dv[:, kvh] + e[:, None, :] * np.float32(1.0 / Sk)
    return dq * scale, dk * scale, dv


def attention_grads_f64(q, k, v, dout, off, causal, win):
    """dq, dk, dv of the masked softmax attention in float64 by autograd,
    on the same values (an empty-band row weighs every key 1/Sk, as the
    reference's finite mask value gives it)."""
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
    (1, 10, 1, 96, 160, 64, 48, True),     # G = 10: Sk ragged past 32-key tiles, the window binds
    (2, 4, 4, 70, 70, 0, None, True),      # G = 1, the 100M twin's layout; rows past two tiles
    (1, 10, 1, 40, 100, 100, 20, True),    # rows from position 119 see no key
]


def _run(shape, hd, splits=True):
    B, H, KV, Sq, Sk, off, win, causal = shape
    case = (B, H, KV, Sq, Sk, hd, off, win, causal)
    q, k, v, dout = cases.flash_bwd_inputs(case, torch.float32, "cpu")
    kw = dict(q_offset=off, window=win, causal=causal)
    out, lse = ref.flash_attention_lse_ref(q, k, v, **kw)
    got = tf32_bwd_emulated(q, k, v, out, lse, dout, off, causal, win, splits)
    return case, got, attention_grads_f64(q, k, v, dout, off, causal, win), \
        ref.flash_attention_bwd_ref(q, k, v, dout, **kw)


@pytest.mark.parametrize("hd", [80, 128, 192, 256])
@pytest.mark.parametrize("shape", CASES)
def test_split_tf32_route_holds_the_fp32_tolerance(shape, hd):
    """The split-TF32 kernels' products and tile order, emulated, within
    TOL[fp32] of the float64 gradient and of the plain version."""
    assert bwd_route(torch.float32, hd) == "tensor cores, split tf32"
    case, got, exact, plain = _run(shape, hd)
    for n, a, w64, w in zip("qkv", got, exact, plain):
        assert bool(torch.isfinite(a).all())
        cases.held(f"emulated split-tf32 d{n} vs float64", case, a, w64.float())
        cases.held(f"emulated split-tf32 d{n} vs plain", case, a, w)


@pytest.mark.parametrize("hd", [80, 256])
def test_one_tf32_product_misses_the_fp32_tolerance(hd):
    """The route's reason: one product of TF32-rounded operands a k-step
    instead of three misses TOL[fp32] against the float64 gradient."""
    case, got, exact, _ = _run(CASES[0], hd, splits=False)
    with pytest.raises(AssertionError, match="max \\|err\\|"):
        for n, a, w64 in zip("qkv", got, exact):
            cases.held(f"one tf32 product d{n} vs float64", case, a, w64.float())
