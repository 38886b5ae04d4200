"""The fp32 flash forward's split-TF32 route, emulated on the CPU.

``csrc/flash_attention.cu`` runs fp32 through ``flash_tf32_split_kernel``
(q, k and v split once a call) and ``flash_tf32_kernel``: ``mma.sync``
m16n8k8 on TF32 operands with fp32 accumulation. Neither runs here, so this
file replays their arithmetic in plain PyTorch, with the backward's
emulation's rounding (``tests/test_torch_flash_bwd_tf32.py``: big =
tf32(x) and small = tf32(x - big), TF32 rounding by an ``int32`` view,
three products a k-step of 8, every 32 of a product's shared dimension
summed from zero and then added in fp32). S = Q K^T sums hd's columns 32 at
a time (computed here for all keys at once: the tiles do not enter S); then
the online softmax walks the 32-key tiles in ascending order in fp32, in
base 2 as the backward exponentiates: the running max m of s sl2 (sl2 = hd
** -0.5 log2 e; -1e30 outside a row's band), alpha = 2^(m - m_new), p =
2^(s sl2 - m_new) by one FMA, l = l alpha + rowsum(p), O = O alpha + P V
with the tile's 32 keys from zero; then O / max(l, 1e-20) and lse = m +
log2 l, in double and rounded once. A block visits its
tiles from the first one its rows' bands reach (every tile where a row's
band is empty); an extra tile changes a row by exactly nothing, so the
emulation walks every tile. The emulation is held within
``cases.TOL[fp32]`` against the attention in float64 and against
``ref.flash_attention_lse_ref`` (the plain version the card's kernel is
held to) at hd 80, 128, 192 and 256, on G = 10 with a window, G = 1 (the
100M twin's layout) and rows whose band is empty; one TF32 product a
k-step instead misses that tolerance. The kernel itself is held on the
card (tests/test_torch_gpu.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

from repro_torch.kernels import cases, ref
from test_torch_flash_bwd_tf32 import CASES, TILE, product


def tf32_fwd_emulated(q, k, v, off, causal, win, splits=True):
    """The split-TF32 kernel's output and lse (fp32)."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, Sq, hd)
    s = product(torch.zeros(B, KV, G, Sq, Sk), qg, k[:, :, None].transpose(-1, -2), splits)
    sl2 = np.float32(hd ** -0.5) * np.float32(ref.LOG2E)     # the backward's, in fp32
    mask = ref.flash_mask(Sq, Sk, off, causal, win)
    neg = torch.tensor(ref.NEG_INF, dtype=torch.float32)
    y = torch.where(mask, s * sl2, neg)                    # the max is of s sl2 in fp32
    m = torch.full((B, KV, G, Sq, 1), ref.NEG_INF)
    l = torch.zeros(B, KV, G, Sq, 1)
    o = torch.zeros(B, KV, G, Sq, hd)
    for kt in range(0, Sk, TILE):
        ks = slice(kt, kt + TILE)
        mn = torch.maximum(m, y[..., ks].amax(-1, keepdim=True))
        alpha = torch.exp2(m - mn)
        # 2^(s sl2 - m) by one FMA: the product and difference in double,
        # rounded once; a masked key weighs 1 while the row's max is -1e30
        fma = (s[..., ks].double() * float(sl2) - mn.double()).float()
        p = torch.where(mask[:, ks], torch.exp2(fma), (mn == neg).float())
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + product(torch.zeros_like(o), p, v[:, :, None, ks], splits)
        m = mn
    out = o / torch.clamp(l, min=1e-20)
    lse = torch.where(m == neg, neg * np.float32(ref.LOG2E),
                      (m.double() + torch.log2(l.double())).float())
    return out.reshape(B, H, Sq, hd), lse.reshape(B, H, Sq)


def attention_f64(q, k, v, off, causal, win):
    """The masked softmax attention and its lse (base 2) in float64 (an
    empty-band row weighs every key 1/Sk, as the reference's finite mask
    value gives it)."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qg = q.double().reshape(B, KV, H // KV, Sq, hd)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.double()) * hd ** -0.5
    s = torch.where(ref.flash_mask(Sq, Sk, off, causal, win), s,
                    torch.full_like(s, ref.NEG_INF))
    o = torch.einsum("bkgqs,bksd->bkgqd", torch.softmax(s, dim=-1), v.double())
    return o.reshape(B, H, Sq, hd), (torch.logsumexp(s, -1) * ref.LOG2E).reshape(B, H, Sq)


def _run(shape, hd, splits=True):
    B, H, KV, Sq, Sk, off, win, causal = shape
    case = (B, H, KV, Sq, Sk, hd, off, win, causal)
    q, k, v = cases.flash_inputs(case, torch.float32, "cpu")
    got = tf32_fwd_emulated(q, k, v, off, causal, win, splits)
    plain = ref.flash_attention_lse_ref(q, k, v, q_offset=off, causal=causal, window=win)
    return case, got, attention_f64(q, k, v, off, causal, win), plain


@pytest.mark.parametrize("hd", [80, 128, 192, 256])
@pytest.mark.parametrize("shape", CASES)
def test_split_tf32_forward_holds_the_fp32_tolerance(shape, hd):
    """The split-TF32 kernel's products, tiles and softmax, emulated,
    within TOL[fp32] of the float64 attention and of the plain version, in
    the output and the lse."""
    case, got, exact, plain = _run(shape, hd)
    for n, a, w64, w in zip(("output", "lse"), got, exact, plain):
        assert bool(torch.isfinite(a).all())
        cases.held(f"emulated split-tf32 {n} vs float64", case, a, w64.float())
        cases.held(f"emulated split-tf32 {n} vs plain", case, a, w)


@pytest.mark.parametrize("hd", [80, 256])
def test_one_tf32_product_misses_the_fp32_tolerance(hd):
    """The route's reason: one product of TF32-rounded operands a k-step
    instead of three misses TOL[fp32] against the float64 attention."""
    case, (out, _), (exact, _), _ = _run(CASES[0], hd, splits=False)
    with pytest.raises(AssertionError, match="max \\|err\\|"):
        cases.held("one tf32 product output vs float64", case, out, exact.float())
