"""Plain PyTorch versions of the kernels (kernel layouts).

Twins of ``repro.kernels.ref.flash_attention_ref``,
``decode_attention_ref``, ``rglru_scan_ref`` and ``wkv6_ref``: same layouts, fp32 internals,
the finite mask value ``NEG_INF`` so that a fully masked row gives a
uniform softmax rather than NaN. ``rglru_step_ref`` is the RG-LRU decode
step of ``repro/models/griffin.py`` (``_rglru_coeffs`` after its two
products, then ``a * h + b``), the function the fused step kernel computes.
``flash_attention_bwd_ref`` is the gradient of ``flash_attention_ref`` by
autograd, the plain version of the flash backward kernel (the reference
takes the same gradient by autodiff of its jnp attention).
``flash_attention_lse_ref`` is the training forward's plain version: the
same output and each row's logsumexp in the kernels' base-2 units;
``flash_attention_bwd_lse_ref`` is the closed form the backward kernels
compute from that lse.
The wrappers run these for CPU tensors; ``chip_smoke.py`` holds the CUDA
kernels against them on the card.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30
LOG2E = 1.4426950408889634
RG_C = 8.0          # the RG-LRU's decay scale, repro/models/griffin.py


def flash_mask(Sq: int, Sk: int, q_offset: int, causal: bool, window: Optional[int],
               device=None):
    """(Sq, Sk) bool: the keys each query row sees (causal and window band)."""
    qpos = q_offset + torch.arange(Sq, device=device)
    kpos = torch.arange(Sk, device=device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def _masked_scores(q, k, q_offset, causal, window):
    """fp32 scores (B,KV,G,Sq,Sk) times hd ** -0.5, NEG_INF off the band."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, Sq, hd).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * hd ** -0.5
    mask = flash_mask(Sq, Sk, q_offset, causal, window, q.device)
    return torch.where(mask, s, torch.full_like(s, NEG_INF))


def flash_attention_ref(q, k, v, *, q_offset: int = 0, causal: bool = True,
                        window: Optional[int] = None):
    """q: (B,H,Sq,hd); k,v: (B,KV,Sk,hd) -> (B,H,Sq,hd)."""
    B, H, Sq, hd = q.shape
    p = torch.softmax(_masked_scores(q, k, q_offset, causal, window), dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(B, H, Sq, hd).to(q.dtype)


def flash_attention_lse_ref(q, k, v, *, q_offset: int = 0, causal: bool = True,
                            window: Optional[int] = None):
    """(``flash_attention_ref``'s output, lse (B,H,Sq) fp32): each row's
    logsumexp of its masked scores in base 2, ``log2 sum_j 2^(s_j log2 e)``
    = the natural logsumexp times log2 e, the units in which the kernels
    exponentiate. A row whose band is empty scores NEG_INF on every key, so
    its lse is NEG_INF log2 e (log Sk is lost in fp32)."""
    B, H, Sq, hd = q.shape
    lse = torch.logsumexp(_masked_scores(q, k, q_offset, causal, window), dim=-1) * LOG2E
    out = flash_attention_ref(q, k, v, q_offset=q_offset, causal=causal, window=window)
    return out, lse.reshape(B, H, Sq)


def flash_attention_bwd_lse_ref(q, k, v, out, lse, dout, *, q_offset: int = 0,
                                causal: bool = True, window: Optional[int] = None):
    """The closed form of the gradients (dq, dk, dv) that the backward
    kernels compute from the forward's output and lse, in fp32, returned in
    the inputs' dtype: P = 2^(s log2 e - lse) on the band (0 off it), D =
    rowsum(dO * O), dV = P^T dO, dS = P (dO V^T - D), dQ = scale dS K, dK =
    scale dS^T Q; a row whose band is empty adds dO / Sk to every key's dV
    and nothing to dQ and dK."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G, scale = H // KV, hd ** -0.5
    shape5 = (B, KV, G, Sq)
    qg, og, gg = (t.reshape(*shape5, hd).float() for t in (q, out, dout))
    kf, vf = k.float(), v.float()
    mask = flash_mask(Sq, Sk, q_offset, causal, window, q.device)
    live = mask.any(dim=-1)                                   # (Sq,)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, kf) * scale
    p = torch.where(mask & live[:, None], torch.exp2(s * LOG2E - lse.reshape(*shape5, 1)),
                    torch.zeros_like(s))
    D = (gg * og).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bkgqd,bksd->bkgqs", gg, vf) - D)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qg) * scale
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, gg)
    dv = dv + (gg * (~live)[:, None].float()).sum(dim=(2, 3))[:, :, None] / Sk
    return dq.reshape(B, H, Sq, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_ref(q, k, v, dout, *, q_offset: int = 0, causal: bool = True,
                            window: Optional[int] = None):
    """The gradients (dq, dk, dv) of ``flash_attention_ref`` at (q, k, v)
    for the output gradient ``dout`` (B,H,Sq,hd), in the inputs' layouts and
    dtype: ``torch.autograd.grad`` of the plain forward."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_ref(*leaves, q_offset=q_offset, causal=causal,
                                  window=window)
        return tuple(torch.autograd.grad(out, leaves, dout))


def decode_attention_ref(q, k_cache, v_cache, valid):
    """q: (B,H,hd); caches: (B,KV,W,hd); valid: (W,) -> (B,H,hd)."""
    B, H, hd = q.shape
    KV, W = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgd,bkwd->bkgw", qg, k_cache.float()) * hd ** -0.5
    s = torch.where(valid > 0, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgw,bkwd->bkgd", p, v_cache.float())
    return o.reshape(B, H, hd).to(q.dtype)


def rglru_scan_ref(a, b, h0):
    """a, b: (B,S,D); h0: (B,D) -> (y (B,S,D), h_S (B,D)), one step at a
    time: ``h_t = a_t * h_{t-1} + b_t``, ``y_t = h_t``. At S = 0, y is empty
    and h_S is a copy of h0."""
    h = h0
    ys = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        ys.append(h)
    y = torch.stack(ys, dim=1) if ys else a.new_empty(a.shape)
    return y, (h0.clone() if not ys else h)


def rglru_step_ref(gx_a, gx_x, ba, bx, lam, x, h):
    """One RG-LRU step from the two fp32 products ``gx_a = x @ wa`` and
    ``gx_x = x @ wx`` (B,D); ba, bx, lam (D,) fp32; x (B,D) in the model's
    dtype; h (B,D) fp32. Returns (y in x's dtype, h' fp32):

        r = σ(gx_a + ba), i = σ(gx_x + bx), log_a = -8·softplus(λ)·r,
        a = exp(log_a), b = sqrt(max(1 - exp(2·log_a), 1e-12))·i·x,
        h' = a·h + b.
    """
    x32 = x.float()
    r = torch.sigmoid(gx_a + ba)
    i = torch.sigmoid(gx_x + bx)
    log_a = -RG_C * F.softplus(lam) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * i * x32
    h = a * h.float() + b
    return h.to(x.dtype), h


def wkv6_ref(r, k, v, w, u, s0):
    """RWKV6 recurrence, one token at a time. r,k,v: (B,H,S,hd) fp32 or
    bf16, upcast first; w: (B,H,S,hd) fp32; u: (H,hd); s0: (B,H,hd,hd).
    Returns (y (B,H,S,hd), s_n (B,H,hd,hd)), fp32:

        y_t     = (S_t + u ⊙ (k_t ⊗ v_t))ᵀ r_t
        S_{t+1} = diag(w_t) S_t + k_t ⊗ v_t
    """
    r, k, v = r.float(), k.float(), v.float()
    B, H, S, hd = r.shape
    s = s0
    ys = []
    for t in range(S):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]          # (B,H,hd,hd)
        eff = s + u[None, :, :, None] * kv
        ys.append(torch.einsum("bhij,bhi->bhj", eff, r[:, :, t]))
        s = s * w[:, :, t, :, None] + kv
    y = torch.stack(ys, dim=2) if ys else r.new_empty((B, H, 0, hd))
    return y, (s0.clone() if S == 0 else s)
