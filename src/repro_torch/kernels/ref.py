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
The wrappers run these for CPU tensors; ``chip_smoke.py`` holds the CUDA
kernels against them on the card.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30
RG_C = 8.0          # the RG-LRU's decay scale, repro/models/griffin.py


def flash_attention_ref(q, k, v, *, q_offset: int = 0, causal: bool = True,
                        window: Optional[int] = None):
    """q: (B,H,Sq,hd); k,v: (B,KV,Sk,hd) -> (B,H,Sq,hd)."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, Sq, hd).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * hd ** -0.5
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(B, H, Sq, hd).to(q.dtype)


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
