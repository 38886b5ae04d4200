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
compute from that lse. ``wkv6_train_ref`` is the wkv6 training entry's
plain version (``wkv6_ref``'s output and the state before every
``every``-th step), ``wkv6_bwd_ref`` and ``rglru_scan_bwd_ref`` the closed
forms of the gradients that the two recurrent backward kernels compute
(the reference takes both by autodiff of its scans).
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
# steps between two checkpoints of the wkv6 state that the training entry
# writes and the backward recomputes from: at rwkv6-1.6b's (1,32,4096,64)
# 256 checkpoints of 64x64 fp32 per head, 134 MB, live for one layer's
# backward under remat
WKV6_EVERY = 16


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
    y = torch.stack(ys, dim=1) if ys else a[:, :0].clone()   # empty, in the graph
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
    y = torch.stack(ys, dim=2) if ys else r[:, :, :0].clone()   # empty, in the graph
    return y, (s0.clone() if S == 0 else s)


def rglru_scan_bwd_ref(a, h0, y, dy, dh_S=None):
    """The gradients (da, db, dh0) of ``rglru_scan_ref`` at (a, b, h0), whose
    output is ``y`` (B,S,D), for the output gradients ``dy`` (B,S,D) and
    ``dh_S`` (B,D) (``None``: zero), all fp32. A reverse scan from ``g_{S-1} =
    dy_{S-1} + dh_S`` with ``g_t = dy_t + a_{t+1} g_{t+1}``: ``db_t = g_t``,
    ``da_t = g_t y_{t-1}`` (``y_{-1} = h0``), ``dh0 = a_0 g_0``. At S = 0, da
    and db are empty and dh0 is dh_S."""
    S = a.shape[1]
    carry = torch.zeros_like(h0) if dh_S is None else dh_S.clone()
    da, db = torch.empty_like(a), torch.empty_like(a)
    for t in range(S - 1, -1, -1):
        g = dy[:, t] + carry
        db[:, t] = g
        da[:, t] = g * (y[:, t - 1] if t else h0)
        carry = a[:, t] * g
    return da, db, carry


def wkv6_train_ref(r, k, v, w, u, s0, every: int):
    """``wkv6_ref``'s (y, s_n) and the state before every ``every``-th step,
    ckpt (B,H,⌈S/every⌉,hd,hd) fp32: ``ckpt[:, :, c]`` is S_{c·every}, the
    state the backward recomputes chunk ``c``'s steps from."""
    B, H, S, hd = r.shape
    ckpt = s0.new_empty((B, H, -(-S // every), hd, hd))
    s = s0
    ys = []
    for c in range(ckpt.shape[2]):
        ckpt[:, :, c] = s
        sl = slice(c * every, min(S, (c + 1) * every))
        y, s = wkv6_ref(r[:, :, sl], k[:, :, sl], v[:, :, sl], w[:, :, sl], u, s)
        ys.append(y)
    y = torch.cat(ys, dim=2) if ys else r.new_empty((B, H, 0, hd), dtype=torch.float32)
    return y, (s0.clone() if S == 0 else s), ckpt


def wkv6_bwd_ref(r, k, v, w, u, s0, ckpt, dy, ds_n=None, every: int = WKV6_EVERY):
    """The gradients (dr, dk, dv, dw, du, ds0) of ``wkv6_ref`` at (r, k, v,
    w, u, s0), from the training entry's checkpoints ``ckpt`` (S_{c·every},
    ``wkv6_train_ref`` with the same ``every``), for the output gradients ``dy`` (B,H,S,hd) and
    ``ds_n`` (B,H,hd,hd; ``None``: zero): the closed form that the backward
    kernel computes. Each chunk's states are recomputed from its checkpoint
    (never backwards as ``(S_{t+1} - k_t v_tᵀ) / w_t``: w comes arbitrarily
    close to 0); then from ``G_S = ds_n``, for t = S-1 down to 0:

        dr_t[i] = Σ_j (S_t[i,j] + u_i k_t[i] v_t[j]) dy_t[j]
        dk_t[i] = Σ_j (G_{t+1}[i,j] + u_i r_t[i] dy_t[j]) v_t[j]
        dv_t[j] = Σ_i (G_{t+1}[i,j] + u_i r_t[i] dy_t[j]) k_t[i]
        dw_t[i] = Σ_j S_t[i,j] G_{t+1}[i,j]
        du[i]  += Σ_b r_t[i] k_t[i] (v_t · dy_t)
        G_t     = diag(w_t) G_{t+1} + r_t ⊗ dy_t

    and ``ds0 = G_0``. Computed in float64 (the oracle's own rounding stays
    far below the kernel's fp32 tolerance at thousands of steps), returned
    with dr, dk, dv in r's dtype and dw, du, ds0 in fp32."""
    B, H, S, hd = r.shape
    f = torch.float64
    r64, k64, v64, w64, dy64 = (t.to(f) for t in (r, k, v, w, dy))
    u64 = u.to(f)[None, :, :, None]
    G = torch.zeros((B, H, hd, hd), dtype=f, device=r.device) if ds_n is None \
        else ds_n.to(f)
    dr, dk, dv, dw = (torch.empty((B, H, S, hd), dtype=f, device=r.device)
                      for _ in range(4))
    du = torch.zeros((B, H, hd), dtype=f, device=r.device)
    for c in range(ckpt.shape[2] - 1, -1, -1):
        t0, t1 = c * every, min(S, (c + 1) * every)
        states = [ckpt[:, :, c].to(f)]
        for t in range(t0, t1 - 1):
            kv = k64[:, :, t, :, None] * v64[:, :, t, None, :]
            states.append(states[-1] * w64[:, :, t, :, None] + kv)
        for t in range(t1 - 1, t0 - 1, -1):
            st = states[t - t0]
            rt, kt, vt, wt, gt = (x[:, :, t] for x in (r64, k64, v64, w64, dy64))
            vdy = (vt * gt).sum(-1, keepdim=True)                    # (B,H,1)
            urk = (u64[..., 0] * rt * kt).sum(-1, keepdim=True)      # (B,H,1)
            dr[:, :, t] = torch.einsum("bhij,bhj->bhi", st, gt) + u64[..., 0] * kt * vdy
            dk[:, :, t] = torch.einsum("bhij,bhj->bhi", G, vt) + u64[..., 0] * rt * vdy
            dv[:, :, t] = torch.einsum("bhij,bhi->bhj", G, kt) + urk * gt
            dw[:, :, t] = (st * G).sum(-1)
            du += rt * kt * vdy
            G = G * wt[..., None] + rt[..., None] * gt[..., None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.float(),
            du.sum(0).float(), G.float())
