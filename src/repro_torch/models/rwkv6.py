"""RWKV6 "Finch" block: time-mix with data-dependent decay + channel-mix.
Port of ``repro/models/rwkv6.py``.

State per layer:
  wkv:   (B, H, hd, hd)  matrix-valued attention state, fp32
  x_tm:  (B, d)          last input to time-mix (token shift)
  x_cm:  (B, d)          last input to channel-mix (token shift)

The WKV recurrence runs in ``ops.wkv6`` (the hand-written CUDA kernel on the
card, its plain version on the CPU) at every sequence length, one token
after another. The reference switches to ``wkv_scan_chunked`` for
``S >= 32``, a reordering of the same sums, so the two models agree at
``S >= 32`` to that function's own tolerance against the scan, not to the
scan's rounding. ``wkv_scan_chunked`` is not ported (ROADMAP.md Queue 2b).
Under autograd (training, ``repro_torch.train.steps``) the same call runs the
kernel's training entry on the card, and its gradient is the wkv6 backward
kernel (``ops.wkv6_bwd``); on the CPU, autograd of the plain version.

Numerics against the reference, where PyTorch would otherwise differ:

* ``mu``, ``decay_base``, ``u``, ``mu_k`` and ``mu_r`` are fp32 whatever the
  model's dtype (``FP32_LEAVES``), as the reference's init makes them.
* In ``_ddlerp``, ``dx * mu`` with fp32 ``mu`` promotes to fp32 in both
  frameworks; the product with the (bf16) ``ts_w1``/``ts_w2`` is fp32 in
  JAX, and ``torch.matmul`` refuses mixed dtypes, so the weight is cast up
  to the activation's dtype, never the activation down.
* The decay ``w = exp(-exp(decay_base + lora))`` is taken in fp32.
* ``r``, ``k`` and ``v`` reach ``ops.wkv6`` in the model's dtype; the
  recurrence upcasts them to fp32 (exact), as the reference's ``astype``
  does before its scan.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import (dense_init, groupnorm_heads,
                                       init_groupnorm, normal_init,
                                       uniform_init)

LORA_R = 32          # low-rank size for data-dependent token-shift mixing
DECAY_LORA_R = 64    # low-rank size for data-dependent decay

_MIX_NAMES = ("r", "k", "v", "w", "g")
FP32_LEAVES = ("mu", "decay_base", "u", "mu_k", "mu_r")


def init_time_mix(generator, cfg: ModelConfig, dtype):
    d = cfg.d_model
    H, hd = cfg.num_rwkv_heads, cfg.rwkv_head_dim
    n = len(_MIX_NAMES)
    return {
        "mu": uniform_init(generator, (n, d)) * 0.5,
        # data-dependent token shift (ddlerp) low-rank
        "ts_w1": dense_init(generator, d, LORA_R * n, dtype, scale=1e-2),
        "ts_w2": normal_init(generator, (n, LORA_R, d), 1e-2, dtype),
        "wr": dense_init(generator, d, d, dtype),
        "wk": dense_init(generator, d, d, dtype),
        "wv": dense_init(generator, d, d, dtype),
        "wg": dense_init(generator, d, d, dtype),
        "wo": dense_init(generator, d, d, dtype),
        # decay: w = exp(-exp(w0 + lora(x)))
        "decay_base": uniform_init(generator, (d,)) * -1.0 - 4.0,
        "decay_w1": dense_init(generator, d, DECAY_LORA_R, dtype, scale=1e-2),
        "decay_w2": dense_init(generator, DECAY_LORA_R, d, dtype, scale=1e-2),
        # per-channel "bonus" for the current token
        "u": uniform_init(generator, (H, hd)) * 0.5,
        "ln_x": init_groupnorm(H, hd, dtype, generator.device),
    }


def init_channel_mix(generator, cfg: ModelConfig, dtype):
    d = cfg.d_model
    return {
        "mu_k": uniform_init(generator, (d,)) * 0.5,
        "mu_r": uniform_init(generator, (d,)) * 0.5,
        "wk": dense_init(generator, d, cfg.d_ff, dtype),
        "wv": dense_init(generator, cfg.d_ff, d, dtype),
        "wr": dense_init(generator, d, d, dtype),
    }


def _ddlerp(p, x, x_prev):
    """Data-dependent token-shift interpolation -> per-target mixed inputs.

    x, x_prev: (B, S, d). Returns dict name -> (B, S, d) in ``x.dtype``.
    """
    dx = x_prev - x
    base = x + dx * p["mu"][0]                              # fp32 (mu is)
    lora = torch.tanh(base @ p["ts_w1"].to(base.dtype))     # (B,S,R*5)
    B, S, _ = x.shape
    lora = lora.reshape(B, S, len(_MIX_NAMES), LORA_R)
    adj = torch.einsum("bsnr,nrd->bsnd", lora, p["ts_w2"].to(lora.dtype))
    out = {}
    for i, name in enumerate(_MIX_NAMES):
        mu = p["mu"][i] + adj[:, :, i]
        out[name] = x + dx * mu.to(x.dtype)
    return out


def _shift(x, x_prev):
    """(B, S, d): the previous token's row for each position."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def time_mix(p, cfg: ModelConfig, x, x_prev, state):
    """x: (B,S,d); x_prev: (B,d) last token of the previous chunk; state:
    the wkv state (B,H,hd,hd) fp32. Returns (out, new_x_prev, new_state)."""
    B, S, d = x.shape
    H, hd = cfg.num_rwkv_heads, cfg.rwkv_head_dim
    mixed = _ddlerp(p, x, _shift(x, x_prev))

    r = (mixed["r"] @ p["wr"]).reshape(B, S, H, hd)
    k = (mixed["k"] @ p["wk"]).reshape(B, S, H, hd)
    v = (mixed["v"] @ p["wv"]).reshape(B, S, H, hd)
    g = F.silu(mixed["g"] @ p["wg"])
    w = torch.exp(-torch.exp(
        p["decay_base"].float()
        + (torch.tanh(mixed["w"] @ p["decay_w1"]) @ p["decay_w2"]).float()))
    w = w.reshape(B, S, H, hd)                              # (0,1), fp32

    # the kernel reads the (B,S,H,hd) activations through (B,H,S,hd) views,
    # r, k and v in the model's dtype (upcast in registers, exactly), and
    # writes fp32 y in r's layout, so y.transpose(1, 2) is (B,S,H,hd) in place
    y, state = ops.wkv6(*(t.transpose(1, 2) for t in (r, k, v, w)), p["u"].float(),
                        state)
    out = groupnorm_heads(p["ln_x"], y.transpose(1, 2)).reshape(B, S, d).to(x.dtype)
    out = (out * g) @ p["wo"]
    return out, x[:, -1], state


def channel_mix(p, x, x_prev):
    dx = _shift(x, x_prev) - x
    xk = x + dx * p["mu_k"].to(x.dtype)
    xr = x + dx * p["mu_r"].to(x.dtype)
    k = torch.square(F.relu(xk @ p["wk"]))
    return torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"]), x[:, -1]
