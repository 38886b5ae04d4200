"""Griffin / RecurrentGemma recurrent block: conv1d + RG-LRU gated linear
recurrence. Port of ``repro/models/griffin.py``.

RG-LRU (Real-Gated Linear Recurrent Unit):
    r_t = sigmoid(W_a x_t + b_a)          recurrence gate
    i_t = sigmoid(W_x x_t + b_x)          input gate
    a_t = exp(-c · softplus(Λ) · r_t)     per-channel decay, c = 8
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

State per layer: ``h`` (B, dr) fp32 and ``conv`` (B, W-1, dr), the last
``W-1`` inputs of the causal conv.

The full-sequence block runs the recurrence in ``ops.rglru_scan`` after
``_rglru_coeffs``; the decode step runs ``ops.rglru_step``, which takes the
coefficients' elementwise chain and ``a * h + b`` in one launch, from the two
fp32 products. Each is a hand-written CUDA kernel on the card and its plain
version on the CPU. The reference's model path runs an ``associative_scan``
with ``h0`` folded into ``b[:, 0]`` and its step computes ``a * h + b``
inline; the scan is the same function as the kernel's sequential loop,
rounded in another order, and the step rounds as the reference's does.
Under autograd (training, ``repro_torch.train.steps``) the scan's gradient
on the card is the backward kernel ``ops.rglru_scan_bwd``; on the CPU,
autograd of the plain version. The step is not trained.

Numerics against the reference, where PyTorch would otherwise differ:

* the gate is ``jax.nn.gelu``, the tanh form (``common._gelu_tanh``);
  ``F.gelu`` defaults to the exact erf form;
* ``ba``, ``bx`` and ``lam`` are fp32 whatever the model's dtype
  (``FP32_LEAVES``), and so is the state ``h``;
* ``_rglru_coeffs`` casts ``x`` and ``wa``/``wx`` to fp32 (JAX promotes
  mixed dtypes, ``torch.matmul`` refuses them);
* the input scale is ``sqrt(max(1 - exp(2·log_a), 1e-12))``, not
  ``sqrt(1 - a²)``;
* ``y`` comes back in ``x``'s dtype, ``h`` stays fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import (_gelu_tanh, dense_init, normal_init,
                                       uniform_init)

RG_C = 8.0
FP32_LEAVES = ("ba", "bx", "lam")


def init_rglru_block(generator, cfg: ModelConfig, dtype):
    d, dr = cfg.d_model, cfg.rnn_width
    dev = generator.device
    return {
        "w_in_y": dense_init(generator, d, dr, dtype),      # recurrent branch in
        "w_in_gate": dense_init(generator, d, dr, dtype),   # gelu gate branch
        "w_out": dense_init(generator, dr, d, dtype),
        "conv_w": normal_init(generator, (cfg.conv_width, dr),
                              cfg.conv_width ** -0.5, dtype),
        "conv_b": torch.zeros((dr,), dtype=dtype, device=dev),
        "wa": dense_init(generator, dr, dr, dtype, scale=1e-2),
        "ba": torch.zeros((dr,), dtype=torch.float32, device=dev),
        "wx": dense_init(generator, dr, dr, dtype, scale=1e-2),
        "bx": torch.zeros((dr,), dtype=torch.float32, device=dev),
        # Λ uniform in [0.0013, 0.1320), so that a ∈ (0.9, 0.999) at r = 1
        "lam": uniform_init(generator, (dr,)) * (0.1320 - 0.0013) + 0.0013,
    }


def _causal_conv(p, x, x_hist):
    """Depthwise causal conv1d, width cfg.conv_width.
    x: (B,S,dr); x_hist: (B, width-1, dr) previous inputs."""
    w = p["conv_w"]                                    # (W, dr)
    W, S = w.shape[0], x.shape[1]
    xfull = torch.cat([x_hist.to(x.dtype), x], dim=1)
    out = sum(xfull[:, i:i + S] * w[i][None, None] for i in range(W))
    new_hist = xfull[:, S:]                            # last W-1 inputs
    return out + p["conv_b"][None, None], new_hist


def _rglru_coeffs(p, x):
    """x: (..., dr) -> decay a and scaled input (both fp32)."""
    x32 = x.float()
    r = torch.sigmoid(x32 @ p["wa"].float() + p["ba"])
    i = torch.sigmoid(x32 @ p["wx"].float() + p["bx"])
    log_a = -RG_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * i * x32
    return a, gated


def rglru_scan(p, x, h0):
    """Full-sequence recurrence. x: (B,S,dr); h0: (B,dr) fp32.
    Returns (y in x's dtype, h_S fp32)."""
    a, b = _rglru_coeffs(p, x)                         # (B,S,dr) fp32
    y, h = ops.rglru_scan(a, b, h0.float())
    return y.to(x.dtype), h


def rglru_step(p, x_t, h):
    """Decode step. x_t: (B,dr); h: (B,dr) fp32. The two products stay
    ``torch.matmul``, as in ``_rglru_coeffs``; the rest of the chain and the
    recurrence are one ``ops.rglru_step``. Returns (y in x_t's dtype, h fp32)."""
    x32 = x_t.float()
    return ops.rglru_step(x32 @ p["wa"].float(), x32 @ p["wx"].float(), p["ba"],
                          p["bx"], p["lam"], x_t, h)


def rglru_block(p, x, state):
    """Full-seq recurrent block. x: (B,S,d);
    state: {"h": (B,dr), "conv": (B,W-1,dr)}."""
    gate = _gelu_tanh(x @ p["w_in_gate"])
    y = x @ p["w_in_y"]
    y, conv_hist = _causal_conv(p, y, state["conv"])
    y, h = rglru_scan(p, y, state["h"])
    out = (y * gate) @ p["w_out"]
    return out, {"h": h, "conv": conv_hist}


def rglru_block_step(p, x_t, state):
    """Decode step. x_t: (B,d)."""
    gate = _gelu_tanh(x_t @ p["w_in_gate"])
    y = x_t @ p["w_in_y"]
    # conv via history buffer
    xfull = torch.cat([state["conv"].to(y.dtype), y[:, None]], dim=1)
    y = torch.einsum("bwd,wd->bd", xfull, p["conv_w"]) + p["conv_b"][None]
    new_hist = xfull[:, 1:]
    y, h = rglru_step(p, y, state["h"])
    out = (y * gate) @ p["w_out"]
    return out, {"h": h, "conv": new_hist}


def init_recurrent_state(cfg: ModelConfig, batch: int, dtype, device=None):
    return {"h": torch.zeros((batch, cfg.rnn_width), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.rnn_width),
                                dtype=dtype, device=device)}
