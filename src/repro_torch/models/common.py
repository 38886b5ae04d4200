"""Shared model components: init helpers, norms (RMS and per-head group
norm), rotary embeddings (Qwen2-VL's M-RoPE too), MLPs, GQA attention
(full sequence and single-token decode against a ring cache).

Port of the functions of ``repro/models/common.py``, with the same
layouts: activations ``(B, S, d)``, heads ``(B, S, H, hd)``, caches
``(B, W, KV, hd)``, weights applied as ``x @ w``. Params are plain dicts of
tensors, as the reference's pytrees are.

Numerics against the reference:

* ``attention`` and ``decode_attend`` call the attention kernels
  (``repro_torch.kernels.ops``), which keep the softmax probabilities in
  fp32 for the P·V product. The reference's jnp path
  (``repro/models/common.py::_attend``, line 183, and ``decode_attend``,
  line 233) casts them to ``v.dtype`` first. In fp32 the two agree to
  rounding (the port is held to 3e-4 on the model); in bf16 they differ by
  design and the port is held to the kernels' bf16 tolerance.
* RoPE frequencies and angles are computed in fp32, as at
  ``common.py:72``, and the rotation is done in fp32 before the cast back.
* ``activation_fn("gelu")`` is the tanh approximation, which is what
  ``jax.nn.gelu`` computes by default.
* ``groupnorm_heads`` takes the population variance (``correction=0``),
  which is what ``jnp.var`` computes; ``torch.var`` defaults to the sample
  variance.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops


# --------------------------------------------------------------------------- #
# init helpers (shapes and scales of the reference's; the draws differ)
# --------------------------------------------------------------------------- #

def normal_init(generator, shape, scale: float, dtype):
    """Normal draw in fp32 on ``generator.device``, times ``scale``."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return x.mul_(scale).to(dtype)        # in place: one fp32 draw at a time


def uniform_init(generator, shape):
    """fp32 draw, uniform in [0, 1), on ``generator.device``."""
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=generator.device)


def dense_init(generator, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return normal_init(generator, (d_in, d_out), scale, dtype)


# --------------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------------- #

def init_rmsnorm(d: int, dtype, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * params["scale"].float()).to(dt)


def init_groupnorm(heads: int, hd: int, dtype, device=None):
    return {"scale": torch.ones((heads, hd), dtype=dtype, device=device),
            "bias": torch.zeros((heads, hd), dtype=dtype, device=device)}


def groupnorm_heads(params, x, eps: float = 64e-5):
    """LayerNorm per head — x: (..., H, hd). Used by RWKV6."""
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    out = out * params["scale"].float() + params["bias"].float()
    return out.to(dt)


# --------------------------------------------------------------------------- #
# rotary embeddings
# --------------------------------------------------------------------------- #

def _rope_freqs(half: int, theta: float, device):
    """(half,) fp32 rotary frequencies ``theta ** (-j / half)``."""
    exps = -torch.arange(half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def _rope_angles(positions, half: int, theta: float):
    """positions: (...,) -> (..., half) fp32 angles."""
    return positions.float()[..., None] * _rope_freqs(half, theta, positions.device)


def _rotate(x1, x2, ang):
    """The rotation of pairs ``(x1, x2)`` by ``ang`` (B, S, half), in fp32."""
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (B, S, H, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    ang = _rope_angles(positions, half, theta)               # (S, half) or (B,S,half)
    if ang.dim() == 2:
        ang = ang[None]                                      # (1, S, half)
    rot = _rotate(x[..., :half], x[..., half:2 * half], ang)
    if 2 * half < hd:                                        # odd head_dim tail
        rot = torch.cat([rot, x[..., 2 * half:].to(rot.dtype)], dim=-1)
    return rot.to(x.dtype)


def mrope_sections(half: int):
    """Split of rotary pair-dims among (temporal, height, width) sections."""
    s1 = half // 4
    s2 = (half - s1) // 2
    return (s1, s2, half - s1 - s2)


def apply_mrope(x, positions, theta: float = 10_000.0):
    """Qwen2-VL multimodal RoPE. x: (B,S,H,hd); positions: (B,S,3) int.

    Rotary pair ``j`` turns by its frequency times the temporal, height or
    width id, the pairs split among the three by ``mrope_sections``. The
    frequencies and the rotation are ``apply_rope``'s, so three equal ids
    give its bits. The split is the reference's ``x[..., :half]`` /
    ``x[..., half:]`` (an odd ``hd`` fails, as there)."""
    half = x.shape[-1] // 2
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=positions.device),
        torch.tensor(mrope_sections(half), device=positions.device))   # (half,)
    ang = positions[..., sec_id].float() * _rope_freqs(half, theta, positions.device)
    return _rotate(x[..., :half], x[..., half:], ang).to(x.dtype)


# --------------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------------- #

def _relu2(x):
    return torch.square(F.relu(x))


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def activation_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return _gelu_tanh
    if name == "relu2":
        return _relu2
    raise ValueError(name)


def mlp(params, x, cfg: ModelConfig):
    act = activation_fn(cfg.activation)
    h = act(x @ params["w_up"])
    if cfg.gated_mlp:
        h = h * (x @ params["w_gate"])
    return h @ params["w_down"]


# --------------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------------- #

def attention(q, k, v, *, q_offset: int = 0, window: Optional[int] = None,
              causal: bool = True):
    """Full-sequence GQA attention through the flash-attention kernel.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd). Returns (B, Sq, H, hd).
    q_offset: absolute position of q[0] (cached-prefix prefill); key j sits
    at position j. The reference chunks long query sequences to bound the
    memory of its score matrix; the kernel never forms that matrix, so the
    port makes one launch.
    """
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), q_offset=q_offset,
                              causal=causal, window=window)
    return out.transpose(1, 2)


def decode_attend(q, k_cache, v_cache, kpos, pos: int, *,
                  window: Optional[int] = None):
    """Single-token decode attention against a (ring or linear) KV cache.

    q: (B, 1, H, hd); caches: (B, W, KV, hd); kpos: (W,) slot -> absolute
    position (negative = empty); pos: current position. The reference's mask
    ``(kpos >= 0) & (kpos <= pos) & window`` becomes the kernel's ``valid``
    vector, and the caches go to the kernel as permuted views, not copies.
    """
    B, _, H, hd = q.shape
    mask = (kpos >= 0) & (kpos <= pos)
    if window is not None:
        mask &= kpos > pos - window
    out = ops.decode_attention(q[:, 0], k_cache.permute(0, 2, 1, 3),
                               v_cache.permute(0, 2, 1, 3),
                               mask.to(torch.int32))
    return out.reshape(B, 1, H, hd)
