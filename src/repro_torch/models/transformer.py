"""Dense-family transformer: port of the dense branch of
``repro/models/transformer.py``.

Public API (plain functions over a dict of parameters):
    init_params(generator, cfg, dtype)                      -> params
    forward(params, cfg, batch)                             -> logits
    init_cache(cfg, batch, max_len, dtype, device)          -> cache
    prefill(params, cfg, batch, max_len, ...)               -> (logits, cache)
    decode_step(params, cfg, cache, tokens, pos)            -> (logits, cache)

Parameters keep the reference's pytree layout: per-layer weights stacked on
a leading ``L`` axis, projections applied as ``x @ w``, so weights converted
from the JAX package (``repro_torch.convert``) compute the same function.
The reference's ``lax.scan`` over the stack is a Python loop over ``L``.

Two differences of idiom: ``decode_step`` writes the new K/V into the cache
tensors in place (JAX returns new arrays), and ``ring_kpos`` uses
``torch.remainder``, whose sign follows the divisor as ``jnp.mod`` does (C's
``%`` and ``torch.fmod`` follow the dividend and would give wrong slots).

Not ported yet: the long-context window mode (the reference's
``long_context`` flag) and families other than dense, which raise
``NotImplementedError`` (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (apply_rope, attention, decode_attend,
                                       mlp, rmsnorm)

Params = Dict[str, Any]

def _require_dense(cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            "(ROADMAP.md Queue 1)")


# --------------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------------- #

def attn_window(cfg: ModelConfig) -> Optional[int]:
    """Effective sliding window for dense self-attention."""
    return cfg.window_size


def cache_width(cfg: ModelConfig, max_len: int) -> int:
    w = attn_window(cfg)
    return min(max_len, w) if w else max_len


def ring_kpos(width: int, pos: int, device=None):
    """Absolute position held by each ring-buffer slot at decode step `pos`.
    slot i holds p = pos - ((pos - i) mod width); p < 0 -> empty.

    ``torch.remainder`` takes the sign of the divisor, as ``jnp.mod`` does;
    C's ``%`` (and ``torch.fmod``) take the dividend's and would put the
    slots ahead of ``pos`` at positive positions."""
    i = torch.arange(width, device=device)
    return pos - torch.remainder(pos - i, width)


def layer_params(stacked, i: int):
    """Layer ``i`` of parameters stacked on a leading L axis (views)."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


# --------------------------------------------------------------------------- #
# attention layer
# --------------------------------------------------------------------------- #

def _qkv(p, cfg: ModelConfig, x):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, KV, hd)
    v = (x @ p["wv"]).reshape(B, S, KV, hd)
    return q, k, v


def _rope_qk(cfg: ModelConfig, q, k, positions):
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _attn_layer_fwd(p, cfg: ModelConfig, x, *, window, q_offset=0,
                    prefix_kv=None, return_kv=False):
    """Residual attention sub-block + FFN sub-block (full sequence)."""
    B, S, _ = x.shape
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    q, k, v = _qkv(p["attn"], cfg, h)
    positions = q_offset + torch.arange(S, device=x.device)
    q, k = _rope_qk(cfg, q, k, positions)
    if prefix_kv is not None:                      # cached-context prefill
        k = torch.cat([prefix_kv[0], k], dim=1)
        v = torch.cat([prefix_kv[1], v], dim=1)
    o = attention(q, k, v, q_offset=q_offset, window=window)
    x = x + o.reshape(B, S, -1) @ p["attn"]["wo"]
    x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    if return_kv:
        return x, (k, v)
    return x


def _attn_layer_decode(p, cfg: ModelConfig, x_t, k_cache, v_cache, pos: int, *,
                       window):
    """x_t: (B,1,d); caches: (B,W,KV,hd), written in place at slot pos % W."""
    B = x_t.shape[0]
    W = k_cache.shape[1]
    h = rmsnorm(p["ln1"], x_t, cfg.norm_eps)
    q, k, v = _qkv(p["attn"], cfg, h)
    pos_arr = torch.full((1,), pos, device=x_t.device)
    q, k = _rope_qk(cfg, q, k, pos_arr)
    slot = pos % W
    k_cache[:, slot] = k[:, 0]
    v_cache[:, slot] = v[:, 0]
    kpos = ring_kpos(W, pos, x_t.device)
    o = decode_attend(q, k_cache, v_cache, kpos, pos, window=window)
    x_t = x_t + o.reshape(B, 1, -1) @ p["attn"]["wo"]
    return x_t + mlp(p["mlp"], rmsnorm(p["ln2"], x_t, cfg.norm_eps), cfg)


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #

def _normal(generator, shape, scale: float, dtype):
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (x * scale).to(dtype)


def _stacked_dense(generator, L: int, d_in: int, d_out: int, dtype,
                   scale: Optional[float] = None):
    """L layers of ``dense_init`` weights, drawn one layer at a time so the
    fp32 draw never holds more than one layer."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.empty((L, d_in, d_out), dtype=dtype, device=generator.device)
    for i in range(L):
        w[i] = _normal(generator, (d_in, d_out), scale, dtype)
    return w


def init_params(generator: torch.Generator, cfg: ModelConfig,
                dtype=torch.bfloat16) -> Params:
    """Random weights with the reference's shapes and scales, drawn from
    ``generator`` on ``generator.device``. The draws differ from
    ``jax.random``; to compare with the JAX package, convert its weights
    with ``repro_torch.convert.params_from_jax`` instead."""
    _require_dense(cfg)
    dev = generator.device
    V, d, L = cfg.padded_vocab, cfg.d_model, cfg.num_layers
    H, KV, hd, dff = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    p: Params = {
        "embed": _normal(generator, (V, d), 0.02, dtype),
        "final_ln": {"scale": ones(d)},
        "unembed": _normal(generator, (d, V), 1.0 / math.sqrt(d), dtype),
    }
    layers = {
        "ln1": {"scale": ones(L, d)},
        "attn": {
            "wq": _stacked_dense(generator, L, d, H * hd, dtype),
            "wk": _stacked_dense(generator, L, d, KV * hd, dtype),
            "wv": _stacked_dense(generator, L, d, KV * hd, dtype),
            "wo": _stacked_dense(generator, L, H * hd, d, dtype,
                                 scale=1.0 / math.sqrt(H * hd)),
        },
        "ln2": {"scale": ones(L, d)},
        "mlp": {
            "w_up": _stacked_dense(generator, L, d, dff, dtype),
            "w_down": _stacked_dense(generator, L, dff, d, dtype),
        },
    }
    if cfg.gated_mlp:
        layers["mlp"]["w_gate"] = _stacked_dense(generator, L, d, dff, dtype)
    p["layers"] = layers
    return p


# --------------------------------------------------------------------------- #
# full-sequence forward
# --------------------------------------------------------------------------- #

def forward(params: Params, cfg: ModelConfig, batch):
    """Full-sequence logits (B, S, padded_vocab)."""
    _require_dense(cfg)
    x = params["embed"][batch["tokens"]]
    window = attn_window(cfg)
    for i in range(cfg.num_layers):
        x = _attn_layer_fwd(layer_params(params["layers"], i), cfg, x,
                            window=window)
    x = rmsnorm(params["final_ln"], x, cfg.norm_eps)
    return x @ params["unembed"]


# --------------------------------------------------------------------------- #
# cache init / prefill / decode
# --------------------------------------------------------------------------- #

def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
    _require_dense(cfg)
    W = cache_width(cfg, max_len)
    shape = (cfg.num_layers, batch_size, W, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _place_kv_in_ring(k_full, W: int):
    """k_full: (B, S, KV, hd) -> ring cache (B, W, KV, hd) holding the last
    min(S, W) tokens at slots pos % W."""
    B, S = k_full.shape[:2]
    out = torch.zeros((B, W) + tuple(k_full.shape[2:]), dtype=k_full.dtype,
                      device=k_full.device)
    if S <= W:
        out[:, :S] = k_full
        return out
    ps = torch.arange(S - W, S, device=k_full.device) % W
    out[:, ps] = k_full[:, S - W:]
    return out


def prefill(params: Params, cfg: ModelConfig, batch, max_len: int, *,
            prefix_cache=None, prefix_len: int = 0):
    """Process a prompt, returning (logits, cache) ready for decode.

    prefix_cache/prefix_len: reuse a stored KV prefix (the paper's cache-hit
    path) — new tokens attend to prefix keys with q_offset = prefix_len.
    ``prefix_cache`` needs ``[:, :, :prefix_len]`` to hold positions
    ``0..prefix_len-1`` in order (a ring that has not wrapped).
    """
    _require_dense(cfg)
    x = params["embed"][batch["tokens"]]
    B = x.shape[0]
    window = attn_window(cfg)
    W = cache_width(cfg, max_len)
    cache = init_cache(cfg, B, max_len, x.dtype, device=x.device)
    for i in range(cfg.num_layers):
        prefix_kv = None
        if prefix_cache is not None:
            prefix_kv = (prefix_cache["k"][i, :, :prefix_len],
                         prefix_cache["v"][i, :, :prefix_len])
        x, (k, v) = _attn_layer_fwd(
            layer_params(params["layers"], i), cfg, x, window=window,
            q_offset=prefix_len, prefix_kv=prefix_kv, return_kv=True)
        cache["k"][i] = _place_kv_in_ring(k, W)
        cache["v"][i] = _place_kv_in_ring(v, W)
    x = rmsnorm(params["final_ln"], x, cfg.norm_eps)
    return x @ params["unembed"], cache


def decode_step(params: Params, cfg: ModelConfig, cache, tokens, pos: int):
    """One autoregressive step. tokens: (B,1) int64; pos: the absolute
    position being written. Returns (logits (B,1,V), cache); the cache's
    tensors are updated in place."""
    _require_dense(cfg)
    pos = int(pos)
    x = params["embed"][tokens]
    window = attn_window(cfg)
    for i in range(cfg.num_layers):
        x = _attn_layer_decode(layer_params(params["layers"], i), cfg, x,
                               cache["k"][i], cache["v"][i], pos, window=window)
    x = rmsnorm(params["final_ln"], x, cfg.norm_eps)
    return x @ params["unembed"], cache
