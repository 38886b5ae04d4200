"""All six families of ``repro/models/transformer.py``: dense, MoE, RWKV6
(``ssm``), Griffin (``hybrid``), Qwen2-VL (``vlm``) and enc-dec
(``encdec``).

Public API (plain functions over a dict of parameters):
    init_params(generator, cfg, dtype)                      -> params
    forward(params, cfg, batch, long_context, remat, return_hidden, with_aux)
                                                            -> logits[, aux]
    init_cache(cfg, batch, max_len, dtype, device, long_context) -> cache
    prefill(params, cfg, batch, max_len, ...)               -> (logits, cache)
    decode_step(params, cfg, cache, tokens, pos, ...)       -> (logits, cache)

``batch`` is a dict: ``tokens`` (B,S) int64, plus family extras, as in the
reference: ``frames`` (B, src, d) for enc-dec (the stubbed audio frontend's
output); ``patches`` (B, V, d) and ``positions`` (B, S, 3) for the VLM (the
stubbed vision encoder's output and the M-RoPE position ids).

Parameters keep the reference's pytree layout: per-layer weights stacked on
a leading ``L`` axis, projections applied as ``x @ w``, so weights converted
from the JAX package (``repro_torch.convert``) compute the same function.
The reference's ``lax.scan`` over the stack is a Python loop over ``L``.

Two differences of idiom: ``decode_step`` writes the new K/V (dense) or the
new recurrent state (ssm, hybrid) into the cache tensors in place (JAX
returns new arrays), and ``ring_kpos`` uses ``torch.remainder``, whose sign
follows the divisor as ``jnp.mod`` does (C's ``%`` and ``torch.fmod``
follow the dividend and would give wrong slots).

An RWKV6 cache is the recurrent state after the prompt, ``wkv`` (L,B,H,hd,hd)
fp32 and the token shifts ``x_tm``, ``x_cm`` (L,B,d), which hold the last
*normed* input of each mix (``time_mix``/``channel_mix`` return the last row
of their own input). Its ``prefill`` takes no stored prefix: the reference
serves a recurrent hit by restoring the state and feeding the suffix through
``decode_step``.

A Griffin model is ``U`` units of (rec, rec, local attention) and ``tail``
rec layers (``griffin_layout``: ``3·U + tail`` = ``num_layers``), stacked
under ``params["units"]`` and ``params["tail"]``. Its cache nests the same
way: ``units`` holds each unit's two recurrent states (``rec1_h``,
``rec1_conv``, ``rec2_h``, ``rec2_conv``) and its local-attention ring
``k``/``v`` of ``min(max_len, local_window)`` slots; ``tail`` holds ``h``
and ``conv``. The local attention's window is ``cfg.local_window``, not
``cfg.window_size``. Like RWKV6, its ``prefill`` takes no stored prefix.

A MoE layer holds ``moe`` (``repro_torch.models.moe``) where a dense one
holds ``mlp``; everything else of the family is the dense code: the same
caches, prefill (with a stored KV prefix) and decode. ``forward(...,
with_aux=True)`` also returns the mean over layers of each MoE aux value,
as the reference's does (an empty dict for the other families).

A VLM is a dense stack with ``patch_proj``: ``patches @ patch_proj`` go in
front of the tokens (``_embed_sequence``), and where ``batch`` holds
``positions`` (and the config ``mrope``) every layer turns q and k by
``apply_mrope`` instead of ``apply_rope``; without them the function is the
dense one. ``decode_step(..., mrope_positions=None)`` defaults to ``pos`` in
all three ids, the reference's default, which is ``forward``'s function only
where every earlier token's ids were equal too (text only); a caller with
vision tokens passes the ids. The serving engine passes tokens only, as the
reference's does.

An enc-dec model encodes ``frames @ frames_proj`` with ``encoder_layers``
bidirectional layers (``causal=False``, RoPE on q and k) and a final norm
into the memory; each of its ``num_layers`` decoder layers runs causal
self-attention (RoPE), cross-attention over the memory (``causal=False``,
no RoPE) and an MLP. Its cache holds the decoder's self-attention ring
``self_k``/``self_v`` (L,B,W,KV,hd), which ``decode_step`` writes in place,
and the memory's keys and values ``cross_k``/``cross_v`` (L,B,src,KV,hd),
which it only reads: a step's cross-attention sees all ``src`` slots. Its
``prefill`` takes no stored prefix.

``forward`` is also the training forward (``repro_torch.train.steps``).
Its layers come from ``unstack_layers``, one ``torch.unbind`` per stacked
leaf, so a gradient reaches each stacked leaf through one stack of the
layers' gradients. With ``remat`` (the default, as in the reference) and
grad enabled, each layer, each Griffin unit and tail layer and each enc-dec
decoder layer runs under ``torch.utils.checkpoint`` (non-reentrant), the
reference's ``jax.checkpoint``: the backward recomputes it, so only its
input is kept; under ``no_grad`` or ``inference_mode`` the flag changes
nothing.

The long-context mode (``long_context=True``, the reference's ``long_500k``
input shape) gives dense self-attention the window ``attn_window`` names:
``cfg.long_context_window``, or the smaller of that and ``cfg.window_size``
where the config has a window; the dense cache is then a ring of that many
slots. The Griffin branches keep ``cfg.local_window`` and the RWKV6 branches
ignore the flag, as in the reference. The serving engine takes no such
option, since the reference's takes none.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import griffin as gr
from repro_torch.models import moe
from repro_torch.models import rwkv6 as rw
from repro_torch.models.common import (apply_mrope, apply_rope, attention,
                                       decode_attend, dense_init, init_rmsnorm,
                                       mlp, normal_init, rmsnorm)

Params = Dict[str, Any]
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")   # all of them


def _check_family(cfg: ModelConfig):
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


# --------------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------------- #

def attn_window(cfg: ModelConfig, long_context: bool = False) -> Optional[int]:
    """Effective sliding window for dense self-attention."""
    if long_context:
        w = cfg.long_context_window
        if cfg.window_size:
            w = min(w, cfg.window_size)
        return w
    return cfg.window_size


def cache_width(cfg: ModelConfig, max_len: int, long_context: bool = False) -> int:
    w = attn_window(cfg, long_context)
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


def unstack_layers(stacked):
    """The layers of parameters stacked on a leading axis, as a list of
    per-layer trees of views (``torch.unbind`` of each leaf)."""
    if isinstance(stacked, dict):
        per_key = {k: unstack_layers(v) for k, v in stacked.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(stacked))


def _stacked_init(L: int, init_layer):
    """``L`` draws of ``init_layer()`` stacked on a leading axis, copied in
    one layer at a time so that init never holds more than the stack and
    the layer being drawn."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return t.new_empty((L,) + tuple(t.shape))

    def put(dst, src, i):
        if isinstance(src, dict):
            for k, v in src.items():
                put(dst[k], v, i)
        else:
            dst[i] = src

    layer = init_layer()
    out = alloc(layer)
    for i in range(L):
        put(out, layer if i == 0 else init_layer(), i)
        layer = None                # layer 0 is in the stack: let it go
    return out


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


def _rope_qk(cfg: ModelConfig, q, k, positions, mrope_positions=None):
    if cfg.mrope and mrope_positions is not None:
        return (apply_mrope(q, mrope_positions, cfg.rope_theta),
                apply_mrope(k, mrope_positions, cfg.rope_theta))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _ffn(p, cfg: ModelConfig, h):
    """The layer's FFN on its normed input: (y, aux), aux empty for an MLP."""
    if "moe" in p:
        return moe.moe_ffn(p["moe"], h, cfg)
    return mlp(p["mlp"], h, cfg), {}


def _attn_layer_fwd(p, cfg: ModelConfig, x, *, window, q_offset=0,
                    mrope_positions=None, prefix_kv=None, return_kv=False,
                    with_aux=False):
    """Residual attention sub-block + FFN sub-block (full sequence). A MoE
    layer's aux dict is returned beside the output with ``with_aux`` (empty
    for an MLP layer)."""
    B, S, _ = x.shape
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    q, k, v = _qkv(p["attn"], cfg, h)
    positions = q_offset + torch.arange(S, device=x.device)
    q, k = _rope_qk(cfg, q, k, positions, mrope_positions)
    if prefix_kv is not None:                      # cached-context prefill
        k = torch.cat([prefix_kv[0], k], dim=1)
        v = torch.cat([prefix_kv[1], v], dim=1)
    o = attention(q, k, v, q_offset=q_offset, window=window)
    x = x + o.reshape(B, S, -1) @ p["attn"]["wo"]
    y, aux = _ffn(p, cfg, rmsnorm(p["ln2"], x, cfg.norm_eps))
    x = x + y
    if with_aux:
        return x, aux
    if return_kv:
        return x, (k, v)
    return x


def _attn_layer_decode(p, cfg: ModelConfig, x_t, k_cache, v_cache, pos: int, *,
                       window, mrope_positions=None):
    """x_t: (B,1,d); caches: (B,W,KV,hd), written in place at slot pos % W."""
    B = x_t.shape[0]
    W = k_cache.shape[1]
    h = rmsnorm(p["ln1"], x_t, cfg.norm_eps)
    q, k, v = _qkv(p["attn"], cfg, h)
    pos_arr = torch.full((1,), pos, device=x_t.device)
    q, k = _rope_qk(cfg, q, k, pos_arr, mrope_positions)
    slot = pos % W
    k_cache[:, slot] = k[:, 0]
    v_cache[:, slot] = v[:, 0]
    kpos = ring_kpos(W, pos, x_t.device)
    o = decode_attend(q, k_cache, v_cache, kpos, pos, window=window)
    x_t = x_t + o.reshape(B, 1, -1) @ p["attn"]["wo"]
    return x_t + _ffn(p, cfg, rmsnorm(p["ln2"], x_t, cfg.norm_eps))[0]


# --------------------------------------------------------------------------- #
# RWKV6 layer
# --------------------------------------------------------------------------- #

def _init_rwkv_layer(generator, cfg: ModelConfig, dtype):
    return {
        "ln1": init_rmsnorm(cfg.d_model, dtype, generator.device),
        "tmix": rw.init_time_mix(generator, cfg, dtype),
        "ln2": init_rmsnorm(cfg.d_model, dtype, generator.device),
        "cmix": rw.init_channel_mix(generator, cfg, dtype),
    }


def _rwkv_layer_fwd(p, cfg: ModelConfig, x, state):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    o, x_tm, wkv = rw.time_mix(p["tmix"], cfg, h, state["x_tm"], state["wkv"])
    x = x + o
    h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
    o2, x_cm = rw.channel_mix(p["cmix"], h2, state["x_cm"])
    x = x + o2
    return x, {"wkv": wkv, "x_tm": x_tm, "x_cm": x_cm}


def _write_state(cache, i: int, st):
    """Layer ``i``'s new state into the stacked cache, in place."""
    for name, t in st.items():
        cache[name][i].copy_(t)


def _rwkv_empty_state(cfg: ModelConfig, B: int, dtype, device):
    H, hd = cfg.num_rwkv_heads, cfg.rwkv_head_dim
    return {"wkv": torch.zeros((B, H, hd, hd), dtype=torch.float32, device=device),
            "x_tm": torch.zeros((B, cfg.d_model), dtype=dtype, device=device),
            "x_cm": torch.zeros((B, cfg.d_model), dtype=dtype, device=device)}


# --------------------------------------------------------------------------- #
# Griffin unit (rec, rec, local-attn), each with its own MLP
# --------------------------------------------------------------------------- #

def griffin_layout(cfg: ModelConfig):
    """(num_units, num_tail_rec) such that 3*U + tail == num_layers."""
    units = cfg.num_layers // 3
    tail = cfg.num_layers - 3 * units
    return units, tail


def _rec_layer_fwd(p, cfg: ModelConfig, x, state):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    o, state = gr.rglru_block(p["rg"], h, state)
    x = x + o
    x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    return x, state


def _rec_layer_decode(p, cfg: ModelConfig, x_t, state):
    h = rmsnorm(p["ln1"], x_t, cfg.norm_eps)
    o, state = gr.rglru_block_step(p["rg"], h[:, 0], state)
    x_t = x_t + o[:, None]
    x_t = x_t + mlp(p["mlp"], rmsnorm(p["ln2"], x_t, cfg.norm_eps), cfg)
    return x_t, state


def _rec_state(cache, i: int, prefix: str = ""):
    """Layer ``i``'s recurrent state in a stacked Griffin cache (views)."""
    return {"h": cache[prefix + "h"][i], "conv": cache[prefix + "conv"][i]}


def _write_rec_state(cache, i: int, st, prefix: str = ""):
    """Layer ``i``'s new recurrent state into the stacked cache, in place."""
    cache[prefix + "h"][i].copy_(st["h"])
    cache[prefix + "conv"][i].copy_(st["conv"])


# --------------------------------------------------------------------------- #
# enc-dec layers
# --------------------------------------------------------------------------- #

def _enc_layer_fwd(p, cfg: ModelConfig, x):
    B, S, _ = x.shape
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    q, k, v = _qkv(p["attn"], cfg, h)
    q, k = _rope_qk(cfg, q, k, torch.arange(S, device=x.device))
    o = attention(q, k, v, causal=False)           # bidirectional
    x = x + o.reshape(B, S, -1) @ p["attn"]["wo"]
    return x + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)


def _cross_q(p, cfg: ModelConfig, x):
    """The cross-attention's queries from the decoder stream (no RoPE)."""
    B, S, _ = x.shape
    hx = rmsnorm(p["ln_x"], x, cfg.norm_eps)
    return (hx @ p["cross_attn"]["wq"]).reshape(B, S, cfg.num_heads, cfg.head_dim)


def _dec_layer_fwd(p, cfg: ModelConfig, x, memory, *, window=None, return_kv=False):
    B, S, _ = x.shape
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    q, k, v = _qkv(p["self_attn"], cfg, h)
    q, k = _rope_qk(cfg, q, k, torch.arange(S, device=x.device))
    o = attention(q, k, v, window=window)
    x = x + o.reshape(B, S, -1) @ p["self_attn"]["wo"]

    qx = _cross_q(p, cfg, x)
    ck = (memory @ p["cross_attn"]["wk"]).reshape(B, -1, cfg.num_kv_heads, cfg.head_dim)
    cv = (memory @ p["cross_attn"]["wv"]).reshape(B, -1, cfg.num_kv_heads, cfg.head_dim)
    ox = attention(qx, ck, cv, causal=False)
    x = x + ox.reshape(B, S, -1) @ p["cross_attn"]["wo"]

    x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    if return_kv:
        return x, (k, v, ck, cv)
    return x


def _dec_layer_decode(p, cfg: ModelConfig, x_t, sk, sv, ck, cv, pos: int, *,
                      window=None):
    """x_t: (B,1,d); the self ring sk/sv (B,W,KV,hd), written in place at
    slot pos % W; the memory's ck/cv (B,src,KV,hd), read only."""
    B = x_t.shape[0]
    W = sk.shape[1]
    h = rmsnorm(p["ln1"], x_t, cfg.norm_eps)
    q, k, v = _qkv(p["self_attn"], cfg, h)
    q, k = _rope_qk(cfg, q, k, torch.full((1,), pos, device=x_t.device))
    slot = pos % W
    sk[:, slot] = k[:, 0]
    sv[:, slot] = v[:, 0]
    o = decode_attend(q, sk, sv, ring_kpos(W, pos, x_t.device), pos, window=window)
    x_t = x_t + o.reshape(B, 1, -1) @ p["self_attn"]["wo"]

    src = ck.shape[1]
    ox = decode_attend(_cross_q(p, cfg, x_t), ck, cv,
                       torch.arange(src, device=x_t.device), src)
    x_t = x_t + ox.reshape(B, 1, -1) @ p["cross_attn"]["wo"]
    return x_t + mlp(p["mlp"], rmsnorm(p["ln2"], x_t, cfg.norm_eps), cfg)


def _encode(params: Params, cfg: ModelConfig, frames):
    x = frames @ params["frames_proj"]
    for lp in unstack_layers(params["encoder"]):
        x = _enc_layer_fwd(lp, cfg, x)
    return rmsnorm(params["enc_ln"], x, cfg.norm_eps)


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #

def _init_mlp(generator, cfg: ModelConfig, dtype):
    d, dff = cfg.d_model, cfg.d_ff
    p = {"w_up": dense_init(generator, d, dff, dtype),
         "w_down": dense_init(generator, dff, d, dtype)}
    if cfg.gated_mlp:
        p["w_gate"] = dense_init(generator, d, dff, dtype)
    return p


def _init_attention(generator, cfg: ModelConfig, dtype):
    d = cfg.d_model
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"wq": dense_init(generator, d, H * hd, dtype),
            "wk": dense_init(generator, d, KV * hd, dtype),
            "wv": dense_init(generator, d, KV * hd, dtype),
            "wo": dense_init(generator, H * hd, d, dtype)}


def _init_attn_layer(generator, cfg: ModelConfig, dtype):
    """A dense, MoE or VLM layer, or an enc-dec encoder layer (a Griffin
    unit's attention layer is dense)."""
    d = cfg.d_model
    p = {
        "ln1": init_rmsnorm(d, dtype, generator.device),
        "attn": _init_attention(generator, cfg, dtype),
        "ln2": init_rmsnorm(d, dtype, generator.device),
    }
    if cfg.family == "moe":
        p["moe"] = moe.init_moe(generator, cfg, dtype)
    else:
        p["mlp"] = _init_mlp(generator, cfg, dtype)
    return p


def _init_rec_layer(generator, cfg: ModelConfig, dtype):
    return {"ln1": init_rmsnorm(cfg.d_model, dtype, generator.device),
            "rg": gr.init_rglru_block(generator, cfg, dtype),
            "ln2": init_rmsnorm(cfg.d_model, dtype, generator.device),
            "mlp": _init_mlp(generator, cfg, dtype)}


def _init_griffin_unit(generator, cfg: ModelConfig, dtype):
    return {"rec1": _init_rec_layer(generator, cfg, dtype),
            "rec2": _init_rec_layer(generator, cfg, dtype),
            "attn": _init_attn_layer(generator, cfg, dtype)}


def _init_dec_layer(generator, cfg: ModelConfig, dtype):
    d, dev = cfg.d_model, generator.device
    return {"ln1": init_rmsnorm(d, dtype, dev),
            "self_attn": _init_attention(generator, cfg, dtype),
            "ln_x": init_rmsnorm(d, dtype, dev),
            "cross_attn": _init_attention(generator, cfg, dtype),
            "ln2": init_rmsnorm(d, dtype, dev),
            "mlp": _init_mlp(generator, cfg, dtype)}


def init_params(generator: torch.Generator, cfg: ModelConfig,
                dtype=torch.bfloat16) -> Params:
    """Random weights with the reference's shapes and scales, drawn from
    ``generator`` on ``generator.device``. The draws differ from
    ``jax.random``; to compare with the JAX package, convert its weights
    with ``repro_torch.convert.params_from_jax`` instead. RWKV6's
    ``rw.FP32_LEAVES``, Griffin's ``gr.FP32_LEAVES`` and the MoE router are
    fp32 whatever ``dtype`` is, as in the reference."""
    _check_family(cfg)
    V, d = cfg.padded_vocab, cfg.d_model
    p = {
        "embed": normal_init(generator, (V, d), 0.02, dtype),
        "final_ln": init_rmsnorm(d, dtype, generator.device),
        "unembed": dense_init(generator, d, V, dtype),
    }
    if cfg.family == "hybrid":
        U, tail = griffin_layout(cfg)
        p["units"] = _stacked_init(U, lambda: _init_griffin_unit(generator, cfg, dtype))
        if tail:
            p["tail"] = _stacked_init(tail, lambda: _init_rec_layer(generator, cfg, dtype))
        return p
    if cfg.family == "encdec":
        p["frames_proj"] = dense_init(generator, d, d, dtype)
        p["encoder"] = _stacked_init(cfg.encoder_layers,
                                     lambda: _init_attn_layer(generator, cfg, dtype))
        p["enc_ln"] = init_rmsnorm(d, dtype, generator.device)
        p["decoder"] = _stacked_init(cfg.num_layers,
                                     lambda: _init_dec_layer(generator, cfg, dtype))
        return p
    init_layer = _init_rwkv_layer if cfg.family == "ssm" else _init_attn_layer
    p["layers"] = _stacked_init(cfg.num_layers, lambda: init_layer(generator, cfg, dtype))
    if cfg.family == "vlm":
        p["patch_proj"] = dense_init(generator, d, d, dtype)
    return p


# --------------------------------------------------------------------------- #
# full-sequence forward
# --------------------------------------------------------------------------- #

def _embed_sequence(params: Params, cfg: ModelConfig, batch):
    """Token (+ modality-stub) embedding -> (B, S, d): a VLM batch's
    ``patches @ patch_proj`` go in front of the tokens."""
    x = params["embed"][batch["tokens"]]
    if cfg.family == "vlm" and "patches" in batch:
        vis = batch["patches"].to(x.dtype) @ params["patch_proj"]
        x = torch.cat([vis, x], dim=1)
    return x


def _remat(fn, x):
    """``fn(x)``, recomputed in the backward instead of keeping what it
    saves: the reference's ``jax.checkpoint`` around a layer."""
    return checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False)


def _call(fn, x):
    return fn(x)


def forward(params: Params, cfg: ModelConfig, batch, *, long_context=False,
            remat=True, return_hidden=False, with_aux=False):
    """Full-sequence logits (B, S, padded_vocab), S counting a VLM's vision
    tokens. ``return_hidden``: the post-final-norm hidden states (B, S, d)
    instead (training projects them onto the vocabulary in chunks);
    ``remat``: each layer recomputed in the backward while grad is enabled;
    ``with_aux``: also the mean over layers of each MoE aux value (empty for
    other families)."""
    _check_family(cfg)
    x = _embed_sequence(params, cfg, batch)
    ck = _remat if remat and torch.is_grad_enabled() else _call
    auxs = []
    if cfg.family == "ssm":
        st = _rwkv_empty_state(cfg, x.shape[0], x.dtype, x.device)
        for lp in unstack_layers(params["layers"]):
            x = ck(lambda x, lp=lp: _rwkv_layer_fwd(lp, cfg, x, st)[0], x)
    elif cfg.family == "hybrid":
        rst = gr.init_recurrent_state(cfg, x.shape[0], x.dtype, x.device)

        def unit(x, up):
            x, _ = _rec_layer_fwd(up["rec1"], cfg, x, rst)
            x, _ = _rec_layer_fwd(up["rec2"], cfg, x, rst)
            return _attn_layer_fwd(up["attn"], cfg, x, window=cfg.local_window)
        for up in unstack_layers(params["units"]):
            x = ck(lambda x, up=up: unit(x, up), x)
        for lp in unstack_layers(params["tail"]) if "tail" in params else ():
            x = ck(lambda x, lp=lp: _rec_layer_fwd(lp, cfg, x, rst)[0], x)
    elif cfg.family == "encdec":
        memory = _encode(params, cfg, batch["frames"].to(x.dtype))
        window = attn_window(cfg, long_context)
        for lp in unstack_layers(params["decoder"]):
            x = ck(lambda x, lp=lp: _dec_layer_fwd(lp, cfg, x, memory, window=window), x)
    else:
        window = attn_window(cfg, long_context)
        mrope_positions = batch.get("positions") if cfg.mrope else None
        for lp in unstack_layers(params["layers"]):
            x, aux = ck(lambda x, lp=lp: _attn_layer_fwd(
                lp, cfg, x, window=window, mrope_positions=mrope_positions,
                with_aux=True), x)
            auxs.append(aux)
    x = rmsnorm(params["final_ln"], x, cfg.norm_eps)
    out = x if return_hidden else x @ params["unembed"]
    if not with_aux:
        return out
    return out, {k: torch.stack([a[k] for a in auxs]).mean()
                 for k in (auxs[0] if auxs else {})}


# --------------------------------------------------------------------------- #
# cache init / prefill / decode
# --------------------------------------------------------------------------- #

def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device="cuda", long_context=False):
    _check_family(cfg)
    if cfg.family == "hybrid":
        U, tail = griffin_layout(cfg)
        B, dr, cw = batch_size, cfg.rnn_width, cfg.conv_width
        Wl = min(max_len, cfg.local_window)

        def zeros(shape, dt):
            return torch.zeros(shape, dtype=dt, device=device)
        kv = (U, B, Wl, cfg.num_kv_heads, cfg.head_dim)
        cache = {"units": {
            "rec1_h": zeros((U, B, dr), torch.float32),
            "rec1_conv": zeros((U, B, cw - 1, dr), dtype),
            "rec2_h": zeros((U, B, dr), torch.float32),
            "rec2_conv": zeros((U, B, cw - 1, dr), dtype),
            "k": zeros(kv, dtype), "v": zeros(kv, dtype)}}
        if tail:
            cache["tail"] = {"h": zeros((tail, B, dr), torch.float32),
                             "conv": zeros((tail, B, cw - 1, dr), dtype)}
        return cache
    if cfg.family == "ssm":
        L, B, d = cfg.num_layers, batch_size, cfg.d_model
        H, hd = cfg.num_rwkv_heads, cfg.rwkv_head_dim
        return {"wkv": torch.zeros((L, B, H, hd, hd), dtype=torch.float32,
                                   device=device),
                "x_tm": torch.zeros((L, B, d), dtype=dtype, device=device),
                "x_cm": torch.zeros((L, B, d), dtype=dtype, device=device)}
    W = cache_width(cfg, max_len, long_context)
    shape = (cfg.num_layers, batch_size, W, cfg.num_kv_heads, cfg.head_dim)
    if cfg.family == "encdec":
        cross = (cfg.num_layers, batch_size, cfg.source_len, cfg.num_kv_heads,
                 cfg.head_dim)
        return {"self_k": torch.zeros(shape, dtype=dtype, device=device),
                "self_v": torch.zeros(shape, dtype=dtype, device=device),
                "cross_k": torch.zeros(cross, dtype=dtype, device=device),
                "cross_v": torch.zeros(cross, dtype=dtype, device=device)}
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
            long_context=False, prefix_cache=None, prefix_len: int = 0):
    """Process a prompt, returning (logits, cache) ready for decode.

    prefix_cache/prefix_len: reuse a stored KV prefix (the paper's cache-hit
    path) — new tokens attend to prefix keys with q_offset = prefix_len.
    ``prefix_cache`` needs ``[:, :, :prefix_len]`` to hold positions
    ``0..prefix_len-1`` in order (a ring that has not wrapped). Dense, moe
    and vlm families only; an ssm or hybrid prefill starts from the empty
    state, and an encdec one from the frames.
    """
    _check_family(cfg)
    x = _embed_sequence(params, cfg, batch)
    B = x.shape[0]
    if cfg.family in ("ssm", "hybrid") and (prefix_cache is not None or prefix_len):
        raise ValueError(f"{cfg.name}: a recurrent prefill starts from the empty "
                         "state; a stored state is resumed through decode_step")
    if cfg.family == "encdec":
        if prefix_cache is not None or prefix_len:
            raise ValueError(f"{cfg.name}: an enc-dec prefill takes no stored "
                             "prefix (the reference's has no prefix route)")
        return _encdec_prefill(params, cfg, batch, x, max_len, long_context)
    if cfg.family == "hybrid":
        return _griffin_prefill(params, cfg, x, max_len)
    if cfg.family == "ssm":
        st0 = _rwkv_empty_state(cfg, B, x.dtype, x.device)
        cache = init_cache(cfg, B, max_len, x.dtype, x.device)
        for i in range(cfg.num_layers):
            x, st = _rwkv_layer_fwd(layer_params(params["layers"], i), cfg, x, st0)
            _write_state(cache, i, st)
        x = rmsnorm(params["final_ln"], x, cfg.norm_eps)
        return x @ params["unembed"], cache
    window = attn_window(cfg, long_context)
    W = cache_width(cfg, max_len, long_context)
    mrope_positions = batch.get("positions") if cfg.mrope else None
    cache = init_cache(cfg, B, max_len, x.dtype, x.device, long_context)
    for i in range(cfg.num_layers):
        prefix_kv = None
        if prefix_cache is not None:
            prefix_kv = (prefix_cache["k"][i, :, :prefix_len],
                         prefix_cache["v"][i, :, :prefix_len])
        x, (k, v) = _attn_layer_fwd(
            layer_params(params["layers"], i), cfg, x, window=window,
            q_offset=prefix_len, mrope_positions=mrope_positions,
            prefix_kv=prefix_kv, return_kv=True)
        cache["k"][i] = _place_kv_in_ring(k, W)
        cache["v"][i] = _place_kv_in_ring(v, W)
    x = rmsnorm(params["final_ln"], x, cfg.norm_eps)
    return x @ params["unembed"], cache


def _encdec_prefill(params: Params, cfg: ModelConfig, batch, x, max_len: int,
                    long_context: bool):
    """The decoder over the prompt, against the encoded frames: the self
    ring of each layer and the memory's keys and values as the cache."""
    memory = _encode(params, cfg, batch["frames"].to(x.dtype))
    window = attn_window(cfg, long_context)
    W = cache_width(cfg, max_len, long_context)
    kv = {"self_k": [], "self_v": [], "cross_k": [], "cross_v": []}
    for i in range(cfg.num_layers):
        x, (k, v, ck, cv) = _dec_layer_fwd(layer_params(params["decoder"], i), cfg,
                                           x, memory, window=window, return_kv=True)
        for name, t in zip(kv, (_place_kv_in_ring(k, W), _place_kv_in_ring(v, W),
                                ck, cv)):
            kv[name].append(t)
    x = rmsnorm(params["final_ln"], x, cfg.norm_eps)
    return x @ params["unembed"], {name: torch.stack(ts) for name, ts in kv.items()}


def _griffin_prefill(params: Params, cfg: ModelConfig, x, max_len: int):
    rst0 = gr.init_recurrent_state(cfg, x.shape[0], x.dtype, x.device)
    Wl = min(max_len, cfg.local_window)
    cache = init_cache(cfg, x.shape[0], max_len, x.dtype, x.device)
    U, tail = griffin_layout(cfg)
    uc = cache["units"]
    for i in range(U):
        up = layer_params(params["units"], i)
        x, s1 = _rec_layer_fwd(up["rec1"], cfg, x, rst0)
        x, s2 = _rec_layer_fwd(up["rec2"], cfg, x, rst0)
        x, (k, v) = _attn_layer_fwd(up["attn"], cfg, x, window=cfg.local_window,
                                    return_kv=True)
        _write_rec_state(uc, i, s1, "rec1_")
        _write_rec_state(uc, i, s2, "rec2_")
        uc["k"][i] = _place_kv_in_ring(k, Wl)
        uc["v"][i] = _place_kv_in_ring(v, Wl)
    for i in range(tail):
        x, st = _rec_layer_fwd(layer_params(params["tail"], i), cfg, x, rst0)
        _write_rec_state(cache["tail"], i, st)
    x = rmsnorm(params["final_ln"], x, cfg.norm_eps)
    return x @ params["unembed"], cache


def _griffin_decode(params: Params, cfg: ModelConfig, cache, x, pos: int):
    U, tail = griffin_layout(cfg)
    uc = cache["units"]
    for i in range(U):
        up = layer_params(params["units"], i)
        for name in ("rec1", "rec2"):
            x, st = _rec_layer_decode(up[name], cfg, x, _rec_state(uc, i, name + "_"))
            _write_rec_state(uc, i, st, name + "_")
        x = _attn_layer_decode(up["attn"], cfg, x, uc["k"][i], uc["v"][i], pos,
                               window=cfg.local_window)
    for i in range(tail):
        x, st = _rec_layer_decode(layer_params(params["tail"], i), cfg, x,
                                  _rec_state(cache["tail"], i))
        _write_rec_state(cache["tail"], i, st)
    return x


def decode_step(params: Params, cfg: ModelConfig, cache, tokens, pos: int, *,
                long_context=False, mrope_positions=None):
    """One autoregressive step. tokens: (B,1) int64; pos: the absolute
    position being written; mrope_positions (B,1,3), for an ``mrope``
    config, default to ``pos`` in all three ids, as in the reference.
    Returns (logits (B,1,V), cache); the cache's tensors are updated in
    place (an enc-dec cache's self ring only)."""
    _check_family(cfg)
    pos = int(pos)
    x = params["embed"][tokens]
    if cfg.family == "hybrid":
        x = _griffin_decode(params, cfg, cache, x, pos)
        x = rmsnorm(params["final_ln"], x, cfg.norm_eps)
        return x @ params["unembed"], cache
    if cfg.family == "ssm":
        # single-token time/channel mix via the full-sequence path with S=1
        for i in range(cfg.num_layers):
            st = {name: t[i] for name, t in cache.items()}
            x, st = _rwkv_layer_fwd(layer_params(params["layers"], i), cfg, x, st)
            _write_state(cache, i, st)
        x = rmsnorm(params["final_ln"], x, cfg.norm_eps)
        return x @ params["unembed"], cache
    window = attn_window(cfg, long_context)
    if cfg.family == "encdec":
        for i in range(cfg.num_layers):
            x = _dec_layer_decode(layer_params(params["decoder"], i), cfg, x,
                                  cache["self_k"][i], cache["self_v"][i],
                                  cache["cross_k"][i], cache["cross_v"][i], pos,
                                  window=window)
    else:
        if cfg.mrope and mrope_positions is None:
            mrope_positions = torch.full((tokens.shape[0], 1, 3), pos,
                                         device=x.device)
        for i in range(cfg.num_layers):
            x = _attn_layer_decode(layer_params(params["layers"], i), cfg, x,
                                   cache["k"][i], cache["v"][i], pos, window=window,
                                   mrope_positions=mrope_positions)
    x = rmsnorm(params["final_ln"], x, cfg.norm_eps)
    return x @ params["unembed"], cache
