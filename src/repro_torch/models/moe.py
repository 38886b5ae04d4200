"""Mixture-of-Experts FFN with capacity-based scatter dispatch (GShard-style):
port of ``repro/models/moe.py``.

Dispatch scatters the kept (token, slot) assignments into ``(E, C, d)``
expert buffers, runs the experts as three batched products over ``E``
(plain GEMMs, as the reference's ``einsum``s are: it has no Pallas kernel
here), gathers the outputs back and combines them weighted by the gate.

The reference's ``BUF_CONSTRAINT`` and ``_maybe_constrain`` are left out:
they place the buffers on a device mesh (expert- or tensor-parallel), which
means nothing on one card.

Numerics against the reference, which decide which assignments drop:

* The router product is fp32 (``xt.float() @ router``; the router weight
  is fp32 whatever the model's dtype) and must not run in TF32.
* ``keep`` comes from a cumulative sum over the flattened ``(token,
  slot)`` order: an expert keeps its first ``C`` assignments by token, and
  any other order (slot-major, say) drops other tokens. A token's slots
  hold distinct experts, so their order, ``lax.top_k``'s descending one
  (``torch.topk(..., sorted=True)``), sets only the order of the combine's
  adds.
* The scatter writes each kept assignment to its own ``(expert, pos)``
  slot. Kept pairs are unique, so an ``index_put_`` without ``accumulate``
  computes the reference's ``.at[eid, pos].add`` with no atomics; dropped
  assignments go to a spare slot ``C`` that is cut off (the reference adds
  zeros at ``pos = 0``), so no boolean index syncs the host.
* The combine sums each token's ``K`` contributions in ``x.dtype`` in slot
  order, starting from zero, as ``K`` adds over a ``(T, K, d)`` view: an
  ``index_add_`` would sum them by atomics on the card, in an order that
  differs between calls and so between a hit and a cold prefill in bf16.
* The gate is cast to the activation dtype before its multiply.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import activation_fn, dense_init, normal_init

FP32_LEAVES = ("router",)           # fp32 whatever the model's dtype


def moe_capacity(cfg: ModelConfig, num_tokens: int) -> int:
    c = int(cfg.moe_capacity_factor * num_tokens * cfg.experts_per_token
            / cfg.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8, keep a floor


def init_moe(generator, cfg: ModelConfig, dtype):
    d, dff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        "router": dense_init(generator, d, E, torch.float32),  # router kept fp32
        "w_up": _expert_init(generator, E, d, dff, dtype),
        "w_down": _expert_init(generator, E, dff, d, dtype),
    }
    if cfg.gated_mlp:
        p["w_gate"] = _expert_init(generator, E, d, dff, dtype)
    return p


def _expert_init(generator, E, d_in, d_out, dtype):
    return normal_init(generator, (E, d_in, d_out), 1.0 / math.sqrt(d_in), dtype)


def _route(params, xt, K: int):
    """Router logits (fp32), probabilities, and each token's top ``K``
    experts with their renormalised weights, in descending order."""
    logits = xt.float() @ params["router"]                    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1, sorted=True)  # (T, K)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, top_p, top_e


def dispatch(cfg: ModelConfig, top_e, T: int):
    """(eid, pos, keep) of the flattened ``(token, slot)`` assignments: each
    one's expert, its position in that expert's buffer, and whether that
    position is under the capacity ``C`` (``pos`` is 0 where not)."""
    E, C = cfg.num_experts, moe_capacity(cfg, T)
    eid = top_e.reshape(-1)                                   # (T*K,)
    onehot = F.one_hot(eid, E)                                # (T*K, E)
    pos_all = torch.cumsum(onehot, dim=0) - onehot
    pos = torch.gather(pos_all, 1, eid[:, None])[:, 0]
    keep = pos < C
    return eid, torch.where(keep, pos, 0), keep


def moe_ffn(params, x, cfg: ModelConfig):
    """x: (B, S, d) -> (B, S, d), plus a dict of aux values
    (``load_balance_loss``, ``router_z_loss``, ``dropped_frac``)."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    T = B * S
    C = moe_capacity(cfg, T)
    xt = x.reshape(T, d)
    logits, probs, top_p, top_e = _route(params, xt, K)
    eid, pos, keep = dispatch(cfg, top_e, T)
    gate = top_p.reshape(T * K)

    # scatter tokens into (E, C, d) expert buffers; row C takes the drops
    tok = torch.arange(T, device=x.device).repeat_interleave(K)
    buf = torch.zeros((E, C + 1, d), dtype=x.dtype, device=x.device)
    buf.index_put_((eid, torch.where(keep, pos, C)), xt[tok])
    buf = buf[:, :C]

    # per-expert FFN, batched over E
    act = activation_fn(cfg.activation)
    h = act(torch.bmm(buf, params["w_up"]))
    if cfg.gated_mlp:
        h = h * torch.bmm(buf, params["w_gate"])
    out_buf = torch.bmm(h, params["w_down"])                  # (E, C, d)

    # gather back and combine weighted by gate, in slot order
    gathered = torch.where(keep[:, None], out_buf[eid, pos], 0)
    weighted = (gathered * gate[:, None].to(gathered.dtype)).to(x.dtype)
    weighted = weighted.reshape(T, K, d)
    y = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for k in range(K):
        y = y + weighted[:, k]

    # load-balance auxiliary loss (Switch-style)
    me = probs.mean(dim=0)                                    # (E,)
    ce = F.one_hot(top_e, E).float().sum(dim=(0, 1)) / (T * K)
    aux = {"load_balance_loss": E * torch.sum(me * ce),
           "router_z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
           "dropped_frac": 1.0 - keep.float().mean()}
    return y.reshape(B, S, d), aux


def moe_ffn_ref(params, x, cfg: ModelConfig):
    """Oracle: per-token dense routing (computes every expert on every
    token). Used to check the dispatch path (with capacity high enough that
    nothing drops)."""
    B, S, d = x.shape
    K = cfg.experts_per_token
    xt = x.reshape(-1, d)
    _, probs, top_p, top_e = _route(params, xt, K)
    act = activation_fn(cfg.activation)
    h = act(torch.einsum("td,edf->tef", xt, params["w_up"]))
    if cfg.gated_mlp:
        h = h * torch.einsum("td,edf->tef", xt, params["w_gate"])
    all_out = torch.einsum("tef,efd->ted", h, params["w_down"])  # (T, E, d)
    w = torch.zeros_like(probs).scatter(1, top_e, top_p)
    y = torch.einsum("ted,te->td", all_out.float(), w)
    return y.reshape(B, S, d).to(x.dtype)
