"""Training step, the twin of ``repro/train/steps.py``: chunked
cross-entropy (the (B, S, vocab) logits are never held whole) and the AdamW
update.

``make_train_step`` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``, as the reference's does; it takes the
gradients with ``torch.autograd.grad`` of ``loss_fn`` and updates the
parameters in place (``optimizer.adamw_update``). On the card every
family trains through the kernels' gradients: the attention's is the flash
backward kernel (``ops.flash_attention_bwd``), RWKV6's recurrence's the
wkv6 backward (``ops.wkv6_bwd``, from the checkpoints of the forward's
training entry) and the RG-LRU scan's ``ops.rglru_scan_bwd``; on the CPU,
autograd of the plain versions.

``batch`` holds torch tensors (``data.batch_to``): ``tokens`` and
``labels`` (B, S) int64, plus the family extras of ``forward``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import forward, init_params
from repro_torch.train import tree
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update

LOSS_CHUNK = 256
IGNORE_LABEL = -1
# compute the per-chunk vocab logits in fp32 (True, the reference's default)
# or keep the product's dtype and upcast only for the logsumexp (False)
LOGITS_F32 = True


def chunked_softmax_xent(hidden, w_unembed, labels, *, chunk=LOSS_CHUNK):
    """hidden: (B, S, d); labels: (B, S) int64 (``IGNORE_LABEL`` masked).
    Returns (sum_nll, num_tokens), fp32 scalars."""
    B, S, d = hidden.shape
    if S % chunk != 0:
        chunk = S
    nll, cnt = [], []
    for c0 in range(0, S, chunk):
        hc, lc = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        logits = hc @ w_unembed                              # (B, chunk, V)
        if LOGITS_F32:
            logits = logits.float()
        logz = torch.logsumexp(logits.float(), dim=-1)
        safe = torch.clamp(lc, min=0)
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
        mask = (lc != IGNORE_LABEL).float()
        nll.append(((logz - gold) * mask).sum())
        cnt.append(mask.sum())
    return torch.stack(nll).sum(), torch.stack(cnt).sum()


def loss_fn(params, cfg: ModelConfig, batch, *, long_context=False):
    hidden, aux = forward(params, cfg, batch, long_context=long_context,
                          remat=True, return_hidden=True, with_aux=True)
    labels = batch["labels"]
    if hidden.shape[1] != labels.shape[1]:      # vlm: loss on text region only
        hidden = hidden[:, hidden.shape[1] - labels.shape[1]:]
    nll, cnt = chunked_softmax_xent(hidden, params["unembed"], labels)
    loss = nll / torch.clamp(cnt, min=1.0)
    metrics = {"loss": loss, "tokens": cnt}
    if "load_balance_loss" in aux:
        loss = loss + 0.01 * aux["load_balance_loss"] \
            + 0.001 * aux["router_z_loss"]
        metrics.update(aux)
    metrics["total_loss"] = loss
    return loss, metrics


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                    *, long_context=False):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics)."""

    def train_step(params, opt_state, batch):
        leaves = tree.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = loss_fn(params, cfg, batch, long_context=long_context)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the batch does not reach (a VLM's patch_proj without
        # patches) gets zeros, as jax.grad gives it
        grads = tree.unflatten(params, [torch.zeros_like(p) if g is None else g
                                        for g, p in zip(grads, leaves)])
        metrics = {k: v.detach() for k, v in metrics.items()}
        params, opt_state, opt_metrics = adamw_update(opt_cfg, grads, opt_state, params)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def init_train_state(generator, cfg: ModelConfig, dtype=torch.bfloat16, device="cuda"):
    """(params, opt_state): ``init_params``'s weights, drawn from
    ``generator`` (a ``torch.Generator``, whose device they land on, or an
    int seed for a generator on ``device``), and zero fp32 moments."""
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=device).manual_seed(int(generator))
    params = init_params(generator, cfg, dtype)
    return params, adamw_init(params)
