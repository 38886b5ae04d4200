"""AdamW, hand-rolled to match ``repro/train/optimizer.py`` step for step
(not ``torch.optim.AdamW``, whose order of operations and clipping
differ).

Moments are fp32 whatever the parameter's dtype; the update is computed in
fp32 and cast back, with the reference's order of operations: clip by the
global norm, the moments, bias correction, ``mhat / (sqrt(vhat) + eps)``,
decoupled weight decay on leaves of two or more dimensions only, then
``p - lr * delta``. The learning rate, the clip scale and the bias
corrections are fp32 scalars, as the reference computes them.

One difference of idiom: ``adamw_update`` writes the new parameters and
moments into their tensors in place (JAX returns new arrays), one leaf at a
time, so that at full width the only temporaries alive are two fp32 copies
of one leaf (for h2o-danube-1.8b's largest stacked leaf, (24, 2560, 6912),
1.70 GB each). ``AdamWState.step`` is a Python int.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.train import tree


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: int
    mu: Any
    nu: Any


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=0, mu=tree.map_leaves(params, zeros),
                      nu=tree.map_leaves(params, zeros))


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``; a 0-dim fp32
    tensor on the CPU."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree.leaves(grads)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """One step; returns ``(params, state, metrics)``, ``params`` and the
    moments updated in place."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(cfg, step)
    t = torch.tensor(float(step), dtype=torch.float32)
    b1c = 1.0 - cfg.b1 ** t
    b2c = 1.0 - cfg.b2 ** t
    names = [k for k, _ in tree.items(params)]
    for other in (grads, state.mu, state.nu):
        if [k for k, _ in tree.items(other)] != names:
            raise ValueError("grads, moments and params differ in structure")
    for g, m, v, p in zip(tree.leaves(grads), tree.leaves(state.mu),
                          tree.leaves(state.nu), tree.leaves(params)):
        g = g.to(torch.float32, copy=True).mul_(scale)
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        den = torch.div(v, b2c).sqrt_().add_(cfg.eps)     # sqrt(vhat) + eps
        delta = torch.div(m, b1c, out=g).div_(den)          # mhat / den, in g's memory
        del den
        if p.ndim >= 2:             # decoupled weight decay on matrices only
            delta.add_(p, alpha=cfg.weight_decay)
        p.copy_(delta.mul_(-lr).add_(p))                    # p - lr * delta
    return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm, "lr": lr}
