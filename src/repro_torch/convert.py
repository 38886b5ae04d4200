"""Parameters of the JAX package, as numpy arrays, into the port's layout.

``params_from_jax`` takes the pytree that ``repro.models.transformer
.init_params`` builds, already turned into numpy arrays (for instance with
``jax.tree.map(np.asarray, params)`` on the caller's side; this package
never imports jax), and returns the same nested dict of torch tensors. The
stacked leading-``L`` layout and the ``x @ w`` orientation are kept, so both
packages compute the same function on the same weights.

Leaves go to ``dtype``, except RWKV6's ``FP32_LEAVES`` (``mu``,
``decay_base``, ``u``, ``mu_k``, ``mu_r``), Griffin's (``ba``, ``bx``,
``lam``) and the MoE ``router``, which the reference keeps in fp32 whatever
the model's dtype: rounding ``decay_base`` (about -4.5) to bf16 would move
it by up to 0.016 and every decay ``exp(-exp(.))`` with it, and a bf16
router would change which experts a token goes to.

A MoE (``moe``) pytree is a dense one whose layers hold ``moe``
(``router``, ``w_up``, ``w_gate``, ``w_down``, the experts on a leading
``E`` axis) in place of ``mlp``.

``opt_state_from_jax`` turns the reference's ``AdamWState`` (step, mu,
nu), its leaves numpy arrays, into the port's
(``repro_torch.train.optimizer.AdamWState``: the step an int, the moments
fp32 tensors in the parameters' layout), so both packages can take the same
steps from the same state.

A Griffin (``hybrid``) pytree holds ``units`` and, when ``num_layers`` is
not a multiple of 3, ``tail`` instead of ``layers``. Its ``units`` stack may
have length 0: the reference's ``reduced(num_layers=2)`` is two tail layers.

A VLM (``vlm``) pytree is a dense one with ``patch_proj``. An enc-dec
(``encdec``) pytree holds ``frames_proj``, the ``encoder`` stack of
``encoder_layers`` layers (a dense layer's leaves), ``enc_ln`` and the
``decoder`` stack of ``num_layers`` layers (``ln1``, ``self_attn``,
``ln_x``, ``cross_attn``, ``ln2``, ``mlp``) instead of ``layers``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import griffin, moe, rwkv6
from repro_torch.models.transformer import griffin_layout
from repro_torch.train.optimizer import AdamWState

FP32_LEAVES = rwkv6.FP32_LEAVES + griffin.FP32_LEAVES + moe.FP32_LEAVES


def _to_torch(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, torch.float32 if k in FP32_LEAVES else dtype)
                for k, v in tree.items()}
    # via fp32: numpy has no native bfloat16, and bf16 -> fp32 -> bf16 is exact
    arr = np.array(tree, dtype=np.float32, order="C")     # a writable copy
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _stack_len(tree) -> int:
    return np.shape(_first_leaf(tree))[0]


def params_from_jax(np_params, cfg: ModelConfig, device="cuda",
                    dtype=torch.float32):
    """Convert a parameter pytree (numpy leaves) of any family."""
    expected = {"embed", "final_ln", "unembed"}
    if cfg.family == "hybrid":
        U, tail = griffin_layout(cfg)
        expected |= {"units", "tail"} if tail else {"units"}
    elif cfg.family == "encdec":
        expected |= {"frames_proj", "encoder", "enc_ln", "decoder"}
    else:
        expected |= {"layers", "patch_proj"} if cfg.family == "vlm" else {"layers"}
    if set(np_params) != expected:
        raise ValueError(f"{cfg.family} params have keys {sorted(expected)}; got "
                         f"{sorted(np_params)}")
    if cfg.family == "hybrid":
        got = (_stack_len(np_params["units"]),
               _stack_len(np_params["tail"]) if tail else 0)
        if got != (U, tail):
            raise ValueError(f"params stack {got[0]} units and {got[1]} tail layers "
                             f"(3·U + tail = {3 * got[0] + got[1]}); config has "
                             f"{cfg.num_layers} layers, {U} units and {tail} tail")
    elif cfg.family == "encdec":
        got = (_stack_len(np_params["encoder"]), _stack_len(np_params["decoder"]))
        if got != (cfg.encoder_layers, cfg.num_layers):
            raise ValueError(f"params stack {got[0]} encoder and {got[1]} decoder "
                             f"layers; config has {cfg.encoder_layers} and "
                             f"{cfg.num_layers}")
    else:
        L = _stack_len(np_params["layers"])
        if L != cfg.num_layers:
            raise ValueError(f"params stack {L} layers; config has {cfg.num_layers}")
    return _to_torch(np_params, device, dtype)


def opt_state_from_jax(np_state, device="cuda") -> AdamWState:
    """A reference ``AdamWState`` (or a (step, mu, nu) tuple) with numpy
    leaves into the port's, the moments fp32 on ``device``."""
    step, mu, nu = np_state
    return AdamWState(int(np.asarray(step)), _to_torch(mu, device, torch.float32),
                      _to_torch(nu, device, torch.float32))
