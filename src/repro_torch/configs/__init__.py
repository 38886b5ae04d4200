"""Architecture registry of the port: ``get_config("yi-6b")`` etc.

The reference's whole registry: the dense family (yi-6b, llama3-8b,
llama3-70b, h2o-danube-1.8b, minitron-8b, nemotron-4-15b), the moe family
(dbrx-132b, grok-1-314b), rwkv6-1.6b (``ssm``), recurrentgemma-2b
(``hybrid``), qwen2-vl-2b (``vlm``) and seamless-m4t-large-v2 (``encdec``).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "minitron-8b": "minitron_8b",
    "nemotron-4-15b": "nemotron_4_15b",
    "yi-6b": "yi_6b",
    "dbrx-132b": "dbrx_132b",
    "grok-1-314b": "grok_1_314b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    # the paper's own evaluation models
    "llama3-70b": "llama3_70b",
    "llama3-8b": "llama3_8b",
}
ALL_ARCHS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


__all__ = ["ModelConfig", "get_config", "ALL_ARCHS"]
