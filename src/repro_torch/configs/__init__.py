"""Architecture registry of the port: ``get_config("yi-6b")``,
``get_config("rwkv6-1.6b")``, ``get_config("recurrentgemma-2b")``.

Only the architectures the port serves are registered; the rest of the
reference's registry arrives with the slices that port their families.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "yi-6b": "yi_6b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


__all__ = ["ModelConfig", "get_config"]
