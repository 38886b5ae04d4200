"""Public kernel entry points, under the names of ``repro.kernels.ops``,
``rglru_step``, the RG-LRU decode step with its elementwise chain fused
(the reference leaves that step to XLA, ``repro/models/griffin.py``), and
``flash_attention_bwd``, the gradient of ``flash_attention`` (the reference
takes it by autodiff; ``flash_attention`` calls it from autograd).

The model code calls only these. Each runs its hand-written CUDA kernel for
a CUDA tensor and its plain PyTorch version for a CPU tensor; there is no
flag that picks the plain version on the card.
"""
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
from repro_torch.kernels.rglru import rglru_scan, rglru_step
from repro_torch.kernels.wkv6 import wkv6

__all__ = ["flash_attention", "flash_attention_bwd", "decode_attention", "rglru_scan",
           "rglru_step", "wkv6"]
