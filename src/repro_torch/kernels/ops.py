"""Public kernel entry points, under the names of ``repro.kernels.ops``.

The model code calls only these. Each runs its hand-written CUDA kernel for
a CUDA tensor and its plain PyTorch version for a CPU tensor; there is no
flag that picks the plain version on the card.
"""
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rglru import rglru_scan
from repro_torch.kernels.wkv6 import wkv6

__all__ = ["flash_attention", "decode_attention", "rglru_scan", "wkv6"]
