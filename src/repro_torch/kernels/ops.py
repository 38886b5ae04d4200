"""Public kernel entry points, under the names of ``repro.kernels.ops``,
``rglru_step``, the RG-LRU decode step with its elementwise chain fused
(the reference leaves that step to XLA, ``repro/models/griffin.py``), and
``flash_attention_bwd``, ``wkv6_bwd`` and ``rglru_scan_bwd``, the gradients
of ``flash_attention``, ``wkv6`` and ``rglru_scan`` (the reference takes
them by autodiff; each forward calls its backward from autograd).

The model code calls only these. Each runs its hand-written CUDA kernel for
a CUDA tensor and its plain PyTorch version for a CPU tensor; there is no
flag that picks the plain version on the card.

``flash_attention_train`` (the forward's output with each row's logsumexp,
as ``flash_attention``'s autograd saves them for the backward) and
``wkv6_train`` (``wkv6``'s output with the state's checkpoints) are not in
``__all__``: their launches count in ``flash_attention.launches`` and
``wkv6.launches``.
"""
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                 flash_attention_train)
from repro_torch.kernels.rglru import rglru_scan, rglru_scan_bwd, rglru_step
from repro_torch.kernels.wkv6 import wkv6, wkv6_bwd, wkv6_train

__all__ = ["flash_attention", "flash_attention_bwd", "decode_attention", "rglru_scan",
           "rglru_scan_bwd", "rglru_step", "wkv6", "wkv6_bwd"]
