"""The port on the card: each CUDA kernel against its plain PyTorch version,
and the reduced engine on the card against the same engine on the CPU.

Every test here carries the ``gpu`` marker and skips, inside the ``cuda``
fixture, when there is no card. The file imports no jax, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cases, ops
from repro_torch.launch import serve

FLASH_CASES = cases.FLASH_SWEEP + cases.FLASH_RAGGED + cases.FLASH_EMPTY_BAND
DECODE_CASES = cases.DECODE_SWEEP + cases.DECODE_RAGGED


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, dtype, case):
    n = ops.flash_attention.launches
    cases.check_flash(case, dtype, cuda)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == n + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_kernel_matches_plain_on_strided_cache(cuda, dtype, case):
    n = ops.decode_attention.launches
    cases.check_decode(case, dtype, cuda)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == n + 1


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.gpu
def test_reduced_engine_on_card_matches_cpu(cuda):
    cfg, on_cpu = serve.build_engine("yi-6b", device="cpu", reduced=True)
    _, on_card = serve.build_engine("yi-6b", device=cuda, reduced=True,
                                    params=_to(on_cpu.params, cuda))
    _, c1, c2 = serve.two_turns(cfg, on_cpu, True)
    f0, d0 = ops.flash_attention.launches, ops.decode_attention.launches
    _, g1, g2 = serve.two_turns(cfg, on_card, True)
    num_new = serve.REDUCED_TURNS[2]
    assert ops.flash_attention.launches - f0 == 2 * cfg.num_layers
    assert ops.decode_attention.launches - d0 == 2 * num_new * cfg.num_layers
    for c, g in ((c1, g1), (c2, g2)):
        assert (g.tokens, g.reused_tokens) == (c.tokens, c.reused_tokens)
        np.testing.assert_allclose(g.last_logits.cpu().numpy(),
                                   c.last_logits.numpy(), atol=3e-4, rtol=3e-4)
