"""qwen2-vl-2b — VLM language backbone with M-RoPE (temporal/h/w rotary
sections) and dynamic-resolution vision tokens. The ViT encoder + projector is
a stub: a batch carries precomputed patch embeddings (``patches``) and their
M-RoPE position ids (``positions``). [arXiv:2409.12191; copy of
``repro/configs/qwen2_vl_2b.py``, lines 7-22]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    activation="silu",
    gated_mlp=True,
    mrope=True,
    vision_tokens=1024,
    source="arXiv:2409.12191",
)
