"""rwkv6-1.6b (Finch) — attention-free RNN with data-dependent decay,
token-shift, and matrix-valued WKV state. [arXiv:2404.05892]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=0,                # attention-free
    num_kv_heads=0,
    head_dim=0,
    d_ff=7168,
    vocab_size=65536,
    activation="relu2",         # rwkv channel-mix uses squared relu
    gated_mlp=False,
    rwkv_head_dim=64,
    source="arXiv:2404.05892",
)
