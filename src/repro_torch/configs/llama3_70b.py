"""llama3-70b — the paper's primary evaluation model (Meta Llama-3 70B).
[arXiv:2407.21783]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-70b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    activation="silu",
    gated_mlp=True,
    rope_theta=500000.0,
    source="arXiv:2407.21783",
)
