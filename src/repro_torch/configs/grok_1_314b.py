"""grok-1-314b — MoE, 8 experts top-2. [hf:xai-org/grok-1]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    activation="gelu",
    gated_mlp=True,
    num_experts=8,
    experts_per_token=2,
    source="hf:xai-org/grok-1",
)
