"""nemotron-4-15b — dense GQA with squared-ReLU MLP. [arXiv:2402.16819]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    activation="relu2",
    gated_mlp=False,
    source="arXiv:2402.16819",
)
