"""seamless-m4t-large-v2 — encoder-decoder multimodal (audio) backbone.
24 transformer layers total: 12 encoder + 12 decoder with cross-attention.
The speech frontend (mel-spectrogram + conv feature extractor) is a stub: a
batch carries precomputed frame embeddings (``frames``). [arXiv:2308.11596;
copy of ``repro/configs/seamless_m4t_large_v2.py``, lines 7-22]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=12,              # decoder layers (12 enc + 12 dec = 24L total)
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    activation="gelu",
    gated_mlp=False,
    source_len=1024,            # encoder frames (stub frontend output)
    source="arXiv:2308.11596",
)
