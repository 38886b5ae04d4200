"""recurrentgemma-2b — Griffin hybrid: RG-LRU recurrent blocks + local
attention, ratio 1 attn : 2 recurrent. 26 layers = 8×(rec,rec,attn) + 2 rec.
[arXiv:2402.19427]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,             # MQA
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    activation="gelu",
    gated_mlp=True,
    griffin=True,
    rnn_width=2560,
    conv_width=4,
    local_window=2048,
    source="arXiv:2402.19427",
)
