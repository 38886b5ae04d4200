"""Model architecture config (copy of ``repro.configs.base.ModelConfig``).

Every field of the reference is kept, ``tie_embeddings`` too (no model
code reads it; ``param_count`` and ``active_param_count``, which the
simulator's ``serving.perfmodel`` reads, do); ``reduced()`` produces the
same smoke-test variant as the reference so that tests can build matching
configs on both sides.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. All sizes are exact per the published
    config; padding (vocab) happens inside the model, never here."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int                   # query heads (0 for attn-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # MLP
    activation: str = "silu"         # silu | gelu | relu2
    gated_mlp: bool = True

    # attention
    rope_theta: float = 10_000.0
    window_size: Optional[int] = None       # sliding window (SWA archs)
    long_context_window: int = 8192         # window used in long_500k mode

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # hybrid (Griffin / RecurrentGemma)
    griffin: bool = False
    rnn_width: int = 0
    conv_width: int = 4
    local_window: int = 2048                # local-attn window in griffin blocks

    # ssm (RWKV6)
    rwkv_head_dim: int = 64

    # enc-dec
    encoder_layers: int = 0
    source_len: int = 1024                  # encoder memory length (stub frontend)

    # vlm
    mrope: bool = False
    vision_tokens: int = 0                  # prefix patch-embedding tokens (stub)

    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    source: str = ""                        # citation

    # ---- derived ----
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128 (same as the reference)."""
        return _round_up(self.vocab_size, 128)

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def num_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def kv_bytes_per_token(self) -> int:
        """bf16 K+V bytes per cached token (dense layers)."""
        if self.attn_free:
            return 0
        return self.num_layers * self.num_kv_heads * self.head_dim * 2 * 2

    @property
    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, L = self.d_model, self.num_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            # tmix ~ 5 d^2 (+ low-rank extras), cmix ~ 2*d*d_ff-ish
            blk = 5 * d * d + 2 * d * self.d_ff
            return emb + L * blk
        attn = d * self.num_heads * self.head_dim * 2 + \
            d * self.num_kv_heads * self.head_dim * 2
        mlp = d * self.d_ff * (3 if self.gated_mlp else 2)
        if self.family == "moe":
            mlp = mlp * self.num_experts + d * self.num_experts
        blk = attn + mlp
        if self.family == "hybrid":
            # 2/3 of layers are RG-LRU blocks (~4 d*rnn) instead of attention
            rec = 4 * d * self.rnn_width
            blk = (attn + mlp + 2 * (rec + mlp)) / 3.0
        total = emb + L * blk
        if self.encoder_layers:
            total += self.encoder_layers * (attn * 1.5 + mlp)  # self+cross attn
        return int(total)

    @property
    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.family != "moe":
            return self.param_count
        d, L = self.d_model, self.num_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * self.num_heads * self.head_dim * 2 + \
            d * self.num_kv_heads * self.head_dim * 2
        mlp = d * self.d_ff * (3 if self.gated_mlp else 2) * self.experts_per_token
        return int(emb + L * (attn + mlp + d * self.num_experts))

    def reduced(self, num_layers: int = 2, d_model: int = 256,
                max_experts: int = 4) -> "ModelConfig":
        """Smoke-test variant: same family/feature-set, tiny dims."""
        heads = 0 if self.attn_free else max(2, min(4, self.num_heads))
        head_dim = d_model // max(heads, 4)
        kv = 0 if self.attn_free else max(1, min(self.num_kv_heads, heads))
        changes = dict(
            num_layers=num_layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=head_dim,
            d_ff=d_model * 2,
            vocab_size=512,
            window_size=64 if self.window_size else None,
            long_context_window=128,
            local_window=32,
            rnn_width=d_model if self.griffin else 0,
            rwkv_head_dim=32,
            encoder_layers=1 if self.encoder_layers else 0,
            source_len=16 if self.encoder_layers else 0,
            vision_tokens=8 if self.vision_tokens else 0,
            num_experts=min(self.num_experts, max_experts) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2)
            if self.experts_per_token else 0,
        )
        return dataclasses.replace(self, **changes)
