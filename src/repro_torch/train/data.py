"""Synthetic language-modelling data, a copy of ``repro/train/data.py``
(NumPy code, copied rather than imported: the port imports nothing of the
JAX package).

Token streams come from an order-1 Markov chain over the vocabulary with
Zipf-weighted successors, so a small model has real signal to learn (its
loss falls); they are packed into fixed-length (tokens, labels) batches.
Deterministic per seed, and the same arrays as the reference's for the
same config and seed. ``batch_to`` moves a batch to torch on a device.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


class SyntheticCorpus:
    """Order-1 Markov chain over the vocab with Zipf marginals."""

    def __init__(self, vocab_size: int, seed: int = 0, branching: int = 32):
        self.vocab = vocab_size
        rng = np.random.default_rng(seed)
        self.branch = np.minimum(branching, vocab_size)
        # each token transitions to one of `branching` successors
        self.successors = rng.integers(0, vocab_size,
                                       size=(vocab_size, self.branch))
        w = 1.0 / np.arange(1, self.branch + 1) ** 1.1
        self.probs = w / w.sum()

    def stream(self, seed: int) -> Iterator[int]:
        rng = np.random.default_rng(seed)
        tok = int(rng.integers(0, self.vocab))
        while True:
            yield tok
            nxt = rng.choice(self.branch, p=self.probs)
            tok = int(self.successors[tok, nxt])


def batch_iterator(cfg: ModelConfig, batch: int, seq: int, seed: int = 0
                   ) -> Iterator[Dict[str, np.ndarray]]:
    corpus = SyntheticCorpus(cfg.vocab_size, seed)
    streams = [corpus.stream(seed + i) for i in range(batch)]
    while True:
        toks = np.array([[next(s) for _ in range(seq + 1)] for s in streams],
                        dtype=np.int32)
        yield make_batch_for(cfg, toks[:, :-1], toks[:, 1:])


def make_batch_for(cfg: ModelConfig, tokens: np.ndarray,
                   labels: np.ndarray) -> Dict[str, np.ndarray]:
    """Add family extras (stub frontends) to a token batch."""
    B, S = tokens.shape
    batch: Dict[str, np.ndarray] = {"tokens": tokens, "labels": labels}
    rng = np.random.default_rng(int(tokens[0, 0]) + 7)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.source_len, cfg.d_model)).astype(np.float32) * 0.02
    if cfg.family == "vlm":
        V = cfg.vision_tokens
        batch["patches"] = rng.standard_normal(
            (B, V, cfg.d_model)).astype(np.float32) * 0.02
        pos = np.arange(S + V)[None, :, None]
        batch["positions"] = np.broadcast_to(pos, (B, S + V, 3)).astype(
            np.int32).copy()
    return batch


def batch_to(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as torch tensors on ``device``: integer arrays (tokens,
    labels, positions) as int64, the rest as they are (fp32)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                device=device, dtype=torch.int64 if v.dtype.kind in "iu" else None)
            for k, v in batch.items()}
