"""Cache replacement policy (paper §5.5): the scalar LCS score of
``repro.core.policies``.

Score = priority to KEEP; eviction removes the lowest-scoring entries.

LCS (Least Carbon Savings, Eq. 7):     (#Token · #Hit) / (Size · Age)

The chat and document variants and the baselines (FIFO, LRU, LFU) arrive
with the slice that needs them.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.core.kvstore import CacheEntry

EPS = 1e-9


def _age(e: CacheEntry, now: float) -> float:
    return max(now - e.created_at, 1.0)


def lcs_score(e: CacheEntry, now: float) -> float:
    """Generic LCS (Eq. 7)."""
    return (e.hit_tokens * max(e.hits, 1)) / (e.size_bytes * _age(e, now) + EPS)


POLICIES: Dict[str, Callable[[CacheEntry, float], float]] = {
    "lcs": lcs_score,
}
