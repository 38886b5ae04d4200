"""Cache replacement policies (paper §5.5).

Score = priority to KEEP; eviction removes the lowest-scoring entries.

LCS (Least Carbon Savings, Eq. 7):     (#Token · #Hit) / (Size · Age)
  chat variant (Eq. 8):                (CurTurn · #AccuToken) / (Size · Age)
  document variant (Eq. 9):            (#Hit · AccuDocLen) / (Size · Age)

Each scalar policy has a vectorized twin in ``VECTOR_POLICIES`` operating on
field arrays (one element per entry, same iteration order); the cluster
engine enables these for batched eviction scoring. A vectorized scorer MUST
produce the same float64 values as its scalar twin so victim selection is
identical (stable argsort == stable ``sorted``).
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from repro_torch.core.kvstore import CacheEntry

EPS = 1e-9


def fifo_score(e: CacheEntry, now: float) -> float:
    return e.created_at                       # oldest evicted first


def lru_score(e: CacheEntry, now: float) -> float:
    return e.last_access


def lfu_score(e: CacheEntry, now: float) -> float:
    return float(e.hits)


def _age(e: CacheEntry, now: float) -> float:
    return max(now - e.created_at, 1.0)


def lcs_score(e: CacheEntry, now: float) -> float:
    """Generic LCS (Eq. 7)."""
    return (e.hit_tokens * max(e.hits, 1)) / (e.size_bytes * _age(e, now) + EPS)


def lcs_chat_score(e: CacheEntry, now: float) -> float:
    """Multi-turn conversation variant (Eq. 8)."""
    return (max(e.turn, 1) * max(e.hit_tokens, e.num_tokens)) \
        / (e.size_bytes * _age(e, now) + EPS)


def lcs_doc_score(e: CacheEntry, now: float) -> float:
    """Document comprehension variant (Eq. 9)."""
    accu_doc_len = e.num_tokens * max(e.hits, 1)
    return (max(e.hits, 1) * accu_doc_len) \
        / (e.size_bytes * _age(e, now) + EPS)


POLICIES: Dict[str, Callable[[CacheEntry, float], float]] = {
    "fifo": fifo_score,
    "lru": lru_score,
    "lfu": lfu_score,
    "lcs": lcs_score,
    "lcs_chat": lcs_chat_score,
    "lcs_doc": lcs_doc_score,
}


# --------------------------------------------------------------------- #
# Vectorized scorers: ``f`` maps field name -> np.ndarray over entries.
# --------------------------------------------------------------------- #
def _v_age(f, now: float) -> np.ndarray:
    return np.maximum(now - f["created_at"], 1.0)


def _v_fifo(f, now):
    return f["created_at"].astype(float)


def _v_lru(f, now):
    return f["last_access"].astype(float)


def _v_lfu(f, now):
    return f["hits"].astype(float)


def _v_lcs(f, now):
    return (f["hit_tokens"] * np.maximum(f["hits"], 1)) \
        / (f["size_bytes"] * _v_age(f, now) + EPS)


def _v_lcs_chat(f, now):
    return (np.maximum(f["turn"], 1)
            * np.maximum(f["hit_tokens"], f["num_tokens"])) \
        / (f["size_bytes"] * _v_age(f, now) + EPS)


def _v_lcs_doc(f, now):
    accu = f["num_tokens"] * np.maximum(f["hits"], 1)
    return (np.maximum(f["hits"], 1) * accu) \
        / (f["size_bytes"] * _v_age(f, now) + EPS)


VECTOR_POLICIES: Dict[Callable, Callable] = {
    fifo_score: _v_fifo,
    lru_score: _v_lru,
    lfu_score: _v_lfu,
    lcs_score: _v_lcs,
    lcs_chat_score: _v_lcs_chat,
    lcs_doc_score: _v_lcs_doc,
}


# --------------------------------------------------------------------- #
# Tier-aware weighting: score × entry.weight — a gold working set
# (weight 4) outranks scavenger churn (weight 0.25) at equal base score,
# so a flash crowd of best-effort traffic cannot flush protected prefixes.
# --------------------------------------------------------------------- #
_TIER_WEIGHTED: Dict[Callable, Callable] = {}


def tier_weighted(base: Callable[[CacheEntry, float], float]) -> Callable:
    """The weight-aware twin of a replacement policy: keep-priority
    becomes ``base(e, now) * e.weight``.  Memoized — the same base policy
    always maps to the same wrapper object, so ``KVStore
    .enable_vector_evict`` finds the registered vectorized twin by
    identity and batch eviction stays bit-identical to the scalar path
    (the vector twin applies the same ``× weight`` in float64)."""
    w = _TIER_WEIGHTED.get(base)
    if w is not None:
        return w

    def weighted(e: CacheEntry, now: float, _base=base) -> float:
        return _base(e, now) * e.weight

    weighted.__name__ = "tier_weighted_" + getattr(base, "__name__",
                                                   "policy")
    _TIER_WEIGHTED[base] = weighted
    vb = VECTOR_POLICIES.get(base)
    if vb is not None:
        VECTOR_POLICIES[weighted] = \
            lambda f, now, _vb=vb: _vb(f, now) * f["weight"]
    return weighted
