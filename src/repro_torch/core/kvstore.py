"""Context KV-cache store with a pluggable replacement policy — the port's
copy of the scalar path of ``repro.core.kvstore.KVStore``.

Entries are keyed by context id and hold the KV cache of that context's
token prefix. ``lookup`` implements token-prefix matching: a hit returns the
entry, whose reusable tokens are ``min(entry.num_tokens, query)``.

Only what real execution needs is kept: ``lookup``, ``reusable_tokens``,
``insert`` and policy-ordered eviction through a stable ``sorted`` over the
entries in insertion order, so victims leave in the same order as the
reference's scalar path. The columnar index, admission gate, storage tiers,
gradual resize, tier weights, fixed-size (recurrent-state) entries and
radix prefix sharing of the reference stay there.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


@dataclass
class CacheEntry:
    key: str
    num_tokens: int                 # cached context length (tokens)
    size_bytes: float               # KV bytes (num_tokens × kv_bytes/token)
    created_at: float
    last_access: float
    hits: int = 0
    hit_tokens: int = 0             # accumulated tokens served from this entry
    turn: int = 1                   # conversation turn depth (chat tasks)
    payload: Any = None             # real KV tensors (real-execution mode)


@dataclass
class KVStoreStats:
    lookups: int = 0
    hits: int = 0
    hit_tokens: int = 0
    lookup_tokens: int = 0
    insertions: int = 0
    evictions: int = 0
    evicted_bytes: float = 0.0
    written_bytes: float = 0.0      # bytes written into the store (wear clock)


class KVStore:
    def __init__(self, capacity_bytes: float,
                 policy: Callable[[CacheEntry, float], float],
                 kv_bytes_per_token: float):
        self.capacity_bytes = float(capacity_bytes)
        self.policy = policy
        self.kv_bytes_per_token = float(kv_bytes_per_token)
        self.entries: Dict[str, CacheEntry] = {}
        self.used_bytes = 0.0
        self.stats = KVStoreStats()

    # ------------------------------------------------------------------ #
    def lookup(self, key: str, context_tokens: int, now: float
               ) -> Optional[CacheEntry]:
        """Prefix lookup: returns the entry if present (hit), updating
        hit statistics. Reusable tokens = min(entry.num_tokens, query)."""
        self.stats.lookups += 1
        self.stats.lookup_tokens += context_tokens
        e = self.entries.get(key)
        if e is None:
            return None
        reused = min(e.num_tokens, context_tokens)
        e.hits += 1
        e.hit_tokens += reused
        e.last_access = now
        self.stats.hits += 1
        self.stats.hit_tokens += reused
        return e

    def reusable_tokens(self, key: str, context_tokens: int) -> int:
        e = self.entries.get(key)
        return min(e.num_tokens, context_tokens) if e else 0

    # ------------------------------------------------------------------ #
    def insert(self, key: str, num_tokens: int, now: float, *,
               turn: int = 1, payload: Any = None) -> Optional[CacheEntry]:
        """Insert/extend the cache entry for ``key`` with a prefix of
        ``num_tokens`` tokens. Evicts per policy to fit; returns the entry
        (None if it cannot fit even after eviction)."""
        size = num_tokens * self.kv_bytes_per_token
        if size > self.capacity_bytes:
            return None
        old = self.entries.get(key)
        delta = size - (old.size_bytes if old else 0.0)
        if delta > 0:
            self._make_room(delta, now, protect=key)
            if self.used_bytes + delta > self.capacity_bytes + 1e-6:
                return None
        if old:
            if delta > 0:       # entries only grow (longer prefix cached)
                self.used_bytes += delta
                self.stats.written_bytes += delta
            old.num_tokens = max(old.num_tokens, num_tokens)
            old.size_bytes = max(old.size_bytes, size)
            old.last_access = now
            old.turn = max(old.turn, turn)
            if payload is not None:
                old.payload = payload
            return old
        e = CacheEntry(key=key, num_tokens=num_tokens, size_bytes=size,
                       created_at=now, last_access=now, turn=turn,
                       payload=payload)
        self.entries[key] = e
        self.used_bytes += size
        self.stats.written_bytes += size
        self.stats.insertions += 1
        return e

    # ------------------------------------------------------------------ #
    def _make_room(self, need_bytes: float, now: float,
                   protect: Optional[str] = None):
        if self.used_bytes + need_bytes <= self.capacity_bytes:
            return
        # batch eviction: free an extra ~3% so the O(n log n) sort amortizes
        # over many inserts instead of running per-insert
        slack = max(need_bytes, 0.03 * self.capacity_bytes)
        target = self.capacity_bytes - slack
        victims = sorted(
            (e for k, e in self.entries.items() if k != protect),
            key=lambda e: self.policy(e, now))
        for v in victims:
            if self.used_bytes <= target:
                break
            self._evict(v.key)

    def _evict(self, key: str):
        e = self.entries.pop(key)
        self.used_bytes -= e.size_bytes
        self.stats.evictions += 1
        self.stats.evicted_bytes += e.size_bytes
