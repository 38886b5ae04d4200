"""Context KV-cache store (LMCache-style) with resizable capacity and
pluggable replacement policy.

Entries are keyed by context id (conversation id or document id) and hold the
KV cache of that context's token prefix. ``lookup`` implements token-prefix
matching: a hit returns the number of reusable cached tokens (the entry may
hold fewer tokens than the query prefix — partial hit).

The store tracks everything the LCS policy (paper Eq. 7–9) needs: hit counts,
accumulated hit tokens, entry size, age, conversation turn.

``payload`` optionally holds the *real* KV of the prefix (real-execution mode:
``repro_torch.serving.realexec`` stores the prefix's tensors and restores them
on hit); the simulation mode leaves it None and accounts bytes analytically.
The store itself is host NumPy code and never touches a tensor.
"""
from __future__ import annotations

import enum
import warnings
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Protocol, Sequence,
                    Tuple, runtime_checkable)

import numpy as np

TB = 1e12

#: structured prefix segments: ``((block_key, num_tokens), ...)`` covering a
#: request's reusable context, outermost (system prompt) first. Prefix-aware
#: stores (``repro_torch.core.radix.RadixKVStore``) match/extend these against a
#: radix tree; whole-context stores ignore them and key on ``key`` alone.
PrefixBlocks = Sequence[Tuple[str, int]]


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
    # eviction-priority multiplier (tier-aware caching: a gold tenant's
    # working set outscores scavenger churn under a ``tier_weighted``
    # policy). 1.0 = neutral — every legacy path leaves it there.
    weight: float = 1.0
    payload: Any = None             # optional real KV arrays
    slot: int = -1                  # columnar-index slot (vector-evict mode)
    # storage tier: 1 = the authoritative cold/bulk tier (every entry a
    # plain store creates); a TieredKVStore moves mirrored copies to 0
    tier: int = 1


@dataclass
class KVStoreStats:
    lookups: int = 0
    hits: int = 0
    hit_tokens: int = 0
    lookup_tokens: int = 0
    insertions: int = 0
    evictions: int = 0
    evicted_bytes: float = 0.0
    # device wear clock: host bytes written into the store (new entries,
    # entry growth, migration adoptions — evictions are discards and write
    # nothing). Monotone; the window delta over wall time is the write
    # rate that shortens an endurance-limited device's effective lifetime
    # (repro_torch.core.storage.StorageDevice.effective_lifetime_s).
    written_bytes: float = 0.0
    # inserts refused by a write-aware admission policy (expected reuse
    # does not amortize the write energy + wear)
    admit_rejects: int = 0
    # prefix-aware stores only: hits whose matched prefix was shorter than
    # the request's block path (the unmatched suffix was re-prefetched).
    # Every partial hit is also counted in ``hits``.
    partial_hits: int = 0
    # eviction attribution (observability): why each eviction happened —
    # "capacity" (policy made room for an insert/adoption), "resize"
    # (the controller shrank the allocation), "rebalance" (ring resize
    # cold-dropped a reassigned key), "failure" (the entries died with
    # their replica).  Counts sum to ``evictions``.
    evicted_by_cause: Dict[str, int] = field(default_factory=dict)

    def count_eviction(self, cause: str, n: int = 1):
        self.evicted_by_cause[cause] = \
            self.evicted_by_cause.get(cause, 0) + n

    @property
    def token_hit_rate(self) -> float:
        """Paper's hit-rate definition: reused tokens / total input tokens."""
        return self.hit_tokens / self.lookup_tokens if self.lookup_tokens else 0.0

    @property
    def request_hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0


class HitKind(enum.Enum):
    """What ``CacheStore.account`` did with the request's context."""
    HIT = "hit"                  # whole context served from cache
    PARTIAL = "partial"          # prefix matched, unmatched suffix inserted
    MISS = "miss"                # nothing matched; new entry/suffix inserted
    TOO_LARGE = "too_large"      # miss and the context cannot fit at all
    REJECTED = "rejected"        # miss and the admission gate refused it


class AccountResult(int):
    """``CacheStore.account`` return value.

    Subclasses ``int`` with the legacy sentinel encoding — reused tokens
    (>= 0) on a hit, -1 miss-inserted, -2 no-fit, -3 admission-reject — so
    every existing comparison, ``np.fromiter(..., np.int64)`` conversion and
    batched-stats decode keeps working unchanged, while carrying an explicit
    :class:`HitKind` plus the matched-token count (which the int encoding
    cannot express for partial prefix hits, where tokens were matched *and*
    a suffix was inserted)."""

    kind: HitKind
    matched_tokens: int

    def __new__(cls, code: int, kind: HitKind,
                matched_tokens: int = 0) -> "AccountResult":
        self = super().__new__(cls, code)
        self.kind = kind
        self.matched_tokens = matched_tokens
        return self

    @property
    def is_hit(self) -> bool:
        return self.kind is HitKind.HIT or self.kind is HitKind.PARTIAL

    def __repr__(self) -> str:
        return (f"AccountResult({int(self)}, HitKind.{self.kind.name}, "
                f"matched_tokens={self.matched_tokens})")


# miss results carry no per-request payload: share the singletons
MISS_INSERTED = AccountResult(-1, HitKind.MISS)
MISS_TOO_LARGE = AccountResult(-2, HitKind.TOO_LARGE)
MISS_REJECTED = AccountResult(-3, HitKind.REJECTED)


@runtime_checkable
class CacheStore(Protocol):
    """The store contract the serving engines program against.

    ``KVStore`` (flat whole-context), ``repro_torch.core.storage.TieredKVStore``
    (DRAM mirror over bulk) and ``repro_torch.core.radix.RadixKVStore`` (prefix
    tree) all implement it. Engines must not ``isinstance``/attribute-sniff
    concrete store classes: behaviour differences are exposed as protocol
    members (``is_tiered``, ``prefix_aware``, ``spec``,
    ``drain_io_energy_j``, ``owner_key``, ``clone_empty``)."""

    capacity_bytes: float
    used_bytes: float
    kv_bytes_per_token: float
    entries: Dict[str, CacheEntry]
    stats: KVStoreStats
    admission: Any          # optional WriteAwareAdmission gate (None = all)
    spec: Any               # optional StorageSpec backing the store

    def lookup(self, key: str, context_tokens: int, now: float
               ) -> Optional[CacheEntry]: ...

    def reusable_tokens(self, key: str, context_tokens: int) -> int: ...

    def insert(self, key: str, num_tokens: int, now: float, *,
               turn: int = 1, payload: Any = None,
               size_bytes: Optional[float] = None,
               weight: float = 1.0) -> Optional[CacheEntry]: ...

    def account(self, key: str, context_tokens: int, prompt_tokens: int,
                now: float, turn: int = 1, collect_stats: bool = True,
                blocks: Optional[PrefixBlocks] = None,
                weight: float = 1.0) -> AccountResult: ...

    def pop_entry(self, key: str) -> CacheEntry: ...

    def adopt(self, entry: CacheEntry, now: float) -> bool: ...

    def schedule_resize(self, capacity_bytes: float, now: float,
                        ramp_s: float, steps: int = 4) -> None: ...

    def resize(self, capacity_bytes: float, now: float) -> None: ...

    def enable_vector_evict(self) -> bool: ...

    def owner_key(self, key: str) -> str: ...

    def clone_empty(self, capacity_bytes: float) -> "CacheStore": ...

    def drain_io_energy_j(self) -> float: ...

    @property
    def is_tiered(self) -> bool: ...

    @property
    def prefix_aware(self) -> bool: ...

    @property
    def used_tb(self) -> float: ...

    @property
    def capacity_tb(self) -> float: ...

    def __len__(self) -> int: ...


class _ColumnIndex:
    """Columnar mirror of ``CacheEntry`` fields for batch-eviction scoring.

    Columns live in ``array.array('d')`` buffers: scalar writes from the
    per-request hot path cost ~a list store (no NumPy boxing), while a
    scoring pass gets zero-copy float64 views via ``np.frombuffer``. Scores
    are one vectorized expression over the active slots, ordered by
    ``lexsort((seq, score))`` — ``seq`` is the entry creation sequence, so
    tie-breaks match the scalar path's stable sort in dict insertion order.
    Field values stay exactly representable in float64 at simulation
    magnitudes, so vector scores match the scalar policy bit-for-bit.

    ``order_by`` supports partial selection: with ``need_hint`` victims
    expected, it ``argpartition``s the smallest ~2x hint by score and sorts
    only entries scoring at or below that boundary — every entry scoring
    strictly inside the boundary is included, so the returned sequence is
    exactly the global eviction-order prefix (the caller falls back to a
    full sort if it runs off the end)."""

    FIELDS = ("created_at", "last_access", "size_bytes",
              "hits", "hit_tokens", "num_tokens", "turn", "weight")

    def __init__(self, entries=(), cap: int = 1024):
        import array
        self._next_seq = 0
        self.cap = max(cap, 16)
        self.cols: Dict[str, "array.array"] = {
            f: array.array("d", bytes(8 * self.cap)) for f in self.FIELDS}
        self.seq = np.zeros(self.cap, dtype=np.int64)
        self.active = np.zeros(self.cap, dtype=bool)
        self.ents: List[Optional[CacheEntry]] = [None] * self.cap
        self.free: List[int] = list(range(self.cap - 1, -1, -1))
        for e in entries:           # dict order -> insertion-order sequence
            self.add(e)

    def _grow(self):
        cap = self.cap
        for col in self.cols.values():
            col.frombytes(bytes(8 * cap))       # append cap zeros
        self.seq = np.concatenate([self.seq, np.zeros(cap, dtype=np.int64)])
        self.active = np.concatenate([self.active,
                                      np.zeros(cap, dtype=bool)])
        self.ents.extend([None] * cap)
        self.free.extend(range(2 * cap - 1, cap - 1, -1))
        self.cap = 2 * cap

    def add(self, e: "CacheEntry"):
        if not self.free:
            self._grow()
        s = self.free.pop()
        e.slot = s
        self.ents[s] = e
        self.active[s] = True
        self.seq[s] = self._next_seq
        self._next_seq += 1
        c = self.cols
        c["created_at"][s] = e.created_at
        c["last_access"][s] = e.last_access
        c["size_bytes"][s] = e.size_bytes
        c["hits"][s] = e.hits
        c["hit_tokens"][s] = e.hit_tokens
        c["num_tokens"][s] = e.num_tokens
        c["turn"][s] = e.turn
        c["weight"][s] = e.weight

    def write_weight(self, e: "CacheEntry"):
        self.cols["weight"][e.slot] = e.weight

    def write_hit(self, e: "CacheEntry"):
        c = self.cols
        s = e.slot
        c["hits"][s] = e.hits
        c["hit_tokens"][s] = e.hit_tokens
        c["last_access"][s] = e.last_access

    def write_grow(self, e: "CacheEntry"):
        c = self.cols
        s = e.slot
        c["num_tokens"][s] = e.num_tokens
        c["size_bytes"][s] = e.size_bytes
        c["last_access"][s] = e.last_access
        c["turn"][s] = e.turn

    def remove(self, e: "CacheEntry"):
        s = e.slot
        if s >= 0:
            self.active[s] = False
            self.ents[s] = None
            self.free.append(s)
        e.slot = -1

    def order_by(self, vector_policy: Callable, now: float,
                 skip: Optional["CacheEntry"] = None,
                 need_hint: Optional[int] = None
                 ) -> Tuple[List["CacheEntry"], bool]:
        """Entries in eviction order; second element is True when the list
        is a (exact-prefix) partial selection rather than the full order."""
        idx = np.nonzero(self.active)[0]
        if skip is not None and skip.slot >= 0:
            idx = idx[idx != skip.slot]
        m = len(idx)
        if not m:
            return [], False
        fields = {f: np.frombuffer(col, dtype=np.float64,
                                   count=self.cap)[idx]
                  for f, col in self.cols.items()}
        scores = vector_policy(fields, now)
        partial = False
        sel = np.arange(m)
        if need_hint is not None:
            k = 2 * need_hint + 8
            if 2 * k < m:
                part = np.argpartition(scores, k)[:k + 1]
                thresh = scores[part].max()
                sel = np.nonzero(scores <= thresh)[0]
                partial = len(sel) < m
        sub_scores = scores[sel]
        order = np.lexsort((self.seq[idx[sel]], sub_scores))
        ents = self.ents
        return [ents[i] for i in idx[sel[order]].tolist()], partial


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
        self._vector_policy = None
        self._ix: Optional["_ColumnIndex"] = None
        # pending gradual-shrink steps: [(due_time, capacity_bytes), ...]
        # ascending; consumed lazily by account() as simulated time passes
        self._resize_steps: List[Tuple[float, float]] = []
        # optional write-aware admission gate (repro_torch.core.storage
        # .WriteAwareAdmission): None = admit everything (seed behaviour)
        self.admission = None
        # storage spec backing this store (repro_torch.core.storage.StorageSpec);
        # None = the legacy flat-SSD model priced from HardwareSpec scalars
        self.spec = None

    def enable_vector_evict(self) -> bool:
        """Switch eviction scoring to the policy's vectorized twin (see
        ``repro_torch.core.policies.VECTOR_POLICIES``): entry fields are mirrored
        into a columnar index kept up to date on every lookup/insert, so a
        batch eviction is one NumPy scoring pass instead of a Python-callback
        sort — same victims in the same order (lexsort on score + insertion
        sequence == the scalar path's stable sort in dict order). No-op
        (returns False) if the policy has no registered twin."""
        from repro_torch.core.policies import VECTOR_POLICIES
        vp = VECTOR_POLICIES.get(self.policy)
        if vp is None:
            self._vector_policy = None
            self._ix = None
            return False
        if self._vector_policy is not vp or self._ix is None:
            self._vector_policy = vp
            self._ix = _ColumnIndex(self.entries.values())
        return True

    def _victims_sorted(self, now: float, protect=None,
                        deficit_bytes: Optional[float] = None):
        """Entries in ascending keep-priority (eviction order); returns
        ``(victims, partial)`` where ``partial`` means the list is an exact
        prefix of the full order (vector path, sized from the byte deficit)
        and the caller must re-request the full order if it runs dry."""
        if self._vector_policy is None:
            return sorted(
                (e for k, e in self.entries.items() if k != protect),
                key=lambda e: self.policy(e, now)), False
        prot = self.entries.get(protect) if protect is not None else None
        hint = None
        if deficit_bytes is not None and self.entries:
            avg = self.used_bytes / len(self.entries)
            hint = int(deficit_bytes / max(avg, 1.0)) + 1
        return self._ix.order_by(self._vector_policy, now, skip=prot,
                                 need_hint=hint)

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
        if self._ix is not None:
            self._ix.write_hit(e)
        self.stats.hits += 1
        self.stats.hit_tokens += reused
        return e

    def reusable_tokens(self, key: str, context_tokens: int) -> int:
        e = self.entries.get(key)
        return min(e.num_tokens, context_tokens) if e else 0

    # ------------------------------------------------------------------ #
    def insert(self, key: str, num_tokens: int, now: float, *,
               turn: int = 1, payload: Any = None,
               size_bytes: Optional[float] = None,
               weight: float = 1.0) -> Optional[CacheEntry]:
        """Insert/extend the cache entry for ``key`` with a prefix of
        ``num_tokens`` tokens. Evicts per policy to fit; returns the entry
        (None if it cannot fit even after eviction). ``size_bytes`` overrides
        the token-proportional size (state-snapshot entries of recurrent
        archs have constant size). ``weight`` sets the entry's eviction
        weight (an entry keeps the highest weight it has been touched
        with — a gold hit promotes a scavenger-inserted prefix)."""
        size = size_bytes if size_bytes is not None \
            else num_tokens * self.kv_bytes_per_token
        if size > self.capacity_bytes:
            return None
        old = self.entries.get(key)
        if old is None and self.admission is not None \
                and not self.admission.admit(self, size, turn=turn):
            self.stats.admit_rejects += 1
            return None
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
            if weight > old.weight:
                old.weight = weight
                if self._ix is not None:
                    self._ix.write_weight(old)
            if self._ix is not None:
                self._ix.write_grow(old)
            return old
        e = CacheEntry(key=key, num_tokens=num_tokens, size_bytes=size,
                       created_at=now, last_access=now, turn=turn,
                       weight=weight, payload=payload)
        self.entries[key] = e
        self.used_bytes += size
        self.stats.written_bytes += size
        if self._ix is not None:
            self._ix.add(e)
        self.stats.insertions += 1
        return e

    # ------------------------------------------------------------------ #
    def account(self, key: str, context_tokens: int, prompt_tokens: int,
                now: float, turn: int = 1, collect_stats: bool = True,
                blocks: Optional[PrefixBlocks] = None,
                weight: float = 1.0) -> AccountResult:
        """Fused ``lookup`` + ``insert`` for the simulation hot path: one
        dict probe per request instead of two calls. State transitions are
        identical to ``lookup(key, context_tokens, now)`` followed by
        ``insert(key, prompt_tokens, now, turn=turn)`` — an eviction
        triggered by the grow scores entries post-lookup/pre-grow, exactly
        as in the two-call sequence.

        Returns an :class:`AccountResult` — int-compatible with the legacy
        sentinel encoding (reused tokens >= 0 on hit, -1 on miss with a new
        entry inserted, -2 on miss where the entry could not fit, -3 on a
        miss whose insert the write-aware admission policy refused) plus an
        explicit :class:`HitKind` and matched-token count. With
        ``collect_stats=False`` the per-request ``stats`` updates are
        skipped so a batch caller can apply them in one shot from the
        encoded return values (see ``ClusterEngine._account``).

        ``blocks`` (structured prefix segments) is accepted for protocol
        uniformity and ignored: a whole-context store keys on ``key``
        alone. ``RadixKVStore`` overrides this to prefix-match them."""
        if self._resize_steps and now >= self._resize_steps[0][0]:
            self._apply_due_resizes(now)
        ix = self._ix
        cap = self.capacity_bytes
        e = self.entries.get(key)
        size = prompt_tokens * self.kv_bytes_per_token
        if e is not None:
            reused = min(e.num_tokens, context_tokens)
            e.hits += 1
            e.hit_tokens += reused
            e.last_access = now
            if weight > e.weight:       # promote, never demote
                e.weight = weight
                if ix is not None:
                    ix.write_weight(e)
            if collect_stats:
                st = self.stats
                st.lookups += 1
                st.lookup_tokens += context_tokens
                st.hits += 1
                st.hit_tokens += reused
            if ix is not None:
                ix.write_hit(e)     # hit updates visible to any eviction sort
            if size > cap:
                return AccountResult(reused, HitKind.HIT, reused)
            delta = size - e.size_bytes
            if delta > 0:
                if self.used_bytes + delta > cap:   # _make_room early-exit,
                    self._make_room(delta, now, protect=key)   # inlined
                    if self.used_bytes + delta > cap + 1e-6:
                        return AccountResult(reused, HitKind.HIT, reused)
                self.used_bytes += delta
                self.stats.written_bytes += delta
            self._grow_entry(e, prompt_tokens, size, now, turn)
            if ix is not None:
                ix.write_grow(e)
            return AccountResult(reused, HitKind.HIT, reused)
        if collect_stats:
            st = self.stats
            st.lookups += 1
            st.lookup_tokens += context_tokens
        if size > cap:
            return MISS_TOO_LARGE
        if self.admission is not None \
                and not self.admission.admit(self, size, turn=turn):
            self.stats.admit_rejects += 1
            return MISS_REJECTED
        if size > 0 and self.used_bytes + size > cap:
            self._make_room(size, now, protect=key)
            if self.used_bytes + size > cap + 1e-6:
                return MISS_TOO_LARGE
        e = CacheEntry(key=key, num_tokens=prompt_tokens, size_bytes=size,
                       created_at=now, last_access=now, turn=turn,
                       weight=weight)
        self.entries[key] = e
        self.used_bytes += size
        self.stats.written_bytes += size
        if ix is not None:
            ix.add(e)
        if collect_stats:
            self.stats.insertions += 1
        return MISS_INSERTED

    def account_legacy(self, key: str, context_tokens: int,
                       prompt_tokens: int, now: float, turn: int = 1,
                       collect_stats: bool = True) -> int:
        """Deprecated pre-``HitKind`` spelling returning the bare sentinel
        int. ``account`` itself now returns an int-compatible
        :class:`AccountResult`, so callers can (and should) just call it
        directly — this shim exists only for out-of-tree code pinned to the
        plain-``int`` annotation."""
        warnings.warn(
            "KVStore.account_legacy() is deprecated; account() returns an "
            "int-compatible AccountResult (HitKind + matched tokens)",
            DeprecationWarning, stacklevel=2)
        return int(self.account(key, context_tokens, prompt_tokens, now,
                                turn, collect_stats))

    @staticmethod
    def _grow_entry(e: CacheEntry, prompt_tokens: int, size: float,
                    now: float, turn: int):
        if prompt_tokens > e.num_tokens:
            e.num_tokens = prompt_tokens
        if size > e.size_bytes:
            e.size_bytes = size
        e.last_access = now
        if turn > e.turn:
            e.turn = turn

    # ------------------------------------------------------------------ #
    def _make_room(self, need_bytes: float, now: float,
                   protect: Optional[str] = None):
        if self.used_bytes + need_bytes <= self.capacity_bytes:
            return
        # batch eviction: free an extra ~3% so the O(n log n) sort amortizes
        # over many inserts instead of running per-insert
        slack = max(need_bytes, 0.03 * self.capacity_bytes)
        target = self.capacity_bytes - slack
        victims, partial = self._victims_sorted(
            now, protect=protect, deficit_bytes=self.used_bytes - target)
        for v in victims:
            if self.used_bytes <= target:
                break
            self._evict(v.key)
        if partial and self.used_bytes > target:
            # partial selection ran dry (skewed entry sizes): finish with
            # the full order — already-evicted entries are simply gone, so
            # the combined sequence still matches the scalar path
            victims, _ = self._victims_sorted(now, protect=protect)
            for v in victims:
                if self.used_bytes <= target:
                    break
                self._evict(v.key)

    # eviction-cause attribution: the single ``_evict`` choke point tags
    # each eviction with the store's current cause ("capacity" unless a
    # resize/rebalance/failure path overrides it) — radix and tiered
    # subclasses funnel through here, so the attribution is store-wide
    _evict_cause = "capacity"

    def _evict(self, key: str):
        e = self.entries.pop(key)
        self.used_bytes -= e.size_bytes
        if self._ix is not None:
            self._ix.remove(e)
        self.stats.evictions += 1
        self.stats.evicted_bytes += e.size_bytes
        self.stats.count_eviction(self._evict_cause)

    # ------------------------------------------------------------------ #
    def pop_entry(self, key: str) -> CacheEntry:
        """Remove and return an entry *without* eviction accounting — the
        donor half of a ring-rebalance migration (the KV is not lost, it
        moves to another partition's store)."""
        e = self.entries.pop(key)
        self.used_bytes -= e.size_bytes
        if self._ix is not None:
            self._ix.remove(e)
        return e

    def adopt(self, entry: CacheEntry, now: float) -> bool:
        """Receiver half of a migration: install an entry popped from a
        donor store, evicting per policy to make room.  Hit/insert stats
        are untouched (migration is not a workload event); returns False
        if the entry cannot fit even after eviction (it is then dropped —
        a cold-start for its keys)."""
        size = entry.size_bytes
        if size > self.capacity_bytes:
            return False
        if entry.key in self.entries:
            # the receiver re-cached the context while the migration was
            # in flight: the incoming copy supersedes it (releasing the
            # stale entry's bytes — silently clobbering would leak them)
            self.pop_entry(entry.key)
        self._make_room(size, now, protect=entry.key)
        if self.used_bytes + size > self.capacity_bytes + 1e-6:
            return False
        self.entries[entry.key] = entry
        self.used_bytes += size
        self.stats.written_bytes += size     # migration writes wear too
        if self._ix is not None:
            self._ix.add(entry)
        return True

    # ------------------------------------------------------------------ #
    def schedule_resize(self, capacity_bytes: float, now: float,
                        ramp_s: float, steps: int = 4):
        """Gradual resize: a shrink is staged as ``steps`` equal capacity
        cuts spread over ``ramp_s`` seconds, consumed lazily by
        ``account`` as simulated time passes — entries the instant resize
        would have teleported away keep serving hits until their step
        lands.  Growth (and a zero ramp) applies immediately; a new
        resize/schedule supersedes any pending steps."""
        self._resize_steps = []
        target = float(capacity_bytes)
        if ramp_s <= 0.0 or steps <= 1 or target >= self.capacity_bytes:
            self.resize(target, now)
            return
        caps = np.linspace(self.capacity_bytes, target, steps + 1)[1:]
        due = now + np.linspace(ramp_s / steps, ramp_s, steps)
        self._resize_steps = list(zip(due.tolist(), caps.tolist()))

    def _apply_due_resizes(self, now: float):
        steps = self._resize_steps
        while steps and now >= steps[0][0]:
            t, cap = steps.pop(0)
            self._shrink_to(cap, t)

    def resize(self, capacity_bytes: float, now: float):
        """GreenCache cache manager: shrink evicts lowest-score entries,
        then spare capacity is released (paper §5.5)."""
        self._resize_steps = []
        self._shrink_to(capacity_bytes, now)

    def _shrink_to(self, capacity_bytes: float, now: float):
        self.capacity_bytes = float(capacity_bytes)
        if self.used_bytes > self.capacity_bytes:
            self._evict_cause = "resize"
            try:
                victims, partial = self._victims_sorted(
                    now,
                    deficit_bytes=self.used_bytes - self.capacity_bytes)
                for v in victims:
                    if self.used_bytes <= self.capacity_bytes:
                        break
                    self._evict(v.key)
                if partial and self.used_bytes > self.capacity_bytes:
                    victims, _ = self._victims_sorted(now)
                    for v in victims:
                        if self.used_bytes <= self.capacity_bytes:
                            break
                        self._evict(v.key)
            finally:
                self._evict_cause = "capacity"

    # --- CacheStore behaviour probes ---------------------------------- #
    # (what the engines used to isinstance/attribute-sniff: tiered spec
    # detection, prefix awareness, tier-I/O metering, partition cloning)

    @property
    def is_tiered(self) -> bool:
        """True when the store runs a hot/cold tier pair (TieredKVStore)."""
        return False

    @property
    def prefix_aware(self) -> bool:
        """True when ``account`` prefix-matches structured ``blocks``
        (RadixKVStore); engines then thread per-request prefix segments."""
        return False

    def drain_io_energy_j(self) -> float:
        """Storage I/O energy accumulated since the last drain (J). The
        flat store models no tier I/O; ``TieredKVStore`` meters it."""
        return 0.0

    def owner_key(self, key: str) -> str:
        """The routing identity of an entry key — what the consistent-hash
        ring hashes when deciding which partition owns the entry. Flat
        stores route on the whole key; ``RadixKVStore`` routes every node
        of a prefix tree on its root block so subtrees migrate whole."""
        return key

    def clone_empty(self, capacity_bytes: float) -> "KVStore":
        """An empty store of the same class/policy/geometry — the ring
        rebalance uses this to materialize added partitions."""
        st = type(self)(capacity_bytes, self.policy, self.kv_bytes_per_token)
        st.admission = self.admission
        return st

    # ------------------------------------------------------------------ #
    @property
    def used_tb(self) -> float:
        return self.used_bytes / TB

    @property
    def capacity_tb(self) -> float:
        return self.capacity_bytes / TB

    def __len__(self):
        return len(self.entries)
