"""vLLM-style radix/prefix-tree KV store.

Cache entries are token-*block* nodes in a prefix tree shared across users
and conversations: a request's context arrives as structured prefix
segments (``Request.prefix_blocks`` — system prompt x document x turn
history, outermost first) and ``account`` walks the tree for the longest
matched prefix. Partial hits shorten prefill *proportionally* — the engine
re-prefills only the unmatched suffix, so TTFT and prefill energy scale
with unmatched tokens instead of the whole-context all-or-nothing — and
the insert extends only that suffix, charging the device wear clock for
suffix bytes alone (far fewer redundant writes than re-caching the whole
grown context under a flat key).

Tree mechanics:

- every node is a :class:`RadixEntry` (a ``CacheEntry``): it lives in
  ``self.entries`` under its full path key (block keys joined with ``/``),
  so the columnar eviction index, the LCS policies and the byte accounting
  of the base store apply unchanged, node-granular;
- ``refcount`` is the number of live children. Eviction is leaf-first
  refcount-aware LRU: only ``refcount == 0`` nodes are evictable, interior
  nodes become evictable as their subtrees drain, so evicting a shared
  node can never orphan a live child;
- ``pop_entry`` on an interior node swaps in a zero-byte *stub* that keeps
  the subtree linked (ring migration moves nodes one at a time, in any
  order); ``adopt`` re-creates missing ancestors as stubs and fills a stub
  in place when the real node arrives. ``owner_key`` maps every node to
  its root block, so the consistent-hash ring migrates trees whole;
- with ``blocks=None`` (exact-key mode) every operation delegates to the
  flat ``KVStore`` path — the store bit-reproduces the whole-context
  hit/eviction/TTFT trajectory (regression row in
  ``benchmarks/prefix_sharing.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Set

from repro_torch.core.kvstore import (MISS_INSERTED, MISS_REJECTED, MISS_TOO_LARGE,
                                AccountResult, CacheEntry, HitKind, KVStore,
                                PrefixBlocks)

#: path-key separator: block keys must not contain it
SEP = "/"


@dataclass(eq=False)
class RadixEntry(CacheEntry):
    """A token-block node of the prefix tree.

    ``key`` is the full path (ancestor block keys joined with ``/``) so the
    flat ``entries`` dict, the eviction index and migration stay keyed the
    same way as a whole-context store; ``block_key`` is the last segment
    (the edge label from ``parent``)."""
    block_key: str = ""
    parent: Optional["RadixEntry"] = field(default=None, repr=False)
    children: Dict[str, "RadixEntry"] = field(default_factory=dict,
                                              repr=False)
    refcount: int = 0           # live children; > 0 pins against eviction
    stub: bool = False          # zero-byte linkage placeholder (migration)


class RadixKVStore(KVStore):
    """Prefix-tree ``CacheStore``: longest-prefix ``account`` over
    structured blocks, suffix-only wear, leaf-first refcount-aware LRU."""

    def __init__(self, capacity_bytes: float,
                 policy: Callable[[CacheEntry, float], float],
                 kv_bytes_per_token: float):
        super().__init__(capacity_bytes, policy, kv_bytes_per_token)
        # first-level nodes by root block key (tree entry point; shares the
        # key namespace of ``entries`` — root path key == root block key)
        self.root: Dict[str, RadixEntry] = {}

    # --- CacheStore behaviour probes ---------------------------------- #
    @property
    def prefix_aware(self) -> bool:
        return True

    def owner_key(self, key: str) -> str:
        return key.split(SEP, 1)[0]

    # ------------------------------------------------------------------ #
    def account(self, key: str, context_tokens: int, prompt_tokens: int,
                now: float, turn: int = 1, collect_stats: bool = True,
                blocks: Optional[PrefixBlocks] = None,
                weight: float = 1.0) -> AccountResult:
        """Longest-prefix match + suffix insert.

        With ``blocks=None`` this is exactly the flat whole-context path
        (``KVStore.account``). With blocks, the walk matches them in order
        against the tree; every matched node is refreshed (hit counters,
        LRU clock, eviction index) and the unmatched suffix is inserted as
        a chain of new leaf nodes — wear is charged for suffix bytes only.
        The admission gate is consulted only on a cold start (no matched
        prefix): a matched prefix is demonstrated reuse.

        Returns reused tokens >= 0 with ``HitKind.HIT`` (full path match)
        or ``HitKind.PARTIAL`` (suffix re-prefilled); misses keep the flat
        sentinels (-1 inserted / -2 no-fit / -3 admission-reject)."""
        if blocks is None:
            return super().account(key, context_tokens, prompt_tokens, now,
                                   turn, collect_stats, weight=weight)
        if self._resize_steps and now >= self._resize_steps[0][0]:
            self._apply_due_resizes(now)
        ix = self._ix
        # ---- longest-prefix walk ----
        matched = 0
        node: Optional[RadixEntry] = None
        children = self.root
        depth = 0
        path: List[RadixEntry] = []
        for bk, _bt in blocks:
            nxt = children.get(bk)
            if nxt is None or nxt.stub:
                break
            node = nxt
            matched += nxt.num_tokens
            path.append(nxt)
            children = nxt.children
            depth += 1
        reused = min(matched, context_tokens)
        partial = depth < len(blocks)
        if collect_stats:
            st = self.stats
            st.lookups += 1
            st.lookup_tokens += context_tokens
            if path:
                st.hits += 1
                st.hit_tokens += reused
                if partial:
                    st.partial_hits += 1
        for nd in path:
            nd.hits += 1
            nd.hit_tokens += nd.num_tokens
            nd.last_access = now
            if weight > nd.weight:      # a gold hit promotes shared nodes
                nd.weight = weight
                if ix is not None:
                    ix.write_weight(nd)
            if ix is not None:
                ix.write_hit(nd)
        if not partial:
            return AccountResult(reused, HitKind.HIT, reused)
        suffix = blocks[depth:]
        if not path and self.admission is not None:
            suffix_bytes = sum(bt for _, bt in suffix) \
                * self.kv_bytes_per_token
            if not self.admission.admit(self, suffix_bytes, turn=turn):
                self.stats.admit_rejects += 1
                return MISS_REJECTED
        made = self._insert_suffix(node, suffix, now, turn, collect_stats,
                                   weight=weight)
        if path:
            return AccountResult(reused, HitKind.PARTIAL, reused)
        return MISS_INSERTED if made else MISS_TOO_LARGE

    def _insert_suffix(self, parent: Optional[RadixEntry],
                       suffix: PrefixBlocks, now: float, turn: int,
                       collect_stats: bool, weight: float = 1.0) -> int:
        """Insert the unmatched suffix as a chain of nodes under ``parent``
        (suffix-only wear: only these bytes touch the write clock). Stops
        at the first block that cannot fit — inserting deeper would orphan.
        Returns the number of nodes created/filled."""
        cap = self.capacity_bytes
        bpt = self.kv_bytes_per_token
        ix = self._ix
        protect: Set[str] = set()
        p = parent
        while p is not None:            # matched path must survive eviction
            protect.add(p.key)
            p = p.parent
        made = 0
        for bk, bt in suffix:
            children = parent.children if parent is not None else self.root
            existing = children.get(bk)
            if existing is not None and not existing.stub:
                # re-joined a live subtree below a filled stub: pure match
                existing.hits += 1
                existing.hit_tokens += existing.num_tokens
                existing.last_access = now
                if weight > existing.weight:
                    existing.weight = weight
                    if ix is not None:
                        ix.write_weight(existing)
                if ix is not None:
                    ix.write_hit(existing)
                protect.add(existing.key)
                parent = existing
                continue
            size = bt * bpt
            if size > cap:
                break
            if existing is not None:
                # a stub about to be filled: eviction of its last child in
                # _make_room would make it collectible mid-operation
                protect.add(existing.key)
            if self.used_bytes + size > cap:
                self._make_room(size, now, protect=protect)
                if self.used_bytes + size > cap + 1e-6:
                    break
            if existing is not None:        # fill a migration stub in place
                existing.num_tokens = bt
                existing.size_bytes = size
                existing.last_access = now
                existing.turn = max(existing.turn, turn)
                existing.stub = False
                if weight > existing.weight:
                    existing.weight = weight
                    if ix is not None:
                        ix.write_weight(existing)
                if ix is not None:
                    ix.write_grow(existing)
                node = existing
            else:
                node = RadixEntry(
                    key=bk if parent is None else parent.key + SEP + bk,
                    num_tokens=bt, size_bytes=size, created_at=now,
                    last_access=now, turn=turn, weight=weight,
                    block_key=bk, parent=parent)
                self._attach(node)
                if ix is not None:
                    ix.add(node)
            self.used_bytes += size
            self.stats.written_bytes += size
            if collect_stats:
                self.stats.insertions += 1
            protect.add(node.key)
            parent = node
            made += 1
        return made

    # ---- tree linkage ------------------------------------------------- #
    def _attach(self, node: RadixEntry):
        if node.parent is None:
            self.root[node.block_key] = node
        else:
            node.parent.children[node.block_key] = node
            node.parent.refcount += 1
        self.entries[node.key] = node

    def _detach(self, node: RadixEntry):
        if node.parent is None:
            self.root.pop(node.block_key, None)
        else:
            if node.parent.children.pop(node.block_key, None) is not None:
                node.parent.refcount -= 1
            node.parent = None

    # ---- leaf-first eviction ------------------------------------------ #
    def _evict(self, key: str):
        e = self.entries.get(key)
        if isinstance(e, RadixEntry):
            self._detach(e)
        super()._evict(key)

    @staticmethod
    def _as_protect(protect) -> Set[str]:
        if protect is None:
            return set()
        if isinstance(protect, (set, frozenset)):
            return protect
        return {protect}

    def _make_room(self, need_bytes: float, now: float, protect=None):
        if self.used_bytes + need_bytes <= self.capacity_bytes:
            return
        slack = max(need_bytes, 0.03 * self.capacity_bytes)
        self._evict_leaves_to(self.capacity_bytes - slack, now,
                              self._as_protect(protect))

    def _shrink_to(self, capacity_bytes: float, now: float):
        self.capacity_bytes = float(capacity_bytes)
        if self.used_bytes > self.capacity_bytes:
            self._evict_cause = "resize"
            try:
                self._evict_leaves_to(self.capacity_bytes, now, set())
            finally:
                self._evict_cause = "capacity"

    def _evict_pass(self, victims: Iterable[CacheEntry], target: float,
                    protect: Set[str]) -> int:
        n = 0
        for v in victims:
            if self.used_bytes <= target:
                break
            if getattr(v, "refcount", 0) or v.key in protect:
                continue            # interior / protected: not a leaf yet
            if self.entries.get(v.key) is not v:
                continue            # already evicted in this pass
            self._evict(v.key)
            n += 1
        return n

    def _evict_leaves_to(self, target: float, now: float,
                         protect: Set[str]):
        """Leaf-first refcount-aware eviction: walk the policy's global
        eviction order, skipping interior nodes; parents that become
        leaves are caught on the next pass. Terminates when the target is
        reached or a full pass frees nothing (everything left is protected
        or pinned by live children)."""
        while self.used_bytes > target:
            victims, partial = self._victims_sorted(
                now, deficit_bytes=self.used_bytes - target)
            n = self._evict_pass(victims, target, protect)
            if partial and self.used_bytes > target:
                victims, _ = self._victims_sorted(now)
                n += self._evict_pass(victims, target, protect)
            if n == 0:
                return

    # ---- ring migration ----------------------------------------------- #
    def pop_entry(self, key: str) -> CacheEntry:
        """Donor half of a migration. Popping an interior node swaps in a
        zero-byte stub that keeps its children linked — the subtree stays
        consistent while nodes move one at a time."""
        e = self.entries.get(key)
        if not isinstance(e, RadixEntry):
            return super().pop_entry(key)
        self.entries.pop(key)
        self.used_bytes -= e.size_bytes
        if self._ix is not None:
            self._ix.remove(e)
        if e.refcount:
            stub = RadixEntry(
                key=e.key, num_tokens=0, size_bytes=0.0,
                created_at=e.created_at, last_access=e.last_access,
                turn=e.turn, block_key=e.block_key, parent=e.parent,
                stub=True)
            stub.children = e.children
            stub.refcount = e.refcount
            for ch in stub.children.values():
                ch.parent = stub
            e.children = {}
            e.refcount = 0
            if stub.parent is None:
                self.root[stub.block_key] = stub
            else:
                stub.parent.children[stub.block_key] = stub
            self.entries[key] = stub
            if self._ix is not None:
                self._ix.add(stub)
            e.parent = None
            return e
        self._detach(e)
        return e

    def adopt(self, entry: CacheEntry, now: float) -> bool:
        """Receiver half of a migration: re-create missing ancestors as
        zero-byte stubs, fill a stub in place when the real node arrives,
        and adopt the node's bytes (migration writes wear, as in the flat
        store). Returns False when the node cannot fit — it is dropped (a
        cold start); any stub ancestors created stay linked and are
        reclaimed by eviction once childless."""
        if not isinstance(entry, RadixEntry):
            return super().adopt(entry, now)
        if entry.stub:
            return True         # nothing to move: linkage is re-created
        size = entry.size_bytes
        if size > self.capacity_bytes:
            return False
        parts = entry.key.split(SEP)
        parent: Optional[RadixEntry] = None
        children = self.root
        protect: Set[str] = set()
        prefix = ""
        for bk in parts[:-1]:
            prefix = bk if not prefix else prefix + SEP + bk
            nd = children.get(bk)
            if nd is None:
                nd = RadixEntry(key=prefix, num_tokens=0, size_bytes=0.0,
                                created_at=now, last_access=now,
                                block_key=bk, parent=parent, stub=True)
                self._attach(nd)
                if self._ix is not None:
                    self._ix.add(nd)
            protect.add(nd.key)
            parent = nd
            children = nd.children
        bk = parts[-1]
        existing = children.get(bk)
        if existing is not None and not existing.stub:
            # re-cached while the migration was in flight: the incoming
            # copy supersedes it (a stub remains if it had children)
            self.pop_entry(existing.key)
            existing = children.get(bk)
        if existing is not None:
            protect.add(existing.key)
        if self.used_bytes + size > self.capacity_bytes:
            self._make_room(size, now, protect=protect)
            if self.used_bytes + size > self.capacity_bytes + 1e-6:
                return False
        if existing is not None:
            # transplant the stub's children onto the incoming node
            entry.children = existing.children
            entry.refcount = existing.refcount
            for ch in entry.children.values():
                ch.parent = entry
            existing.children = {}
            existing.refcount = 0
            self._detach(existing)
            self.entries.pop(existing.key)
            if self._ix is not None:
                self._ix.remove(existing)
        entry.parent = parent
        self._attach(entry)
        self.used_bytes += size
        self.stats.written_bytes += size     # migration writes wear too
        if self._ix is not None:
            self._ix.add(entry)
        return True
