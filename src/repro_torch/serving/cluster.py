"""Discrete-event multi-replica serving cluster with pluggable routing.

Generalizes the seed single-server ``ServingEngine`` (repro_torch.serving.engine)
to N prefill replicas, each with its own FIFO queue, fed by a router:

  * ``single``       — degenerate 1-replica cluster; bit-identical queueing
                       to the seed engine (parity-tested).
  * ``round_robin``  — request i -> replica i mod N.
  * ``least_loaded`` — join the replica whose queue drains earliest
                       (requires sequential simulation: the decision depends
                       on the evolving backlog).
  * ``cache_affinity`` — consistent-hash ring over context keys so repeated
                       contexts land on the replica that already holds their
                       KV (the only router that preserves hit rates under
                       per-replica cache partitioning).

The KV store is either *shared* (one ``KVStore``, the seed semantics — pass
a single store) or *partitioned* (pass a list of stores, one per replica;
``cache_tb`` stays the cluster-total allocation for embodied accounting).

Event core: instead of the seed's per-request Python loop, the engine
extracts arrival/token arrays once, performs the (unavoidably ordered)
cache-accounting pass as a tight loop of dict operations, and then resolves
each replica's FIFO queue with the vectorized Lindley recurrence

    finish_i = P_i + max(F0, max_{j<=i} (a_j - P_{j-1})),  P = cumsum(service)

via ``np.cumsum`` + ``np.maximum.accumulate``. Decode batching, energy and
carbon are computed on whole arrays. At ``n_replicas=1`` this reproduces the
seed engine's TTFT sequence exactly and runs ~10x faster (the seed spends
most of its time constructing one ``np.random.Generator`` per request).

Heterogeneous fleets: pass ``types=["h100", "a100", ...]`` (one
``repro_torch.core.carbon.ReplicaType`` name per replica) instead of a bare
``n_replicas``. Each replica's prefill compute and decode step scale with
its type's ``perf_scale`` (KV loads stay SSD-bandwidth-bound), energy sums
per-type server power, and embodied compute carbon sums each type's
amortized share. An all-reference-type (``l40``) fleet is bit-identical to
the untyped engine; mixes additionally weight the bounded-load spill caps
and the ``least_loaded`` rule by per-replica capacity.

Resource plans: ``apply(ResourcePlan)`` is the hourly reconfiguration
entry point (returning an ``AppliedTransition``; the deprecated
``set_replicas``/``set_fleet`` shims still snap instantly),
``make_cluster`` builds an engine from a sized plan (or plan string),
and a *disaggregated* plan (``prefill=`` + ``decode=`` pools) yields a
``DisaggEngine`` — prefill queueing on one typed pool, dedicated
interference-free decode on another, with a per-token KV handoff
between them (see the ``DisaggEngine`` docstring).

Transitions: with a ``repro_torch.core.plan.TransitionConfig`` the engine
simulates reconfiguration over time instead of snapping — booted
replicas join after a per-type warmup (drawing boot power but serving
nothing), drained replicas finish in-flight work powered, partitioned
ring changes rebalance KV (bulk migration or cold misses), cache
shrinks evict gradually — and ``apply`` prices the event (boot + drain
+ migration energy, folded into the next window's carbon).
``TransitionConfig.free()`` (and ``transitions=None``) bit-reproduce
the instant-switch trajectories.
"""
from __future__ import annotations

import functools
import hashlib
import heapq
import warnings
import zlib
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.carbon import (CarbonModel, get_replica_type,
                               kv_migration_energy_kwh)
from repro_torch.core.kvstore import CacheStore, KVStore
from repro_torch.core.plan import (UNSET_EPS, PlanTransition, ResourcePlan,
                             TransitionConfig)
from repro_torch.core.radix import RadixKVStore
from repro_torch.core.storage import StorageSpec, TieredKVStore
from repro_torch.serving.engine import SimResult
from repro_torch.serving.perfmodel import ServingModel
from repro_torch.workloads.tenants import DEFAULT_TIER, tier_spec

ROUTERS = ("single", "round_robin", "least_loaded", "cache_affinity")

_VNODES = 128         # virtual nodes per replica on the consistent-hash ring
_U64 = 1 << 64


def _stable_hash(key: str) -> int:
    """Process-stable 64-bit key hash (builtin ``hash`` is salted per run):
    crc32 pushed through the splitmix64 finalizer so key hashes cover the
    whole u64 ring domain (a bare multiplicative scramble of a 32-bit value
    tops out at ~0.62*2^64, starving the upper ring arc of keys)."""
    h = zlib.crc32(key.encode())
    h = (h ^ (h >> 30)) * 0xbf58476d1ce4e5b9 % _U64
    h = (h ^ (h >> 27)) * 0x94d049bb133111eb % _U64
    return h ^ (h >> 31)


def _point_hash(label: str) -> int:
    """Ring-point hash: blake2b gives far better vnode dispersion than
    crc32, which clusters the short ``replica-r#vn`` labels."""
    return int.from_bytes(hashlib.blake2b(label.encode(),
                                          digest_size=8).digest(), "big")


class HashRing:
    """Consistent-hash ring with virtual nodes; replica sets can grow or
    shrink without remapping more than ~1/N of the key space."""

    def __init__(self, n_replicas: int, vnodes: int = _VNODES):
        points = []
        owners = []
        for r in range(n_replicas):
            for v in range(vnodes):
                points.append(_point_hash(f"replica-{r}#vn{v}"))
                owners.append(r)
        order = np.argsort(points, kind="stable")
        self.points = np.asarray(points, dtype=np.uint64)[order]
        self.owners = np.asarray(owners, dtype=np.int64)[order]

    def owner(self, key: str) -> int:
        i = int(np.searchsorted(self.points,
                                np.uint64(_stable_hash(key)))) \
            % len(self.points)
        return int(self.owners[i])

    def owners_of(self, hashes: np.ndarray) -> np.ndarray:
        idx = np.searchsorted(self.points, hashes) % len(self.points)
        return self.owners[idx]


@functools.lru_cache(maxsize=128)
def hash_ring(n_replicas: int, vnodes: int = _VNODES) -> HashRing:
    """Shared, cached ring per replica count: ring construction (N·vnodes
    blake2b hashes + a sort) dominates repeated ``apply`` calls in
    day-scale sweeps, and rings are immutable after construction so every
    engine at the same count can share one instance."""
    ring = HashRing(n_replicas, vnodes)
    ring.points.setflags(write=False)       # shared: guard against mutation
    ring.owners.setflags(write=False)
    return ring


def _sim_priority(a: np.ndarray, s: np.ndarray, p: np.ndarray,
                  pre: np.ndarray, free0: float,
                  on_preempt=None):
    """Single-replica priority queue for a multi-tier request stream:
    the server always picks the lowest ``p`` (ties FIFO by arrival), a
    non-preemptible job in service runs to completion, and a
    *preemptible* (scavenger) job is interrupted the moment any
    higher-priority request arrives — its remaining work re-enters the
    heap under its original arrival index, so it resumes FIFO within
    its class (preempt-resume, no work lost).

    ``a`` must be arrival-sorted (the router preserves order within a
    replica).  Returns ``(server_free_time, finish_times)`` with finish
    times indexed like ``a``.  This replaces the vectorized Lindley
    recurrence only when a stream actually mixes tiers — with a single
    tier the two agree mathematically but round differently, so the
    caller gates on tier diversity to keep legacy runs bit-identical."""
    n = len(a)
    fin = np.empty(n)
    rem = s.astype(float).copy()
    al = a.tolist()
    heap: list = []          # (priority, arrival index)
    t = float(free0)
    i = 0                    # next un-enqueued arrival
    done = 0
    while done < n:
        if not heap:
            t = max(t, al[i])
            while i < n and al[i] <= t:
                heapq.heappush(heap, (int(p[i]), i))
                i += 1
            continue
        pr, j = heapq.heappop(heap)
        end = t + float(rem[j])
        if pre[j]:
            preempted = False
            while i < n and al[i] < end:
                if int(p[i]) < pr:   # higher priority: seize the server
                    rem[j] = end - al[i]
                    t = al[i]
                    heapq.heappush(heap, (int(p[i]), i))
                    i += 1
                    heapq.heappush(heap, (pr, j))
                    preempted = True
                    if on_preempt is not None:
                        # flight recorder: (when, which request, work left)
                        on_preempt(t, j, float(rem[j]))
                    break
                heapq.heappush(heap, (int(p[i]), i))
                i += 1
            if preempted:
                continue
        else:
            while i < n and al[i] <= end:
                heapq.heappush(heap, (int(p[i]), i))
                i += 1
        t = end
        fin[j] = end
        done += 1
    return t, fin


@dataclass
class AppliedTransition:
    """What ``ClusterEngine.apply``/``DisaggEngine.apply`` actually did:
    the plan diff plus the measured costs of executing it.  The energy is
    also accumulated on the engine and folded into the next simulation
    window (so its operational carbon is priced at that window's CI)."""
    transition: PlanTransition
    energy_kwh: float = 0.0            # boot + drain + migration I/O
    boot_s: float = 0.0                # longest warmup among booted replicas
    drain_s: float = 0.0               # summed drained-but-powered seconds
    migrated_bytes: float = 0.0        # KV moved between partitioned stores
    dropped_keys: int = 0              # entries cold-dropped by a rebalance

    @property
    def is_noop(self) -> bool:
        return self.transition.is_noop and self.energy_kwh == 0.0


class ClusterEngine:
    """N-replica prefill cluster + analytically coupled decode.

    ``stores``: a single ``CacheStore`` (shared across replicas) or a list
    of per-replica stores (``len == n_replicas``; router should be
    ``cache_affinity`` for the partitioned mode to retain hits).  Any
    ``CacheStore`` implementation works — flat ``KVStore``, tiered, or
    prefix-aware ``RadixKVStore``; behaviour is detected through the
    protocol (``is_tiered``/``prefix_aware``), never by class.
    """

    def __init__(self, model: ServingModel,
                 stores: Union[CacheStore, Sequence[CacheStore]],
                 carbon: CarbonModel, *,
                 n_replicas: int = 1, router: str = "single",
                 balance_eps: Optional[float] = 0.15,
                 types: Optional[Sequence[str]] = None,
                 transitions: Optional[TransitionConfig] = None,
                 wear_aware: bool = True,
                 tier_weights: Optional[Dict[str, float]] = None):
        if router not in ROUTERS:
            raise ValueError(f"unknown router {router!r}; one of {ROUTERS}")
        self.model = model
        self.carbon = carbon
        self.balance_eps = balance_eps
        self.transitions = transitions
        self.wear_aware = wear_aware
        # tier-aware eviction weights ({tier: weight}): the account paths
        # stamp each request's tier weight onto the entries it touches,
        # for stores running a ``tier_weighted`` policy.  None (default)
        # keeps every account call byte-for-byte identical to the
        # weightless path.
        self.tier_weights = dict(tier_weights) if tier_weights else None
        self._pending_kwh = 0.0        # transition energy awaiting a window
        # flight recorder (repro_torch.obs.trace.TraceRecorder): attached by the
        # controller (or directly) to record per-request span rows.  None
        # (the default) skips every recording branch — the bit-identity
        # contract.  ``obs_region`` labels this engine's rows/events in
        # geo-distributed runs.
        self.recorder = None
        self.obs_region = ""
        self._last_ret = None          # recorder-only: last account codes
        self._last_hit_tier = None     # recorder-only: tiered hit tiers
        if types is not None:
            types = [str(t) for t in types]
            for t in types:
                get_replica_type(t)
            if not isinstance(stores, (list, tuple)) and n_replicas != 1 \
                    and n_replicas != len(types):
                raise ValueError("n_replicas must match len(types)")
            n_replicas = len(types)
        if not isinstance(stores, (list, tuple)):
            # a single CacheStore (any implementation) is shared across
            # replicas; a list/tuple is one partition per replica
            self.shared = True
            self.stores = [stores]
            if int(n_replicas) < 1:
                raise ValueError("n_replicas must be >= 1")
            self.n_replicas = int(n_replicas)
        else:
            self.shared = False
            self.stores = list(stores)
            if n_replicas not in (1, len(self.stores)):
                raise ValueError("n_replicas must match len(stores)")
            self.n_replicas = len(self.stores)
        if types is not None and len(types) != self.n_replicas:
            raise ValueError("len(types) must match the replica count")
        if router == "single" and self.n_replicas != 1:
            raise ValueError("router='single' requires n_replicas=1")
        self.router = router
        # typed storage: the store(s) may carry a StorageSpec (set by
        # make_cluster / the TieredKVStore constructor).  storage=None is
        # the legacy flat-SSD model — every new code path below is gated
        # on it, so the seed trajectories stay bit-identical.  Behaviour
        # detection goes through the CacheStore protocol (``spec``,
        # ``is_tiered``, ``prefix_aware``), never concrete store classes.
        self.storage: Optional[StorageSpec] = next(
            (st.spec for st in self.stores if st.spec is not None), None)
        self._tiered = self.stores[0].is_tiered
        # prefix-aware store(s): the account path threads each request's
        # structured prefix segments, so partial hits shorten prefill
        self._prefix = all(st.prefix_aware for st in self.stores)
        if self.storage is not None and not self.shared:
            raise ValueError("typed storage (StorageSpec) supports the "
                             "shared-store mode only")
        # effective KV-load bandwidth of the bulk tier (equals the
        # serving model's ssd_read_gbps for the legacy/flat-default path);
        # _kv_degrade < 1 models an injected SSD fault (×1.0 is bit-exact,
        # so the healthy path is unchanged)
        self._kv_degrade = 1.0
        self._kv_gbps = (model.ssd_read_gbps if self.storage is None
                         else self.storage.cold.dev.read_gbps) \
            * self._kv_degrade
        self._set_types(types)
        for st in self.stores:      # batched eviction scoring (same victims)
            st.enable_vector_evict()
        self._free = [0.0] * self.n_replicas
        self._ring = hash_ring(self.n_replicas) \
            if router == "cache_affinity" else None
        self._rr_next = 0

    def _set_types(self, types: Optional[Sequence[str]]):
        """Install the per-replica type list and derived capacity arrays.
        ``_hetero`` is True only for a *mixed* fleet — uniform fleets keep
        the unscaled code paths (and their bit-exact parity) whenever the
        uniform scale is 1."""
        self.types = list(types) if types is not None else None
        if self.types is None:
            self._scales = np.ones(self.n_replicas)
        else:
            self._scales = np.array(
                [get_replica_type(t).perf_scale for t in self.types])
        self._hetero = self.types is not None \
            and len(set(self.types)) > 1
        self._uniform_scale = float(self._scales[0]) if not self._hetero \
            else None

    # ------------------------------------------------------------------ #
    @property
    def total_replicas(self) -> int:
        """All replicas across pools (``DisaggEngine`` adds its decode
        pool; a fused cluster has only the one pool)."""
        return self.n_replicas

    @property
    def store(self) -> CacheStore:
        """Shared-mode store (seed-engine compatibility accessor)."""
        if not self.shared:
            raise AttributeError("partitioned cluster has no single store")
        return self.stores[0]

    def _store_for(self, key: str) -> CacheStore:
        if self.shared:
            return self.stores[0]
        return self.stores[self._ring.owner(key) if self._ring is not None
                           else _stable_hash(key) % self.n_replicas]

    # ------------------------------------------------------------------ #
    def current_plan(self, cache_tb: Optional[float] = None
                     ) -> ResourcePlan:
        """The live configuration as a ``ResourcePlan``.  ``cache_tb``
        defaults to the actual cluster-total store allocation, so
        ``apply(current_plan())`` is a no-op transition."""
        if cache_tb is None:
            cache_tb = self._live_alloc_tb()
        fleet = tuple(self.types) if self.types is not None \
            else ("l40",) * self.n_replicas
        return ResourcePlan.single(cache_tb, fleet=fleet,
                                   router=self.router,
                                   balance_eps=self.balance_eps,
                                   partitioned=not self.shared,
                                   storage=self._live_storage(cache_tb))

    def defer_energy_kwh(self, kwh: float):
        """Fold externally-caused energy (cross-region KV migration I/O,
        priced by the geo router) into the next simulated window — the
        same deferred-accounting path plan transitions use, so the
        carbon lands at the window's CI."""
        self._pending_kwh += float(kwh)

    def _live_alloc_tb(self) -> float:
        """Live total allocation: store capacity, plus the DRAM mirror
        tier for an (inclusive) tiered store — the mirror is allocated
        on top of the authoritative cold capacity."""
        tb = sum(st.capacity_bytes for st in self.stores) / 1e12
        if self.storage is not None and self.storage.is_tiered:
            tb += self.storage.hot.capacity_tb
        return tb

    def _live_storage(self, cache_tb: float) -> Optional[StorageSpec]:
        """The engine's storage spec reconciled to the live allocation —
        mid-ramp the cold capacity lags the spec, and a plan must stay
        internally consistent."""
        if self.storage is None:
            return None
        if abs(self.storage.total_tb - cache_tb) <= 1e-9:
            return self.storage
        if self.storage.is_tiered:
            from dataclasses import replace as _rep
            hot = self.storage.hot
            cold = max(cache_tb - hot.capacity_tb, 0.0)
            return StorageSpec((hot, _rep(self.storage.cold,
                                          capacity_tb=cold)))
        return self.storage.scaled_to(cache_tb)

    def apply(self, plan: ResourcePlan, *, now: float = 0.0
              ) -> AppliedTransition:
        """Reconfigure the live cluster from a ``ResourcePlan`` — the
        hourly-controller entry point, subsuming the deprecated
        ``set_replicas``/``set_fleet`` pair — and return the
        ``AppliedTransition`` describing what changed and what it cost.

        Without a ``TransitionConfig`` (``transitions=None``, the
        legacy default) the change is instantaneous and free: the fleet
        is swapped wholesale (replicas keep their backlogs positionally;
        a shrink drops the longest queues, new replicas join idle), the
        store(s) snap to the plan's ``cache_tb``, and partitioned-store
        clusters refuse to change fleet size.

        With a config, the transition is simulated over time: booting
        replicas join the serving set only after their warmup latency
        (drawing boot power but serving nothing — their clock starts at
        ``now + boot_s``), draining replicas finish their in-flight
        backlog powered, partitioned-store ring changes rebalance KV
        (bulk migration over ``kv_transfer_gbps`` with added donor load,
        or cold-start misses on reassigned keys, per
        ``TransitionConfig.rebalance``), and cache shrinks evict
        gradually over ``cache_ramp_s``.  Transition energy accumulates
        on the engine and is folded into the next ``run`` window.
        ``TransitionConfig.free()`` bit-reproduces the legacy path."""
        if plan.is_disaggregated:
            raise ValueError("fused cluster cannot apply a disaggregated "
                             "plan; build a DisaggEngine for prefill/decode "
                             "pools")
        pool = plan.serve
        self._apply_pool_knobs(pool)
        tr = PlanTransition.diff(self.current_plan(), plan)
        applied = AppliedTransition(tr)
        cfg = self.transitions
        if cfg is None or (cfg.is_free and (self.shared or
                           len(pool.fleet) == self.n_replicas)):
            # legacy instant path (instant-and-free, bit-reproduced)
            if list(pool.fleet) != self.types:
                self._apply_fleet(pool.fleet)
            self._resize_cache(plan.cache_tb, now, storage=plan.storage)
            return applied
        applied.energy_kwh += self.carbon.transition_energy_kwh(
            tr, boot_latency_s=cfg.boot_latency_s)      # boot draw
        self._transition_pool(pool, tr, now, applied)
        self._resize_cache(plan.cache_tb, now,
                           ramp_s=cfg.cache_ramp_s,
                           steps=cfg.cache_ramp_steps,
                           storage=plan.storage)
        self._pending_kwh += applied.energy_kwh
        return applied

    def _transition_pool(self, pool, tr: PlanTransition, now: float,
                         applied: AppliedTransition):
        """Execute the store-owning pool's fleet change under the
        transition model: per-type survivor matching (the busiest
        same-type replicas drain, the least-loaded keep their backlog),
        booted replicas' clocks start after warmup, and partitioned
        stores rebalance when the ring resizes."""
        cfg = self.transitions
        fleet = list(pool.fleet)
        delta = tr.pool(pool.role)
        if delta is None:                       # same multiset: (re)type
            if fleet != self.types:
                self._set_types(fleet)
            return
        old_types = self.types if self.types is not None \
            else ["l40"] * self.n_replicas
        clocks = defaultdict(list)
        for t, f in zip(old_types, self._free):
            clocks[t].append(f)
        for t in clocks:
            clocks[t].sort()                    # shortest backlogs survive
        new_free = []
        for t in fleet:
            if clocks[t]:
                new_free.append(clocks[t].pop(0))
            else:
                b = cfg.boot_s(t)
                new_free.append(now + b)
                applied.boot_s = max(applied.boot_s, b)
        if cfg.drain:
            # drained replicas stay powered until their backlog clears
            for t, rem in clocks.items():
                rt = get_replica_type(t)
                for f in rem:
                    d = max(f - now, 0.0)
                    applied.drain_s += d
                    applied.energy_kwh += rt.idle_energy_kwh(d)
        n_new = len(fleet)
        if not self.shared and n_new != self.n_replicas:
            self._rebalance_stores(n_new, now, new_free, applied)
        self._free = new_free
        self.n_replicas = n_new
        if self.router == "single" and n_new > 1:
            self.router = "round_robin"
        if self._ring is not None:
            self._ring = hash_ring(n_new)
        self._set_types(fleet)

    def _rebalance_stores(self, n_new: int, now: float,
                          new_free: List[float],
                          applied: AppliedTransition):
        """Partitioned-store ring resize: every cached entry whose owner
        changes under the new ring (consistent hashing moves only
        ~|m-n|/max(m,n) of the key space) is either bulk-migrated to its
        new partition — bytes over the KV interconnect, transfer time
        added to the donor replica's clock (or the receiver's when the
        donor is leaving) — or dropped cold (``rebalance="cold"``:
        reassigned keys miss and re-prefill)."""
        cfg = self.transitions
        n_old = len(self.stores)
        total_cap = sum(st.capacity_bytes for st in self.stores)
        ref = self.stores[0]
        per = total_cap / n_new
        new_ring = hash_ring(n_new) if self._ring is not None else None
        if n_new > n_old:
            # clone through the protocol so a radix partition grows radix
            # partitions (same policy/admission, empty tree)
            added = [ref.clone_empty(per) for _ in range(n_new - n_old)]
            for st in added:
                if ref._vector_policy is not None:
                    st.enable_vector_evict()
            new_stores = self.stores + added
        else:
            new_stores = self.stores[:n_new]
        # collect moves against the *current* placement (the store index
        # is the old owner) before any store shrinks.  Ownership hashes
        # ``owner_key`` — the prefix *root* for a radix store — so a
        # shared subtree never straddles two partitions after a resize.
        moves = []                              # (old_k, new_k, key)
        for k, st in enumerate(self.stores):
            for key in st.entries:
                ok = st.owner_key(key)
                nk = int(new_ring.owner(ok)) if new_ring is not None \
                    else _stable_hash(ok) % n_new
                if nk != k:
                    moves.append((k, nk, key))
        # capacity growth is free and must land before adoption (a ring
        # shrink widens the survivors); capacity *cuts* wait until the
        # moves have drained the donors — shrinking first would
        # score-evict the very entries migration is about to rehome
        survivors = new_stores[:min(n_old, n_new)]
        for st in survivors:
            if per > st.capacity_bytes:
                st.resize(per, now)
        gbps = cfg.kv_transfer_gbps \
            if cfg.kv_transfer_gbps is not None \
            else self.model.kv_transfer_gbps
        cold = cfg.rebalance == "cold"
        for k, nk, key in moves:
            if key not in self.stores[k].entries:
                continue    # evicted by an earlier adoption's make-room
            entry = self.stores[k].pop_entry(key)
            if cold:
                st = self.stores[k]
                st.stats.evictions += 1
                st.stats.evicted_bytes += entry.size_bytes
                st.stats.count_eviction("rebalance")
                applied.dropped_keys += 1
                continue
            applied.migrated_bytes += entry.size_bytes
            if not cfg.is_free:
                # donor pays the read+send; a departing donor's load
                # lands on the receiver instead
                new_free[k if k < n_new else nk] += \
                    entry.size_bytes / (gbps * 1e9)
            if not new_stores[nk].adopt(entry, now):
                # the bytes are gone for real: account like an eviction
                # (cold mode does) so store stats stay comparable
                self.stores[k].stats.evictions += 1
                self.stores[k].stats.evicted_bytes += entry.size_bytes
                self.stores[k].stats.count_eviction("rebalance")
                applied.dropped_keys += 1
        if applied.migrated_bytes > 0.0 and not cfg.is_free:
            applied.energy_kwh += kv_migration_energy_kwh(
                applied.migrated_bytes, gbps)
        for st in survivors:
            if st.capacity_bytes != per:
                st.resize(per, now)
        self.stores = new_stores

    def _apply_pool_knobs(self, pool):
        """Routing knobs of the store-owning pool: the router and store
        topology are fixed at construction (mismatch raises); the
        bounded-load spill factor is a per-window parameter and is
        adopted from the plan."""
        if pool.router is not None and pool.router != self.router:
            raise ValueError(f"plan router {pool.router!r} != engine "
                             f"router {self.router!r} (routers are fixed "
                             "at construction)")
        engine_partitioned = not self.shared
        if pool.partitioned != engine_partitioned \
                and (engine_partitioned or pool.n_replicas > 1):
            raise ValueError("plan store partitioning does not match the "
                             "engine (re-sharding is not modeled)")
        if pool.balance_eps is not UNSET_EPS:
            self.balance_eps = pool.balance_eps

    def _resize_cache(self, cache_tb: Optional[float], now: float, *,
                      ramp_s: float = 0.0, steps: int = 4,
                      storage: Optional[StorageSpec] = None):
        """Snap (``ramp_s=0``, the legacy path) or gradually shrink the
        store(s) to the plan's allocation — staged evictions spread over
        the ramp window instead of teleporting capacity away.  A typed
        plan also moves the tier boundary (``storage``): the hot/cold
        split snaps (demotions are cheap hot-side I/O, accounted by the
        store), the *total* rides the same gradual ramp — tier resizes
        are priced by the transition machinery like any other cache
        move."""
        if storage is not None:
            if self.storage is None:
                raise ValueError("plan carries typed storage but the "
                                 "engine was built without a StorageSpec")
            self._check_storage_compat(storage)
        elif self.storage is not None and cache_tb is not None:
            # untyped resize of a typed engine: rescale tiers in place
            storage = self.storage.scaled_to(cache_tb)
        if cache_tb is None:
            if storage is None:
                return
            cache_tb = storage.total_tb
        if storage is not None:
            self.storage = storage
            self._kv_gbps = storage.cold.dev.read_gbps * self._kv_degrade
            if self._tiered:
                self.stores[0].apply_spec(storage, now, ramp_s=ramp_s,
                                          steps=steps)
                return
        per = cache_tb * 1e12 if self.shared \
            else cache_tb * 1e12 / len(self.stores)
        for st in self.stores:
            if ramp_s > 0.0:
                st.schedule_resize(per, now, ramp_s, steps=steps)
            else:
                st.resize(per, now=now)
            if storage is not None:
                st.spec = storage

    def _check_storage_compat(self, storage: StorageSpec):
        """Store topology is fixed for the day: tier count and device
        classes may not change between hourly plans (only capacities)."""
        if self.storage is None:
            return
        old = [t.device for t in self.storage.tiers]
        new = [t.device for t in storage.tiers]
        if old != new:
            raise ValueError(f"storage tier devices are fixed at "
                             f"construction ({old} != {new}); only tier "
                             "capacities may change hourly")

    def set_replicas(self, n_replicas: int):
        """Deprecated: apply a ``ResourcePlan`` instead. Scales a
        homogeneous *untyped* replica set between simulation windows."""
        warnings.warn("ClusterEngine.set_replicas is deprecated; use "
                      "ClusterEngine.apply(ResourcePlan.single(...))",
                      DeprecationWarning, stacklevel=2)
        if self.types is not None:
            raise ValueError("typed cluster: use apply, not set_replicas")
        n_replicas = int(n_replicas)
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if not self.shared:
            raise ValueError("cannot rescale a partitioned-store cluster")
        if n_replicas == self.n_replicas:
            return
        self._resize_free(n_replicas)
        self.n_replicas = n_replicas
        self._set_types(None)
        if self.router == "single" and n_replicas > 1:
            self.router = "round_robin"
        if self._ring is not None:
            self._ring = hash_ring(n_replicas)

    def set_fleet(self, types: Sequence[str]):
        """Deprecated: apply a ``ResourcePlan`` instead."""
        warnings.warn("ClusterEngine.set_fleet is deprecated; use "
                      "ClusterEngine.apply(ResourcePlan.single(fleet=...))",
                      DeprecationWarning, stacklevel=2)
        self._apply_fleet(types)

    def _apply_fleet(self, types: Sequence[str]):
        """Install an hourly fleet-mix change (shared-store mode only):
        the new fleet replaces the old one wholesale — replicas keep
        their backlogs positionally (sorted busiest-last so a shrink
        drops the longest queues), new replicas join idle."""
        types = [str(t) for t in types]
        if not types:
            raise ValueError("fleet must have at least one replica")
        for t in types:
            get_replica_type(t)
        n_new = len(types)
        if n_new != self.n_replicas:
            if not self.shared:
                raise ValueError("cannot rescale a partitioned-store "
                                 "cluster")
            self._resize_free(n_new)
            self.n_replicas = n_new
            if self._ring is not None:
                self._ring = hash_ring(n_new)
        if self.router == "single" and n_new > 1:
            self.router = "round_robin"
        self._set_types(types)

    def _resize_free(self, n_new: int):
        if n_new > self.n_replicas:
            self._free.extend([0.0] * (n_new - self.n_replicas))
        else:
            self._free = sorted(self._free)[:n_new]

    def reset_clock(self):
        self._free = [0.0] * self.n_replicas

    # ------------------------------------------------------------------ #
    def fail_replica(self, i: int, now: float = 0.0) -> AppliedTransition:
        """Fail-stop loss of replica ``i`` — an *unplanned* availability
        event, unlike ``apply``'s graceful drains.  The member leaves the
        serving set (and the ring) immediately: its backlog is abandoned,
        a partitioned store's entries die with the device (counted in
        ``dropped_keys``), and surviving entries whose keys remap under
        the shrunk ring are orphaned in place — *not* migrated — so they
        cool down and age out (exactly the cold-miss behaviour a real
        fail-stop produces).  The failure itself is free; the carbon bill
        arrives when the controller's next ``apply`` boots replacement
        capacity through the transition machinery.  On a ``DisaggEngine``
        this fails a *prefill* replica (the store-owning pool)."""
        if self.n_replicas <= 1:
            raise ValueError("cannot fail the last replica")
        i = int(i)
        if not 0 <= i < self.n_replicas:
            raise ValueError(f"replica index {i} out of range "
                             f"(n_replicas={self.n_replicas})")
        old = self.current_plan()
        dropped = 0
        if not self.shared:
            dead = self.stores.pop(i)
            dropped = len(dead.entries)
            dead.stats.evictions += dropped
            dead.stats.evicted_bytes += dead.used_bytes
            dead.stats.count_eviction("failure", dropped)
        self._free.pop(i)
        fleet = [t for j, t in enumerate(self.types) if j != i] \
            if self.types is not None else None
        self.n_replicas -= 1
        if self._ring is not None:
            self._ring = hash_ring(self.n_replicas)
        self._set_types(fleet)
        tr = PlanTransition.diff(old, self.current_plan())
        return AppliedTransition(tr, dropped_keys=dropped)

    def set_storage_degradation(self, factor: float):
        """Degrade (or restore, ``factor=1.0``) the bulk KV tier's read
        bandwidth — an injected SSD fault.  Applies to flat-store KV
        loads and the tiered store's cold tier; the DRAM mirror of a
        tiered store is unaffected (that *is* the mitigation)."""
        factor = float(factor)
        if factor <= 0.0:
            raise ValueError("degradation factor must be > 0")
        self._kv_degrade = factor
        self._kv_gbps = (self.model.ssd_read_gbps if self.storage is None
                         else self.storage.cold.dev.read_gbps) * factor

    # ------------------------------------------------------------------ #
    def warm(self, requests: Sequence):
        """Populate the cache(s) without simulating timing; partitioned mode
        routes each context to its owning replica's store (by prefix root
        when structured, matching ``cache_affinity``)."""
        prefix = self._prefix
        tw = self.tier_weights
        if tw is not None:
            for r in requests:
                self._store_for(r.route_key).account(
                    r.context_key, r.context_tokens, r.prompt_tokens,
                    r.arrival, r.turn,
                    blocks=r.prefix_segments if prefix else None,
                    weight=tw.get(r.tier, 1.0))
        elif self.shared:
            acct = self.stores[0].account
            for r in requests:
                acct(r.context_key, r.context_tokens, r.prompt_tokens,
                     r.arrival, r.turn,
                     blocks=r.prefix_segments if prefix else None)
        else:
            for r in requests:
                self._store_for(r.route_key).account(
                    r.context_key, r.context_tokens, r.prompt_tokens,
                    r.arrival, r.turn,
                    blocks=r.prefix_segments if prefix else None)

    # ------------------------------------------------------------------ #
    def run(self, requests: Sequence, *,
            ci_fn: Callable[[float], float], cache_tb: float,
            rate_hint: Optional[float] = None, record: bool = True
            ) -> SimResult:
        """Simulate an arrival-sorted request stream; same contract as the
        seed ``ServingEngine.run``. ``cache_tb`` is the cluster-total SSD
        allocation (embodied carbon accrues on allocation)."""
        m = self.model
        K = self.n_replicas
        n = len(requests)
        if n == 0:
            return SimResult(np.array([]), np.array([]), 0.0, 0.0, 0.0, 0.0,
                             0.0, 0.0, 0.0, 0.0, 0,
                             n_replicas=self.total_replicas)

        arrival = np.fromiter((r.arrival for r in requests), float, count=n)
        ctx = np.fromiter((r.context_tokens for r in requests), np.int64,
                          count=n)
        new = np.fromiter((r.new_tokens for r in requests), np.int64, count=n)
        out = np.fromiter((r.output_tokens for r in requests), np.int64,
                          count=n)
        prompt = ctx + new

        t0 = float(arrival[0])
        self._free = [max(f, t0) for f in self._free]

        # multi-tenant tiers: a stream with >1 distinct tier activates
        # priority queueing (and the gold no-spill routing rule); the
        # ubiquitous single-tier stream keeps the exact Lindley path —
        # the two resolve float rounding differently, so this gate is
        # what preserves bit-reproducibility of legacy trajectories
        tiers_seq = [r.tier for r in requests]
        prio = None
        if len(set(tiers_seq)) > 1:
            prio = np.fromiter((tier_spec(t).priority for t in tiers_seq),
                               np.int64, count=n)
            preempt = np.fromiter(
                (tier_spec(t).preemptible for t in tiers_seq),
                bool, count=n)

        self._mark_wear()
        self._last_ret = None
        self._last_hit_tier = None
        if self.router == "least_loaded":
            assign, reused, ttft, finish_max, kv_load_s = \
                self._run_sequential(requests, arrival, prompt)
            uncached = prompt - reused
        else:
            assign = self._route_static(requests, n, prio)
            if self._tiered:
                reused, kv_load_s = self._account_tiered(
                    requests, assign, arrival, ctx, prompt)
            elif self._prefix:
                # partial hits: reused = longest matched prefix, so the
                # uncached (re-prefilled) fraction — and with it TTFT and
                # prefill energy — scales with unmatched tokens
                reused = self._account_prefix(requests, assign, arrival,
                                              ctx, prompt)
                kv_load_s = reused * m.kv_bytes_per_token \
                    / (self._kv_gbps * 1e9)
            else:
                reused = self._account(requests, assign, arrival, ctx,
                                       prompt)
                # KV loads are bulk-tier-bandwidth-bound (== the serving
                # model's ssd_read_gbps on the legacy/default path, so
                # the untyped engine stays bit-identical)
                kv_load_s = reused * m.kv_bytes_per_token \
                    / (self._kv_gbps * 1e9)
            uncached = prompt - reused
            # per-replica capacity: compute scales with the assigned
            # replica's perf_scale; KV loads stay storage-bound.
            # (x / 1.0 is exact, so a uniform reference fleet keeps bit
            # parity with the untyped engine.)
            service = ((m.prefill_base_s + uncached / m.prefill_tok_per_s)
                       / (self._scales[assign] if self.types is not None
                          else 1.0)
                       + kv_load_s)
            ttft = np.empty(n)
            finish_max = t0
            for k in range(K):
                idx = np.nonzero(assign == k)[0] if K > 1 \
                    else np.arange(n)
                if not len(idx):
                    continue
                a = arrival[idx]
                s = service[idx]
                if prio is not None:
                    cb = None
                    if self.recorder is not None:
                        il = idx.tolist()
                        cb = (lambda t, j, rem, _k=k, _il=il:
                              self.recorder.record_event(
                                  "preempt", t, region=self.obs_region,
                                  replica=_k,
                                  rid=int(requests[_il[j]].rid),
                                  remaining_s=rem))
                    f_last, fin = _sim_priority(a, s, prio[idx],
                                                preempt[idx],
                                                self._free[k],
                                                on_preempt=cb)
                    ttft[idx] = fin - a
                    self._free[k] = f_last
                    finish_max = max(finish_max, f_last)
                    continue
                cs = np.cumsum(s)
                # Lindley recurrence, vectorized: finish_i =
                #   P_i + max(F0, max_{j<=i} (a_j - P_{j-1}))
                base = np.maximum(np.maximum.accumulate(a - (cs - s)),
                                  self._free[k])
                f = cs + base
                ttft[idx] = f - a
                self._free[k] = float(f[-1])
                finish_max = max(finish_max, float(f[-1]))

        return self._finish_run(requests, arrival, out, prompt, reused,
                                uncached, assign, ttft, finish_max, t0,
                                ci_fn=ci_fn, cache_tb=cache_tb,
                                rate_hint=rate_hint, record=record,
                                kv_load_s=kv_load_s)

    # ------------------------------------------------------------------ #
    def _finish_run(self, requests: Sequence, arrival: np.ndarray,
                    out: np.ndarray, prompt: np.ndarray, reused: np.ndarray,
                    uncached: np.ndarray, assign: np.ndarray,
                    ttft: np.ndarray, finish_max: float, t0: float, *,
                    ci_fn: Callable[[float], float], cache_tb: float,
                    rate_hint: Optional[float], record: bool,
                    kv_load_s: Optional[np.ndarray] = None) -> SimResult:
        """Decode coupling + energy/carbon accounting for a *fused* pool
        (prefill and decode share the same replicas — the homogeneous
        engine's semantics, bit-identical to it). ``DisaggEngine`` overrides this with
        the two-pool version."""
        m = self.model
        K = self.n_replicas
        n = len(requests)
        lookup_tokens = int(prompt.sum())
        hit_tokens = int(reused.sum())
        if self._tiered and kv_load_s is not None:
            # per-tier bandwidths: the measured per-request load times
            kv_busy = float(kv_load_s.sum())
        else:
            kv_busy = hit_tokens * m.kv_bytes_per_token \
                / (self._kv_gbps * 1e9)
        if self._hetero:
            # mixed fleet: compute-busy seconds depend on which replica
            # served each request
            compute_s = (m.prefill_base_s + uncached / m.prefill_tok_per_s) \
                / self._scales[assign]
            busy_compute = float(compute_s.sum())
        else:
            # uniform fleet: scalar aggregate (÷1.0 is exact, preserving
            # bit parity with the untyped engine at perf_scale 1)
            busy_compute = float(m.prefill_base_s * n
                                 + (uncached / m.prefill_tok_per_s).sum()) \
                / self._uniform_scale
        busy_prefill = busy_compute + kv_busy

        duration = max(finish_max, float(arrival[-1])) - t0
        prefill_util = min(busy_prefill / max(K * duration, 1e-9), 1.0)

        # decode: per-replica continuous-batching fixed point (each replica
        # sees ~1/K of the arrival stream)
        span = max(float(arrival[-1]) - t0, 1.0)
        lam = (rate_hint if rate_hint else n / span) / K
        out_mean = float(out.mean())
        # decode slowdown vs the reference platform: requests split evenly
        # across replicas, so fleet-average TPOT scales with the mean
        # inverse perf_scale (×1.0 exact for the reference fleet)
        dec_slow = float(np.mean(1.0 / self._scales)) if self._hetero \
            else 1.0 / self._uniform_scale
        # shared fixed point incl. the decode-overload penalty: fused
        # fleets pay real capacity for decode-heavy streams
        tpot, batch = m.decode_fixed_point(lam, out_mean, dec_slow,
                                           prefill_util)
        noise_rng = np.random.default_rng(int(requests[0].rid) + 0x5eed)
        tpots = tpot * noise_rng.uniform(0.92, 1.08, size=n)

        decode_busy = float((out * tpots).sum()) / max(float(batch), 1.0)
        decode_frac = min(decode_busy / max(K * duration, 1e-9), 1.0)

        compute_util = min(busy_compute / max(K * duration, 1e-9), 1.0)
        util = min(m.gpu_util_prefill * compute_util
                   + m.gpu_util_decode * decode_frac, 1.0)
        energy = self.carbon.energy_kwh(util, duration, ssd_tb=cache_tb,
                                        n_servers=K, types=self.types,
                                        storage=self.storage)
        energy += self._drain_io_kwh()      # tier promotion/demotion I/O
        if self._pending_kwh:
            # transition energy (boot/drain/migration) accrued by apply():
            # priced operationally at this window's CI
            energy += self._pending_kwh
            self._pending_kwh = 0.0

        # per-request write-back (ILP attribution + downstream consumers)
        e_req = energy / n
        for r, ru, tt, tp in zip(requests, reused.tolist(), ttft.tolist(),
                                 tpots.tolist()):
            r.reused_tokens = ru
            r.ttft = tt
            r.tpot = tp
            r.energy_kwh = e_req

        ci_avg = float(np.mean([ci_fn(float(a)) for a in arrival])) \
            if n <= 64 else _mean_ci(ci_fn, arrival)
        op = self.carbon.operational_g(energy, ci_avg)
        emb_cache = self._cache_embodied(cache_tb, duration)
        emb_comp = self.carbon.compute_embodied_g(duration, n_replicas=K,
                                                  types=self.types)
        if self.recorder is not None:
            self._record_window(requests, arrival, out, prompt, reused,
                                uncached, assign, ttft, tpots, e_req,
                                ci_avg, kv_load_s)
        tiers_arr, work_arr, ten_arr = _tier_arrays(requests, uncached,
                                                    out, record)
        return SimResult(
            ttft=ttft if record else np.array([]),
            tpot=tpots if record else np.array([]),
            energy_kwh=energy, duration_s=duration,
            carbon_g=op + emb_cache + emb_comp, operational_g=op,
            embodied_cache_g=emb_cache, embodied_compute_g=emb_comp,
            token_hit_rate=hit_tokens / max(lookup_tokens, 1),
            gpu_util=util, num_requests=n, n_replicas=K,
            tiers=tiers_arr, work=work_arr, tenants=ten_arr)

    # ------------------------------------------------------------------ #
    def _record_window(self, requests: Sequence, arrival: np.ndarray,
                       out: np.ndarray, prompt: np.ndarray,
                       reused: np.ndarray, uncached: np.ndarray,
                       assign: np.ndarray, ttft: np.ndarray,
                       tpots: np.ndarray, e_req: float, ci_avg: float,
                       kv_load_s: Optional[np.ndarray],
                       extra_ttft_s=0.0):
        """Emit this window's span rows to the attached flight recorder.
        Only ever called when ``self.recorder`` is set (the detached
        default skips the branch entirely — the bit-identity contract),
        and everything here reads arrays the window already produced."""
        from repro_torch.obs.trace import HIT_KIND_CODES

        rec = self.recorder
        m = self.model
        n = len(requests)
        ctx = np.fromiter((r.context_tokens for r in requests),
                          np.int64, count=n)
        # HitKind from the stashed raw account() returns when the window
        # went through an _account* pass; the least_loaded router calls
        # account() inline, so there we reconstruct hit/partial/miss from
        # matched-vs-context alone (too_large/rejected fold into miss)
        kinds = np.full(n, HIT_KIND_CODES["miss"], dtype=np.int8)
        ret = self._last_ret
        if ret is not None and len(ret) == n:
            kinds[ret == -2] = HIT_KIND_CODES["too_large"]
            kinds[ret == -3] = HIT_KIND_CODES["rejected"]
        pos = reused > 0
        kinds[pos & (reused < ctx)] = HIT_KIND_CODES["partial"]
        kinds[pos & (reused >= ctx)] = HIT_KIND_CODES["hit"]
        hit_tier = self._last_hit_tier
        if hit_tier is not None and len(hit_tier) != n:
            hit_tier = None

        if self._hetero:
            prefill_s = (m.prefill_base_s
                         + uncached / m.prefill_tok_per_s) \
                / self._scales[assign]
        else:
            prefill_s = (m.prefill_base_s
                         + uncached / m.prefill_tok_per_s) \
                / self._uniform_scale
        if kv_load_s is None:
            kv_load_s = reused * m.kv_bytes_per_token \
                / (self._kv_gbps * 1e9)
        queue_s = np.clip(ttft - prefill_s - kv_load_s - extra_ttft_s,
                          0.0, None)

        tl = [r.tier for r in requests]
        tiers = tl if len(set(tl)) > 1 or tl[0] != DEFAULT_TIER else None
        tenants = [r.tenant or "" for r in requests] \
            if any(r.tenant for r in requests) else None
        rec.record_window(
            rids=np.fromiter((r.rid for r in requests), np.int64,
                             count=n),
            arrival=arrival, ttft=ttft, tpot=tpots,
            prefill_s=prefill_s, kv_load_s=kv_load_s, queue_s=queue_s,
            prompt_tokens=prompt, output_tokens=out,
            matched_tokens=reused, hit_kind=kinds, hit_tier=hit_tier,
            replica=assign, energy_j_per_req=e_req * 3.6e6,
            ci_g_per_kwh=ci_avg, region=self.obs_region,
            tiers=tiers, tenants=tenants)

    # ------------------------------------------------------------------ #
    # typed-storage accounting (all no-ops when ``storage is None``)
    # ------------------------------------------------------------------ #
    def _mark_wear(self):
        """Snapshot the wear clocks at window start so the window's
        write *rate* (not the lifetime total) prices embodied carbon."""
        if self.storage is None:
            return
        if self._tiered:
            self._wear0 = list(self.stores[0].tier_written)
        else:
            self._wear0 = [sum(st.stats.written_bytes
                               for st in self.stores)]

    def _window_write_rates(self, duration: float) -> list:
        """Per-tier host-write rates (bytes/s) over the finished window —
        the wear clock ``CarbonModel.cache_embodied_g`` amortizes
        endurance-limited devices against."""
        d = max(duration, 1e-9)
        if self._tiered:
            return [(w1 - w0) / d for w0, w1 in
                    zip(self._wear0, self.stores[0].tier_written)]
        w1 = sum(st.stats.written_bytes for st in self.stores)
        return [(w1 - self._wear0[0]) / d]

    def _cache_embodied(self, cache_tb: float, duration: float) -> float:
        if self.storage is None:
            return self.carbon.cache_embodied_g(cache_tb, duration)
        live = self._live_storage(cache_tb) \
            if abs(self.storage.total_tb - cache_tb) > 1e-9 else self.storage
        rates = self._window_write_rates(duration) if self.wear_aware \
            else None
        return self.carbon.cache_embodied_g(cache_tb, duration,
                                            storage=live,
                                            write_bytes_per_s=rates)

    def _drain_io_kwh(self) -> float:
        """Active I/O energy of tier promotions/demotions accrued by the
        tiered store since the last window (0.0 — exact — otherwise)."""
        if not self._tiered:
            return 0.0
        return self.stores[0].drain_io_energy_j() / 3.6e6

    def _account_tiered(self, requests: Sequence, assign: np.ndarray,
                        arrival: np.ndarray, ctx: np.ndarray,
                        prompt: np.ndarray):
        """Ordered accounting pass for a tiered store: like ``_account``
        but collects the tier each hit was served from, so the KV load
        time — and therefore TTFT — emerges from tier placement."""
        n = len(requests)
        st = self.stores[0]
        acct = st.account
        m = self.model
        bw = [st.read_gbps_for(0) * 1e9,
              st.read_gbps_for(1) * 1e9 * self._kv_degrade]
        kv_bpt = m.kv_bytes_per_token
        rets = np.empty(n, dtype=np.int64)
        kv_load = np.empty(n)
        al, cl, pl = arrival.tolist(), ctx.tolist(), prompt.tolist()
        tw = self.tier_weights
        hit_tiers = np.empty(n, dtype=np.int8) \
            if self.recorder is not None else None
        for i, (r, a, c, p) in enumerate(zip(requests, al, cl, pl)):
            ret = acct(r.context_key, c, p, a, r.turn, False) \
                if tw is None else \
                acct(r.context_key, c, p, a, r.turn, False,
                     weight=tw.get(r.tier, 1.0))
            rets[i] = ret
            ru = ret if ret >= 0 else 0
            kv_load[i] = ru * kv_bpt / bw[1 if st.last_hit_tier > 0
                                          else 0]
            if hit_tiers is not None:
                hit_tiers[i] = st.last_hit_tier
        if self.recorder is not None:
            self._last_ret = rets
            self._last_hit_tier = hit_tiers
        reused = np.maximum(rets, 0)
        # batched stats from the encoded returns (>=0 hit, -1 inserted)
        s = st.stats
        s.lookups += n
        s.lookup_tokens += int(ctx.sum())
        s.hits += int((rets >= 0).sum())
        s.hit_tokens += int(reused.sum())
        s.insertions += int((rets == -1).sum())
        return reused, kv_load

    # ------------------------------------------------------------------ #
    def _route_static(self, requests: Sequence, n: int,
                      prio: Optional[np.ndarray] = None) -> np.ndarray:
        """Routers whose decision is known at arrival (vectorizable).
        ``prio`` (per-request tier priorities, multi-tier streams only)
        makes cache_affinity's spill tier-aware: top-priority (gold)
        requests never spill off their owning replica — affinity, and
        with it the hit rate, is preserved for the tier with the
        tightest TTFT budget, while lower tiers absorb the balancing."""
        K = self.n_replicas
        if K == 1:
            return np.zeros(n, dtype=np.int64)
        if self.router == "round_robin":
            assign = (np.arange(n, dtype=np.int64) + self._rr_next) % K
            self._rr_next = (self._rr_next + n) % K
            return assign
        # cache_affinity: hash each route key (the prefix *root* block for
        # structured requests, so every context sharing a system prompt
        # lands on the same replica's tree; the whole context key
        # otherwise) onto the ring, then apply bounded-load spill
        # (consistent hashing with bounded loads): no replica may exceed
        # (1 + eps) of its fair share of the window; overloaded arrivals
        # spill to the next replica, trading a little affinity for a hard
        # balance guarantee
        hashes = np.fromiter((_stable_hash(r.route_key) for r in requests),
                             np.uint64, count=n)
        preferred = self._ring.owners_of(hashes)
        eps = self.balance_eps
        if eps is None:
            return preferred
        assign = np.empty(n, dtype=np.int64)
        counts = [0] * K
        if self._hetero:
            # mixed fleet: fair share ∝ per-replica capacity, so a slow
            # replica spills sooner than a fast one
            tot = float(self._scales.sum())
            fairs = [(1.0 + eps) * float(s) / tot for s in self._scales]
        else:
            fairs = [(1.0 + eps) / K] * K
        top = int(prio.min()) if prio is not None else 0
        pl = prio.tolist() if prio is not None else None
        for i, k in enumerate(preferred.tolist()):
            if pl is not None and pl[i] == top:
                assign[i] = k        # gold sticks to its owner
                counts[k] += 1
                continue
            spill = 0
            while counts[k] >= fairs[k] * (i + 1) + 1.0 and spill < K:
                k = (k + 1) % K
                spill += 1
            assign[i] = k
            counts[k] += 1
        return assign

    def _account(self, requests: Sequence, assign: np.ndarray,
                 arrival: np.ndarray, ctx: np.ndarray, prompt: np.ndarray
                 ) -> np.ndarray:
        """Ordered cache-accounting pass in arrival order (seed semantics:
        the full prefix is cached at arrival, so later same-context requests
        in the window can hit). Uses the fused ``KVStore.account`` hot path
        — one dict probe per request."""
        n = len(requests)
        al, cl, pl = arrival.tolist(), ctx.tolist(), prompt.tolist()
        tw = self.tier_weights
        if tw is not None:
            stores = self.stores
            kl = assign.tolist()
            ret = np.fromiter(
                (stores[0 if self.shared else k].account(
                    r.context_key, c, p, a, r.turn, False,
                    weight=tw.get(r.tier, 1.0))
                 for r, k, a, c, p in zip(requests, kl, al, cl, pl)),
                np.int64, count=n)
        elif self.shared:
            acct = self.stores[0].account
            ret = np.fromiter(
                (acct(r.context_key, c, p, a, r.turn, False)
                 for r, a, c, p in zip(requests, al, cl, pl)),
                np.int64, count=n)
        else:
            stores = self.stores
            ret = np.fromiter(
                (stores[k].account(r.context_key, c, p, a, r.turn, False)
                 for r, k, a, c, p in zip(requests, assign.tolist(),
                                          al, cl, pl)),
                np.int64, count=n)
        if self.recorder is not None:
            self._last_ret = ret
        reused = np.maximum(ret, 0)
        # batched stats from the encoded returns (>=0 hit, -1 inserted)
        for k, st in enumerate(self.stores):
            mask = slice(None) if self.shared else (assign == k)
            s = st.stats
            s.lookups += int(n if self.shared else mask.sum())
            s.lookup_tokens += int(ctx[mask].sum())
            s.hits += int((ret[mask] >= 0).sum())
            s.hit_tokens += int(reused[mask].sum())
            s.insertions += int((ret[mask] == -1).sum())
        return reused

    def _account_prefix(self, requests: Sequence, assign: np.ndarray,
                        arrival: np.ndarray, ctx: np.ndarray,
                        prompt: np.ndarray) -> np.ndarray:
        """Ordered accounting pass threading structured prefix segments:
        the radix store matches/extends each request's block path, and the
        returned reused counts are the *matched-prefix* tokens (partial
        hits included). Per-request stats stay inside the store — a
        partial hit both hits and inserts, which the batch decode of
        ``_account`` (built on the flat ``ret == -1`` <=> inserted
        equivalence) cannot reconstruct."""
        n = len(requests)
        al, cl, pl = arrival.tolist(), ctx.tolist(), prompt.tolist()
        tw = self.tier_weights
        if tw is not None:
            stores = self.stores
            kl = assign.tolist()
            ret = np.fromiter(
                (stores[0 if self.shared else k].account(
                    r.context_key, c, p, a, r.turn, True,
                    r.prefix_segments, weight=tw.get(r.tier, 1.0))
                 for r, k, a, c, p in zip(requests, kl, al, cl, pl)),
                np.int64, count=n)
        elif self.shared:
            acct = self.stores[0].account
            ret = np.fromiter(
                (acct(r.context_key, c, p, a, r.turn, True,
                      r.prefix_segments)
                 for r, a, c, p in zip(requests, al, cl, pl)),
                np.int64, count=n)
        else:
            stores = self.stores
            ret = np.fromiter(
                (stores[k].account(r.context_key, c, p, a, r.turn, True,
                                   r.prefix_segments)
                 for r, k, a, c, p in zip(requests, assign.tolist(),
                                          al, cl, pl)),
                np.int64, count=n)
        if self.recorder is not None:
            self._last_ret = ret
        return np.maximum(ret, 0)

    def _run_sequential(self, requests: Sequence, arrival: np.ndarray,
                        prompt: np.ndarray):
        """least_loaded: the routing decision needs the evolving backlog, so
        the queueing recurrence cannot be hoisted out of the loop. On a
        mixed fleet the rule becomes earliest *completion*: a fast replica
        with a slightly longer backlog can still finish the request first."""
        m = self.model
        K = self.n_replicas
        n = len(requests)
        free = self._free
        assign = np.empty(n, dtype=np.int64)
        reused = np.empty(n, dtype=np.int64)
        ttft = np.empty(n)
        kv_load = np.empty(n)
        kv_s_per_tok = m.kv_bytes_per_token / (self._kv_gbps * 1e9)
        tiered = self._tiered
        if tiered:
            st0 = self.stores[0]
            kv_per_tier = [m.kv_bytes_per_token
                           / (st0.read_gbps_for(t) * 1e9
                              * (1.0 if t == 0 else self._kv_degrade))
                           for t in (0, 1)]
        scales = self._scales.tolist()
        hetero = self._hetero
        uscale = self._uniform_scale
        for i, r in enumerate(requests):
            if hetero:
                # earliest completion under per-replica speed: compute time
                # shrinks on a fast replica, KV load does not
                a = float(arrival[i])
                comp = m.prefill_base_s \
                    + (int(prompt[i])) / m.prefill_tok_per_s
                k = min(range(K),
                        key=lambda j: max(free[j], a) + comp / scales[j])
            else:
                k = min(range(K), key=lambda j: free[j])
            st = self.stores[0] if self.shared else self.stores[k]
            tw = self.tier_weights
            ru = max(st.account(r.context_key, r.context_tokens,
                                int(prompt[i]), r.arrival, r.turn,
                                blocks=r.prefix_segments
                                if self._prefix else None)
                     if tw is None else
                     st.account(r.context_key, r.context_tokens,
                                int(prompt[i]), r.arrival, r.turn,
                                blocks=r.prefix_segments
                                if self._prefix else None,
                                weight=tw.get(r.tier, 1.0)), 0)
            un = int(prompt[i]) - ru
            if tiered:
                kv_load[i] = ru * kv_per_tier[1 if st.last_hit_tier > 0
                                              else 0]
            else:
                kv_load[i] = ru * kv_s_per_tok
            service = (m.prefill_base_s + un / m.prefill_tok_per_s) \
                / (scales[k] if hetero else uscale) + kv_load[i]
            start = max(float(arrival[i]), free[k])
            free[k] = start + service
            assign[i] = k
            reused[i] = ru
            ttft[i] = free[k] - float(arrival[i])
        return assign, reused, ttft, max(free), kv_load


class DisaggEngine(ClusterEngine):
    """Prefill/decode disaggregated cluster (DistServe/Splitwise-style,
    built for the GreenLLM typed-fleet carbon asymmetry).

    The *prefill pool* (this engine's base-class replicas) owns the KV
    store(s), router and queueing exactly as a fused ``ClusterEngine``;
    the *decode pool* is a separate typed fleet that only runs token
    generation. Consequences modeled:

      * **KV handoff** — each request's full prompt KV streams from its
        prefill replica to a decode replica over the interconnect
        (``ServingModel.kv_transfer_gbps``); the transfer gates the first
        token (added to TTFT) but does not occupy the prefill server
        (DMA overlaps the next prefill).
      * **No prefill/decode interference** — the decode pool's TPOT fixed
        point drops the ``decode_interference`` inflation entirely (no
        prefill steals its iterations); that is the operational-carbon
        lever of disaggregation.
      * **Decode saturation** — if the arrival token rate exceeds the
        pool's max-batch service rate, TPOT inflates by the overload
        ratio (a stand-in for the unbounded queue), so undersized decode
        pools violate the TPOT SLO instead of looking free.
      * **Split energy/embodied accounting** — each pool runs at its own
        operating point (prefill compute-bound at ``gpu_util_prefill``
        weight, decode memory-bound at ``gpu_util_decode``), priced via
        ``CarbonModel.plan_energy_kwh``; embodied carbon sums both typed
        fleets. This is what lets amortized old-generation decode pools
        pay off: decode capacity is cheap on TPOT SLOs, so it can ride
        hardware whose embodied bill is already written down, while the
        latency-critical prefill pool stays on compute-dense new silicon.

    Construct from a disaggregated ``ResourcePlan``; reconfigure hourly
    with ``apply(plan)``.
    """

    def __init__(self, model: ServingModel,
                 stores: Union[KVStore, Sequence[KVStore]],
                 carbon: CarbonModel, plan: ResourcePlan,
                 transitions: Optional[TransitionConfig] = None,
                 wear_aware: bool = True,
                 tier_weights: Optional[Dict[str, float]] = None):
        if not plan.is_disaggregated:
            raise ValueError("DisaggEngine needs a disaggregated plan "
                             "(prefill= and decode= pools)")
        pre = plan.prefill
        router = pre.router if pre.router is not None else \
            ("single" if pre.n_replicas == 1 else "cache_affinity")
        super().__init__(model, stores, carbon, types=pre.fleet,
                         router=router, balance_eps=pre.resolved_eps,
                         transitions=transitions, wear_aware=wear_aware,
                         tier_weights=tier_weights)
        self._set_decode(plan.decode.fleet)

    def _set_decode(self, types: Sequence[str]):
        types = [str(t) for t in types]
        if not types:
            raise ValueError("decode pool must have at least one replica")
        self.decode_types = types
        self._dec_scales = np.array(
            [get_replica_type(t).perf_scale for t in types])
        # per-replica readiness (booted decode replicas join late); the
        # transition path overwrites this after a decode-pool change
        self._dec_ready_at = [0.0] * len(types)

    @property
    def total_replicas(self) -> int:
        return self.n_replicas + len(self.decode_types)

    def current_plan(self, cache_tb: Optional[float] = None) -> ResourcePlan:
        if cache_tb is None:
            cache_tb = sum(st.capacity_bytes for st in self.stores) / 1e12
        return ResourcePlan.disaggregated(
            cache_tb, prefill=tuple(self.types), decode=self.decode_types,
            router=self.router, balance_eps=self.balance_eps,
            partitioned=not self.shared,
            storage=self._live_storage(cache_tb))

    def apply(self, plan: ResourcePlan, *, now: float = 0.0
              ) -> AppliedTransition:
        """Reconfigure both pools (and the cache allocation) from an
        hourly disaggregated plan; with a ``TransitionConfig`` each
        pool's change is simulated over time (see ``ClusterEngine
        .apply``) — booting decode replicas join the analytic decode
        fixed point only after their warmup."""
        if not plan.is_disaggregated:
            raise ValueError("disaggregated cluster cannot apply a "
                             "single-pool plan; build a ClusterEngine")
        pre = plan.prefill
        self._apply_pool_knobs(pre)
        tr = PlanTransition.diff(self.current_plan(), plan)
        applied = AppliedTransition(tr)
        cfg = self.transitions
        if cfg is None or (cfg.is_free and (self.shared or
                           pre.n_replicas == self.n_replicas)):
            if list(pre.fleet) != self.types:
                self._apply_fleet(pre.fleet)
            self._set_decode(plan.decode.fleet)
            self._resize_cache(plan.cache_tb, now, storage=plan.storage)
            return applied
        applied.energy_kwh += self.carbon.transition_energy_kwh(
            tr, boot_latency_s=cfg.boot_latency_s)      # both pools' boots
        self._transition_pool(pre, tr, now, applied)
        self._transition_decode(plan.decode.fleet, now, applied)
        self._resize_cache(plan.cache_tb, now,
                           ramp_s=cfg.cache_ramp_s,
                           steps=cfg.cache_ramp_steps,
                           storage=plan.storage)
        self._pending_kwh += applied.energy_kwh
        return applied

    def _transition_decode(self, types: Sequence[str], now: float,
                           applied: AppliedTransition):
        """Decode-pool fleet change under the transition model: survivors
        (matched per type, earliest-ready first) keep their readiness,
        booted replicas become available at ``now + boot_s`` (the decode
        fixed point scales their capacity by in-window availability), and
        drained replicas are priced a nominal powered residual
        (``TransitionConfig.decode_drain_s`` — the analytic pool has no
        per-replica backlog to measure)."""
        cfg = self.transitions
        types = [str(t) for t in types]
        ready = defaultdict(list)
        for t, r in zip(self.decode_types, self._dec_ready_at):
            ready[t].append(r)
        for t in ready:
            ready[t].sort()
        new_ready = []
        for t in types:
            if ready[t]:
                new_ready.append(ready[t].pop(0))
            else:
                b = cfg.boot_s(t)
                new_ready.append(now + b)
                applied.boot_s = max(applied.boot_s, b)
        if cfg.drain and cfg.decode_drain_s > 0.0:
            for t, rem in ready.items():
                rt = get_replica_type(t)
                for _ in rem:
                    applied.drain_s += cfg.decode_drain_s
                    applied.energy_kwh += \
                        rt.idle_energy_kwh(cfg.decode_drain_s)
        self._set_decode(types)
        self._dec_ready_at = new_ready

    # ------------------------------------------------------------------ #
    def _finish_run(self, requests: Sequence, arrival: np.ndarray,
                    out: np.ndarray, prompt: np.ndarray, reused: np.ndarray,
                    uncached: np.ndarray, assign: np.ndarray,
                    ttft: np.ndarray, finish_max: float, t0: float, *,
                    ci_fn: Callable[[float], float], cache_tb: float,
                    rate_hint: Optional[float], record: bool,
                    kv_load_s: Optional[np.ndarray] = None) -> SimResult:
        m = self.model
        Kp = self.n_replicas
        Kd = len(self.decode_types)
        n = len(requests)
        lookup_tokens = int(prompt.sum())
        hit_tokens = int(reused.sum())

        # KV handoff gates the first decode token: the whole prompt's KV
        # (cached prefix + freshly computed suffix) must land in a decode
        # replica's HBM before generation starts
        xfer_s_tok = m.kv_bytes_per_token / (m.kv_transfer_gbps * 1e9)
        ttft = ttft + prompt * xfer_s_tok

        if self._hetero:
            compute_s = (m.prefill_base_s + uncached / m.prefill_tok_per_s) \
                / self._scales[assign]
            busy_compute = float(compute_s.sum())
        else:
            busy_compute = float(m.prefill_base_s * n
                                 + (uncached / m.prefill_tok_per_s).sum()) \
                / self._uniform_scale

        duration = max(finish_max, float(arrival[-1])) - t0
        compute_util_p = min(busy_compute / max(Kp * duration, 1e-9), 1.0)

        # decode pool: continuous-batching fixed point, NO prefill
        # interference (the whole point of the dedicated pool).  Booting
        # replicas count only for the fraction of the window they are
        # ready (transition warmup); the steady state divides by the
        # integer count exactly as before
        span = max(float(arrival[-1]) - t0, 1.0)
        t_end = max(finish_max, float(arrival[-1]))
        if any(r > t0 for r in self._dec_ready_at):
            span_w = max(t_end - t0, 1e-9)
            kd_eff = sum(min(max((t_end - r) / span_w, 0.0), 1.0)
                         for r in self._dec_ready_at)
            kd_eff = max(kd_eff, 1e-6)
        else:
            kd_eff = Kd
        lam = (rate_hint if rate_hint else n / span) / kd_eff
        out_mean = float(out.mean())
        dec_slow = float(np.mean(1.0 / self._dec_scales))
        tpot, batch = m.decode_fixed_point(lam, out_mean, dec_slow)
        noise_rng = np.random.default_rng(int(requests[0].rid) + 0x5eed)
        tpots = tpot * noise_rng.uniform(0.92, 1.08, size=n)

        decode_busy = float((out * tpots).sum()) / max(float(batch), 1.0)
        decode_frac = min(decode_busy / max(Kd * duration, 1e-9), 1.0)

        util_p = min(m.gpu_util_prefill * compute_util_p, 1.0)
        util_d = min(m.gpu_util_decode * decode_frac, 1.0)
        plan = self.current_plan(cache_tb)
        # the dedicated decode pool runs power-capped (memory-bound
        # decode tolerates reduced clocks: ServingModel docstring)
        energy = self.carbon.plan_energy_kwh(
            plan, {"prefill": util_p, "decode": util_d}, duration,
            pool_power_frac={"decode": m.decode_pool_power_frac})
        energy += self._drain_io_kwh()      # tier promotion/demotion I/O
        if self._pending_kwh:
            energy += self._pending_kwh
            self._pending_kwh = 0.0

        e_req = energy / n
        for r, ru, tt, tp in zip(requests, reused.tolist(), ttft.tolist(),
                                 tpots.tolist()):
            r.reused_tokens = ru
            r.ttft = tt
            r.tpot = tp
            r.energy_kwh = e_req

        ci_avg = float(np.mean([ci_fn(float(a)) for a in arrival])) \
            if n <= 64 else _mean_ci(ci_fn, arrival)
        op = self.carbon.operational_g(energy, ci_avg)
        emb_cache = self._cache_embodied(cache_tb, duration)
        emb_comp = self.carbon.compute_embodied_g(duration,
                                                  types=plan.all_types)
        if self.recorder is not None:
            # the KV handoff already inside ttft is not queueing time
            self._record_window(requests, arrival, out, prompt, reused,
                                uncached, assign, ttft, tpots, e_req,
                                ci_avg, kv_load_s,
                                extra_ttft_s=prompt * xfer_s_tok)
        util = (Kp * util_p + Kd * util_d) / (Kp + Kd)
        tiers_arr, work_arr, ten_arr = _tier_arrays(requests, uncached,
                                                    out, record)
        return SimResult(
            ttft=ttft if record else np.array([]),
            tpot=tpots if record else np.array([]),
            energy_kwh=energy, duration_s=duration,
            carbon_g=op + emb_cache + emb_comp, operational_g=op,
            embodied_cache_g=emb_cache, embodied_compute_g=emb_comp,
            token_hit_rate=hit_tokens / max(lookup_tokens, 1),
            gpu_util=util, num_requests=n, n_replicas=Kp + Kd,
            tiers=tiers_arr, work=work_arr, tenants=ten_arr)


def _tier_arrays(requests: Sequence, uncached: np.ndarray,
                 out: np.ndarray, record: bool):
    """Per-request tier labels, work weights (uncached prefill and
    output tokens — what the fleet actually computed) and tenant labels
    for functional-unit attribution. ``(None, None, None)`` for the
    ubiquitous single-tier default stream, so legacy results carry no
    extra arrays; tenants stay None for stamped-tier streams whose
    requests carry no tenant identity."""
    if not record:
        return None, None, None
    tl = [r.tier for r in requests]
    if len(set(tl)) == 1 and tl[0] == DEFAULT_TIER:
        return None, None, None
    tenants = None
    if any(r.tenant for r in requests):
        tenants = np.array([r.tenant or DEFAULT_TIER + "-0"
                            for r in requests], dtype=object)
    return np.array(tl, dtype=object), (uncached + out).astype(float), \
        tenants


def _mean_ci(ci_fn: Callable[[float], float], arrival: np.ndarray) -> float:
    """Average CI over arrivals, sampled sparsely: CI traces are hourly
    piecewise-constant, so ~64 evenly spaced probes suffice and avoid n
    Python calls on long windows."""
    probes = arrival[np.linspace(0, len(arrival) - 1, 64).astype(int)]
    return float(np.mean([ci_fn(float(t)) for t in probes]))


def make_cluster(model: ServingModel, carbon: CarbonModel, *,
                 cache_tb: Optional[float] = None, policy: Callable,
                 n_replicas: int = 1, router: Optional[str] = None,
                 partitioned: bool = False,
                 types: Optional[Sequence[str]] = None,
                 balance_eps: Optional[float] = 0.15,
                 plan: Union[ResourcePlan, str, None] = None,
                 transitions: Optional[TransitionConfig] = None,
                 storage: Union[StorageSpec, str, None] = None,
                 wear_aware: bool = True,
                 admission=None,
                 prefix_caching: bool = False,
                 tier_weights: Optional[Dict[str, float]] = None
                 ) -> ClusterEngine:
    """Convenience constructor: builds the store(s) for a cluster-total
    ``cache_tb`` allocation (partitioned mode splits it evenly).

    ``plan`` is the preferred entry point — a ``ResourcePlan`` (or a
    plan string like ``"cache=4tb fleet=a100:2,l40:4"``) carrying the
    cache size, pool fleet(s) and routing knobs (a disaggregated plan
    yields a ``DisaggEngine``).  ``transitions`` installs the
    reconfiguration model applied by subsequent ``apply`` calls.  The
    remaining kwargs are the pre-plan spelling: ``types`` selects a
    heterogeneous fleet (one ``ReplicaType`` name per replica,
    overriding ``n_replicas``).

    Typed storage: a plan whose cache is a tier spec
    (``cache=dram:0.5tb+nvme_gen4:4tb``), or an explicit ``storage=``
    spec, builds the matching store — a ``TieredKVStore`` for two tiers
    (shared-store mode only), a flat ``KVStore`` tagged with its device
    for one — and the engine prices energy/embodied from the devices,
    with the wear clock (``wear_aware=False`` keeps calendar lifetimes —
    the flat-default parity configuration).  ``admission`` installs a
    ``repro_torch.core.storage.WriteAwareAdmission`` gate on the store(s).

    ``prefix_caching=True`` builds ``RadixKVStore`` partitions instead of
    flat ``KVStore``s: requests carrying ``prefix_blocks`` get
    longest-prefix partial hits and cache-affinity routing by prefix
    root; legacy whole-context requests behave bit-identically to the
    flat store.  Not combinable with tiered storage (yet)."""
    if isinstance(plan, str):
        plan = ResourcePlan.parse(plan)
    if isinstance(storage, str):
        storage = StorageSpec.parse(storage)
    if plan is not None:
        pre = plan.prefill
        if plan.cache_tb is None:
            raise ValueError("make_cluster needs a sized plan "
                             "(plan.with_cache(...))")
        cache_tb = plan.cache_tb
        n_replicas = pre.n_replicas
        types = pre.fleet
        router = pre.router if router is None else router
        partitioned = pre.partitioned
        balance_eps = pre.resolved_eps
        if storage is None:
            storage = plan.storage
    elif cache_tb is None and storage is not None:
        cache_tb = storage.total_tb
    elif cache_tb is None:
        raise ValueError("make_cluster needs cache_tb (or a sized plan)")
    if types is not None:
        n_replicas = len(types)
    if router is None:
        router = "single" if n_replicas == 1 else "cache_affinity"
    if storage is not None and partitioned:
        raise ValueError("typed storage supports the shared-store mode "
                         "only")
    if prefix_caching and storage is not None and storage.is_tiered:
        raise ValueError("prefix_caching does not combine with a tiered "
                         "store (radix is single-tier for now)")
    store_cls = RadixKVStore if prefix_caching else KVStore
    if partitioned and n_replicas > 1:
        per = cache_tb * 1e12 / n_replicas
        stores: Union[KVStore, List[KVStore]] = [
            store_cls(per, policy, model.kv_bytes_per_token)
            for _ in range(n_replicas)]
        for st in stores:
            st.admission = admission
    elif storage is not None and storage.is_tiered:
        stores = TieredKVStore(storage, policy, model.kv_bytes_per_token,
                               admission=admission)
    else:
        stores = store_cls(cache_tb * 1e12, policy,
                           model.kv_bytes_per_token)
        if storage is not None:
            stores.spec = storage
        stores.admission = admission
    if plan is not None and plan.is_disaggregated:
        if router is not None and router != plan.prefill.router:
            # honor an explicit router kwarg, as the fused branch does
            import dataclasses
            plan = dataclasses.replace(plan, pools=tuple(
                dataclasses.replace(p, router=router)
                if p.role == "prefill" else p for p in plan.pools))
        return DisaggEngine(model, stores, carbon, plan,
                            transitions=transitions,
                            wear_aware=wear_aware,
                            tier_weights=tier_weights)
    return ClusterEngine(model, stores, carbon, n_replicas=n_replicas,
                         router=router, types=types,
                         balance_eps=balance_eps, transitions=transitions,
                         wear_aware=wear_aware, tier_weights=tier_weights)
