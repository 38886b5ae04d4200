"""First-class resource plans: the single currency of the hourly loop.

The paper's core decision is "derive a resource allocation plan per
hour".  Historically that plan was threaded through the stack as parallel
lists and ad-hoc kwargs (``cache_tb``, ``n_replicas``, ``fleets``,
``router``, ``balance_eps``, ``partitioned``); this module reifies it:

* ``PoolSpec`` — one serving pool: a *role* (``serve`` for a fused
  cluster, ``prefill``/``decode`` for a disaggregated one), a fleet of
  ``ReplicaType`` names, and the pool's routing knobs.
* ``ResourcePlan`` — a frozen value object: the cache allocation plus one
  or more pools.  ``cache_tb=None`` means "let the solver size it".

Every layer speaks plans: ``solve_cluster_schedule`` returns one per
hour, ``ClusterEngine.apply``/``DisaggEngine.apply`` reconfigure a live
cluster from one, ``CarbonModel.plan_energy_kwh``/``plan_embodied_g``
price one, and ``repro.launch.serve --plan`` parses one from the CLI.

String grammar (``ResourcePlan.parse`` / ``str(plan)`` round-trip)::

    cache=4tb fleet=a100:2,l40:4 [router=cache_affinity] [eps=0.15]
        [partitioned]
    cache=auto prefill=h100:2 decode=a100:3 [router=...] [eps=...]
    cache=dram:0.5tb+nvme_gen4:4tb fleet=l40:2        (typed tiers)

Fleet specs reuse ``repro_torch.core.carbon.parse_fleet`` (``"a100:2,l40:4"``).
A ``cache=`` value containing a device name is a typed
``repro_torch.core.storage.StorageSpec`` tiering (``plan.storage``); a bare
``cache=4tb`` keeps ``storage=None`` — the legacy flat-SSD model whose
pricing is bit-stable.  JSON round-trip via ``to_json``/``from_json``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.carbon import (fleet_capacity, fleet_str, get_replica_type,
                               parse_fleet)
from repro_torch.core.storage import StorageSpec

ROLES = ("serve", "prefill", "decode")
DEFAULT_BALANCE_EPS = 0.15


class _UnsetEps:
    """Sentinel: the pool did not specify a spill factor (``None`` is a
    meaningful value — spill disabled — so it cannot double as unset).
    ``ClusterEngine.apply`` leaves the engine's eps untouched for unset
    pools; resolution to the default happens via ``PoolSpec
    .resolved_eps``."""

    def __repr__(self):
        return "UNSET_EPS"


UNSET_EPS = _UnsetEps()


def normalize_replicas(value: Union[int, Sequence[int], None],
                       default: int = 1) -> List[int]:
    """Canonicalize the historically sloppy ``n_replicas`` knob — an int,
    a list of candidate counts (``argparse nargs="+"``), or None — into a
    sorted, de-duplicated candidate list.  The one place the
    ``serve.py --replicas`` int-vs-``list[int]`` inconsistency is
    resolved."""
    if value is None:
        value = [default]
    if isinstance(value, (int, float)):
        value = [value]
    counts = sorted({int(k) for k in value})
    if not counts or counts[0] < 1:
        raise ValueError(f"replica counts must be >= 1, got {value!r}")
    return counts


def _norm_fleet(fleet: Union[str, Sequence[str]]) -> Tuple[str, ...]:
    if isinstance(fleet, str):
        return parse_fleet(fleet)
    out = tuple(str(t) for t in fleet)
    if not out:
        raise ValueError("fleet must have at least one replica")
    for t in out:
        get_replica_type(t)
    return out


@dataclass(frozen=True)
class PoolSpec:
    """One pool of replicas inside a plan.

    ``role``: ``"serve"`` (fused prefill+decode, the classic cluster),
    ``"prefill"`` or ``"decode"`` (disaggregated pools).  ``router``,
    ``balance_eps`` and ``partitioned`` only shape queueing/caching for
    the pool that owns the KV store (``serve``/``prefill``); the decode
    pool splits load analytically.  ``router=None`` means auto (single
    for one replica, cache_affinity otherwise)."""
    role: str
    fleet: Tuple[str, ...]
    router: Optional[str] = None
    balance_eps: Union[float, None, _UnsetEps] = UNSET_EPS
    partitioned: bool = False

    def __post_init__(self):
        if self.role not in ROLES:
            raise ValueError(f"unknown pool role {self.role!r}; one of "
                             f"{ROLES}")
        object.__setattr__(self, "fleet", _norm_fleet(self.fleet))

    @property
    def resolved_eps(self) -> Optional[float]:
        """The spill factor with the unset sentinel collapsed to the
        default (engine/controller construction needs a concrete value;
        ``apply`` distinguishes unset and leaves the engine alone)."""
        if isinstance(self.balance_eps, _UnsetEps):
            return DEFAULT_BALANCE_EPS
        return self.balance_eps

    @property
    def n_replicas(self) -> int:
        return len(self.fleet)

    @property
    def capacity(self) -> float:
        """Pool throughput in reference-server units."""
        return fleet_capacity(self.fleet)

    @property
    def fleet_str(self) -> str:
        return fleet_str(self.fleet)


@dataclass(frozen=True)
class ResourcePlan:
    """A complete hourly resource allocation: cache size plus pools.

    ``cache_tb=None`` marks an *open* plan — a candidate whose cache size
    the solver decides; applied plans carry a concrete size
    (``with_cache``).  ``storage`` (a ``StorageSpec``) types the cache
    allocation into device tiers; ``cache_tb`` is then the tier total
    (reconciled here).  ``storage=None`` is the legacy flat-SSD model
    priced from the ``HardwareSpec`` scalars — the parity path."""
    cache_tb: Optional[float]
    pools: Tuple[PoolSpec, ...]
    storage: Optional[StorageSpec] = None

    def __post_init__(self):
        object.__setattr__(self, "pools", tuple(self.pools))
        roles = [p.role for p in self.pools]
        if len(roles) != len(set(roles)):
            raise ValueError(f"duplicate pool roles in {roles}")
        if len(self.pools) == 1:
            if roles != ["serve"]:
                raise ValueError("a single-pool plan must use role 'serve'")
        elif sorted(roles) == ["decode", "prefill"]:
            pass
        else:
            raise ValueError("pools must be ['serve'] or "
                             f"['prefill', 'decode'], got {roles}")
        if self.storage is not None:
            if self.cache_tb is None:
                object.__setattr__(self, "cache_tb", self.storage.total_tb)
            elif abs(self.cache_tb - self.storage.total_tb) > 1e-9:
                raise ValueError(
                    f"cache_tb={self.cache_tb} disagrees with the storage "
                    f"tiers' total {self.storage.total_tb}")
        if self.cache_tb is not None and self.cache_tb < 0:
            raise ValueError("cache_tb must be >= 0")

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #
    @classmethod
    def single(cls, cache_tb: Optional[float] = None, *,
               fleet: Union[str, Sequence[str], None] = None,
               n_replicas: Union[int, Sequence[int], None] = None,
               router: Optional[str] = None,
               balance_eps: Union[float, None,
                                  _UnsetEps] = UNSET_EPS,
               partitioned: bool = False,
               storage: Union[StorageSpec, str, None] = None
               ) -> "ResourcePlan":
        """Single fused pool.  ``fleet`` overrides ``n_replicas``; a bare
        count becomes a homogeneous reference (``l40``) fleet."""
        if fleet is None:
            counts = normalize_replicas(n_replicas)
            if len(counts) != 1:
                raise ValueError("a plan has one replica count; pass "
                                 "several candidate plans for co-decision")
            fleet = ("l40",) * counts[0]
        elif n_replicas is not None:
            raise ValueError("pass fleet= or n_replicas=, not both")
        return cls(cache_tb, (PoolSpec("serve", _norm_fleet(fleet),
                                       router=router,
                                       balance_eps=balance_eps,
                                       partitioned=partitioned),),
                   storage=_norm_storage(storage))

    @classmethod
    def disaggregated(cls, cache_tb: Optional[float] = None, *,
                      prefill: Union[str, Sequence[str]],
                      decode: Union[str, Sequence[str]],
                      router: Optional[str] = None,
                      balance_eps: Union[float, None,
                                         _UnsetEps] = UNSET_EPS,
                      partitioned: bool = False,
                      storage: Union[StorageSpec, str, None] = None
                      ) -> "ResourcePlan":
        """Prefill/decode pool disaggregation.  Router/eps/partitioning
        shape the prefill pool (it owns the KV store); the decode pool
        absorbs load analytically."""
        return cls(cache_tb, (
            PoolSpec("prefill", _norm_fleet(prefill), router=router,
                     balance_eps=balance_eps, partitioned=partitioned),
            PoolSpec("decode", _norm_fleet(decode)),
        ), storage=_norm_storage(storage))

    @classmethod
    def from_legacy(cls, cache_tb: Optional[float] = None, *,
                    n_replicas: Union[int, Sequence[int], None] = None,
                    fleet: Union[str, Sequence[str], None] = None,
                    router: Optional[str] = None,
                    balance_eps: Union[float, None,
                                       _UnsetEps] = UNSET_EPS,
                    partitioned: bool = False) -> "ResourcePlan":
        """Normalize the pre-plan kwarg sprawl (used by the deprecated
        shims; the int-vs-list ``n_replicas`` ambiguity dies here)."""
        return cls.single(cache_tb, fleet=fleet,
                          n_replicas=n_replicas if fleet is None else None,
                          router=router, balance_eps=balance_eps,
                          partitioned=partitioned)

    # ------------------------------------------------------------------ #
    # accessors
    # ------------------------------------------------------------------ #
    @property
    def is_disaggregated(self) -> bool:
        return len(self.pools) == 2

    def pool(self, role: str) -> PoolSpec:
        for p in self.pools:
            if p.role == role:
                return p
        raise KeyError(f"plan has no {role!r} pool (pools: "
                       f"{[p.role for p in self.pools]})")

    @property
    def serve(self) -> PoolSpec:
        return self.pool("serve")

    @property
    def prefill(self) -> PoolSpec:
        """The pool that runs prefill (and owns the KV store): the
        ``prefill`` pool when disaggregated, else the fused pool."""
        return self.pool("prefill" if self.is_disaggregated else "serve")

    @property
    def decode(self) -> PoolSpec:
        """The pool that runs decode: the ``decode`` pool when
        disaggregated, else the fused pool."""
        return self.pool("decode" if self.is_disaggregated else "serve")

    @property
    def fleet(self) -> Tuple[str, ...]:
        """Single-pool fleet (raises on a disaggregated plan)."""
        return self.serve.fleet

    @property
    def all_types(self) -> Tuple[str, ...]:
        """Every replica type across pools (embodied/energy accounting)."""
        return tuple(t for p in self.pools for t in p.fleet)

    @property
    def n_replicas(self) -> int:
        return sum(p.n_replicas for p in self.pools)

    @property
    def capacity(self) -> float:
        """Total throughput across pools in reference-server units."""
        return float(sum(p.capacity for p in self.pools))

    def with_cache(self, cache_tb: float) -> "ResourcePlan":
        """Size (or re-size) the plan's cache.  A typed plan rescales
        its tiers proportionally so the spec total always matches."""
        if self.storage is not None \
                and abs(self.storage.total_tb - cache_tb) > 1e-9:
            return replace(self, cache_tb=float(cache_tb),
                           storage=self.storage.scaled_to(float(cache_tb)))
        return replace(self, cache_tb=float(cache_tb))

    def with_storage(self, storage: Union[StorageSpec, str]
                     ) -> "ResourcePlan":
        """Pin a typed tiering (and the matching total cache size)."""
        spec = _norm_storage(storage)
        return replace(self, cache_tb=spec.total_tb, storage=spec)

    # ------------------------------------------------------------------ #
    # string / JSON round-trip
    # ------------------------------------------------------------------ #
    def __str__(self) -> str:
        cache = str(self.storage) if self.storage is not None \
            else _fmt_tb(self.cache_tb)
        parts = [f"cache={cache}"]
        if self.is_disaggregated:
            parts.append(f"prefill={self.prefill.fleet_str}")
            parts.append(f"decode={self.decode.fleet_str}")
        else:
            parts.append(f"fleet={self.serve.fleet_str}")
        lead = self.prefill
        if lead.router is not None:
            parts.append(f"router={lead.router}")
        if not isinstance(lead.balance_eps, _UnsetEps):
            eps = "none" if lead.balance_eps is None \
                else f"{lead.balance_eps:g}"
            parts.append(f"eps={eps}")
        if lead.partitioned:
            parts.append("partitioned")
        return " ".join(parts)

    @classmethod
    def parse(cls, spec: str) -> "ResourcePlan":
        """Inverse of ``str(plan)`` — see the module docstring grammar."""
        cache_tb: Optional[float] = None
        storage: Optional[StorageSpec] = None
        fleets: Dict[str, Tuple[str, ...]] = {}
        router: Optional[str] = None
        balance_eps: Union[float, None, _UnsetEps] = UNSET_EPS
        partitioned = False
        for tok in spec.split():
            key, sep, val = tok.partition("=")
            key = key.strip().lower()
            if not sep:
                if key == "partitioned":
                    partitioned = True
                    continue
                raise ValueError(f"bad plan token {tok!r} in {spec!r}")
            if key == "cache":
                if ":" in val:           # typed tiers: device:SIZEtb[+...]
                    storage = StorageSpec.parse(val)
                    cache_tb = storage.total_tb
                else:
                    cache_tb = _parse_tb(val)
            elif key in ("fleet", "serve", "prefill", "decode"):
                fleets["serve" if key == "fleet" else key] = parse_fleet(val)
            elif key == "router":
                router = val
            elif key == "eps":
                balance_eps = None if val.lower() in ("none", "off") \
                    else float(val)
            else:
                raise ValueError(f"unknown plan key {key!r} in {spec!r}")
        if set(fleets) == {"serve"}:
            return cls.single(cache_tb, fleet=fleets["serve"],
                              router=router, balance_eps=balance_eps,
                              partitioned=partitioned, storage=storage)
        if set(fleets) == {"prefill", "decode"}:
            return cls.disaggregated(cache_tb, prefill=fleets["prefill"],
                                     decode=fleets["decode"], router=router,
                                     balance_eps=balance_eps,
                                     partitioned=partitioned,
                                     storage=storage)
        raise ValueError(f"plan {spec!r} needs fleet= or prefill=+decode=")

    def to_json(self) -> str:
        return json.dumps({
            "cache_tb": self.cache_tb,
            "storage": None if self.storage is None
            else json.loads(self.storage.to_json()),
            "pools": [{"role": p.role, "fleet": list(p.fleet),
                       "router": p.router,
                       "balance_eps": "unset"
                       if isinstance(p.balance_eps, _UnsetEps)
                       else p.balance_eps,
                       "partitioned": p.partitioned}
                      for p in self.pools]})

    @classmethod
    def from_json(cls, payload: Union[str, dict]) -> "ResourcePlan":
        d = json.loads(payload) if isinstance(payload, str) else payload
        pools = tuple(PoolSpec(p["role"], tuple(p["fleet"]),
                               router=p.get("router"),
                               balance_eps=UNSET_EPS
                               if p.get("balance_eps", "unset") == "unset"
                               else p["balance_eps"],
                               partitioned=bool(p.get("partitioned", False)))
                      for p in d["pools"])
        storage = d.get("storage")
        return cls(d.get("cache_tb"), pools,
                   storage=None if storage is None
                   else StorageSpec.from_json(storage))


def _norm_storage(storage: Union[StorageSpec, str, None]
                  ) -> Optional[StorageSpec]:
    if isinstance(storage, str):
        return StorageSpec.parse(storage)
    return storage


def _fmt_tb(tb: Optional[float]) -> str:
    if tb is None:
        return "auto"
    return f"{tb:g}tb"


def _parse_tb(val: str) -> Optional[float]:
    val = val.strip().lower()
    if val == "auto":
        return None
    if val == "none":                     # ambiguous: auto or zero?
        raise ValueError("cache=none is ambiguous; use cache=0tb for no "
                         "cache or cache=auto for solver-sized")
    if val.endswith("tb"):
        val = val[:-2]
    return float(val)


# --------------------------------------------------------------------- #
# Plan transitions: the first-class reconfiguration event
# --------------------------------------------------------------------- #
@dataclass(frozen=True)
class PoolDelta:
    """Per-pool fleet change inside a transition: the replica types that
    must boot and the ones that drain (multiset difference of the old and
    new fleets — survivors are matched per type and keep serving)."""
    role: str
    boot: Tuple[str, ...] = ()
    drain: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.role not in ROLES:
            raise ValueError(f"unknown pool role {self.role!r}; one of "
                             f"{ROLES}")
        object.__setattr__(self, "boot", tuple(sorted(self.boot)))
        object.__setattr__(self, "drain", tuple(sorted(self.drain)))


@dataclass(frozen=True)
class PlanTransition:
    """The diff between two ``ResourcePlan``s — the first-class event the
    hourly loop prices and simulates instead of teleporting between
    plans.

    ``pools`` holds one ``PoolDelta`` per pool whose fleet changes
    (replicas to boot/drain per type); ``cache_from_tb``/``cache_to_tb``
    the cache reallocation (``None`` = unspecified on that side, no
    resize); ``storage_from``/``storage_to`` the typed tierings on each
    side (spec strings; ``None`` = untyped flat cache), so a tier resize
    at constant total is still a visible — and priced — event;
    ``ring_from``/``ring_to`` the store-owning pool's replica
    count before/after — a partitioned consistent-hash ring remaps
    ~``|m-n|/max(m,n)`` of its key space when it resizes, the KV
    rebalancing the engine models as bulk migration or cold misses.

    String grammar (``parse`` / ``str`` round-trip, like plans)::

        boot[serve]=h100:2 drain[serve]=l40:1 cache=4tb->2tb ring=3->2
        cache=dram:0.5tb+nvme_gen4:4tb->dram:0.25tb+nvme_gen4:2tb
    """
    pools: Tuple[PoolDelta, ...] = ()
    cache_from_tb: Optional[float] = None
    cache_to_tb: Optional[float] = None
    ring_from: int = 0
    ring_to: int = 0
    storage_from: Optional[str] = None
    storage_to: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "pools", tuple(self.pools))
        roles = [p.role for p in self.pools]
        if len(roles) != len(set(roles)):
            raise ValueError(f"duplicate pool roles in {roles}")

    @classmethod
    def diff(cls, old: "ResourcePlan", new: "ResourcePlan"
             ) -> "PlanTransition":
        """Transition from ``old`` to ``new``: per-pool multiset fleet
        diff (a pool present on one side only boots/drains wholesale, so
        a fused↔disaggregated topology change diffs cleanly too)."""
        from collections import Counter
        deltas = []
        olds = {p.role: p for p in old.pools}
        news = {p.role: p for p in new.pools}
        for role in ROLES:
            co = Counter(olds[role].fleet) if role in olds else Counter()
            cn = Counter(news[role].fleet) if role in news else Counter()
            if role not in olds and role not in news:
                continue
            boot = tuple((cn - co).elements())
            drain = tuple((co - cn).elements())
            if boot or drain:
                deltas.append(PoolDelta(role, boot, drain))
        return cls(tuple(deltas), cache_from_tb=old.cache_tb,
                   cache_to_tb=new.cache_tb,
                   ring_from=old.prefill.n_replicas,
                   ring_to=new.prefill.n_replicas,
                   storage_from=None if old.storage is None
                   else str(old.storage),
                   storage_to=None if new.storage is None
                   else str(new.storage))

    # ------------------------------------------------------------------ #
    @property
    def boots(self) -> Tuple[Tuple[str, str], ...]:
        """Every booting replica as ``(pool_role, replica_type)``."""
        return tuple((p.role, t) for p in self.pools for t in p.boot)

    @property
    def drains(self) -> Tuple[Tuple[str, str], ...]:
        return tuple((p.role, t) for p in self.pools for t in p.drain)

    @property
    def cache_delta_tb(self) -> float:
        """Cache reallocation in TB (0 when either side is unsized)."""
        if self.cache_from_tb is None or self.cache_to_tb is None:
            return 0.0
        return self.cache_to_tb - self.cache_from_tb

    @property
    def ring_changed(self) -> bool:
        return self.ring_from != self.ring_to

    @property
    def moved_ring_fraction(self) -> float:
        """Share of the key space a consistent-hash ring remaps when it
        resizes ``ring_from`` → ``ring_to`` (the minimal-movement bound:
        growth n→n+1 moves ~1/(n+1) of the keys)."""
        return ring_moved_fraction(self.ring_from, self.ring_to)

    @property
    def storage_changed(self) -> bool:
        """A retier at constant total (e.g. growing the DRAM share) is
        still a real reconfiguration event."""
        return self.storage_from != self.storage_to

    @property
    def is_noop(self) -> bool:
        return (not self.pools and self.cache_delta_tb == 0.0
                and not self.ring_changed and not self.storage_changed)

    def pool(self, role: str) -> Optional[PoolDelta]:
        for p in self.pools:
            if p.role == role:
                return p
        return None

    # ------------------------------------------------------------------ #
    # string / JSON round-trip
    # ------------------------------------------------------------------ #
    def __str__(self) -> str:
        parts = []
        for p in self.pools:
            if p.boot:
                parts.append(f"boot[{p.role}]={fleet_str(p.boot)}")
            if p.drain:
                parts.append(f"drain[{p.role}]={fleet_str(p.drain)}")
        if self.cache_from_tb is not None or self.cache_to_tb is not None \
                or self.storage_from is not None \
                or self.storage_to is not None:
            a = self.storage_from if self.storage_from is not None \
                else _fmt_tb(self.cache_from_tb)
            b = self.storage_to if self.storage_to is not None \
                else _fmt_tb(self.cache_to_tb)
            parts.append(f"cache={a}->{b}")
        if self.ring_from or self.ring_to:
            parts.append(f"ring={self.ring_from}->{self.ring_to}")
        return " ".join(parts)

    @classmethod
    def parse(cls, spec: str) -> "PlanTransition":
        """Inverse of ``str(transition)``."""
        boots: Dict[str, Tuple[str, ...]] = {}
        drains: Dict[str, Tuple[str, ...]] = {}
        cache_from = cache_to = None
        storage_from = storage_to = None
        ring_from = ring_to = 0
        for tok in spec.split():
            key, sep, val = tok.partition("=")
            key = key.strip().lower()
            if not sep:
                raise ValueError(f"bad transition token {tok!r} in "
                                 f"{spec!r}")
            if key.startswith("boot[") and key.endswith("]"):
                boots[key[5:-1]] = parse_fleet(val)
            elif key.startswith("drain[") and key.endswith("]"):
                drains[key[6:-1]] = parse_fleet(val)
            elif key == "cache":
                a, sep2, b = val.partition("->")
                if not sep2:
                    raise ValueError(f"cache token needs a->b in {spec!r}")
                if ":" in a:            # typed side: canonical spec string
                    sa = StorageSpec.parse(a)
                    storage_from, cache_from = str(sa), sa.total_tb
                else:
                    cache_from = _parse_tb(a)
                if ":" in b:
                    sb = StorageSpec.parse(b)
                    storage_to, cache_to = str(sb), sb.total_tb
                else:
                    cache_to = _parse_tb(b)
            elif key == "ring":
                a, sep2, b = val.partition("->")
                if not sep2:
                    raise ValueError(f"ring token needs a->b in {spec!r}")
                ring_from, ring_to = int(a), int(b)
            else:
                raise ValueError(f"unknown transition key {key!r} in "
                                 f"{spec!r}")
        deltas = tuple(PoolDelta(role, boots.get(role, ()),
                                 drains.get(role, ()))
                       for role in ROLES
                       if role in boots or role in drains)
        return cls(deltas, cache_from_tb=cache_from, cache_to_tb=cache_to,
                   ring_from=ring_from, ring_to=ring_to,
                   storage_from=storage_from, storage_to=storage_to)

    def to_json(self) -> str:
        return json.dumps({
            "pools": [{"role": p.role, "boot": list(p.boot),
                       "drain": list(p.drain)} for p in self.pools],
            "cache_from_tb": self.cache_from_tb,
            "cache_to_tb": self.cache_to_tb,
            "ring_from": self.ring_from, "ring_to": self.ring_to,
            "storage_from": self.storage_from,
            "storage_to": self.storage_to})

    @classmethod
    def from_json(cls, payload: Union[str, dict]) -> "PlanTransition":
        d = json.loads(payload) if isinstance(payload, str) else payload
        pools = tuple(PoolDelta(p["role"], tuple(p.get("boot", ())),
                                tuple(p.get("drain", ())))
                      for p in d.get("pools", ()))
        return cls(pools, cache_from_tb=d.get("cache_from_tb"),
                   cache_to_tb=d.get("cache_to_tb"),
                   ring_from=int(d.get("ring_from", 0)),
                   ring_to=int(d.get("ring_to", 0)),
                   storage_from=d.get("storage_from"),
                   storage_to=d.get("storage_to"))


def ring_moved_fraction(n_from: int, n_to: int) -> float:
    """Consistent-hashing minimal-movement bound: the key-space share
    remapped when the ring resizes ``n_from`` → ``n_to`` (shared by
    ``PlanTransition`` and the solver's migration estimate)."""
    return abs(n_to - n_from) / max(n_from, n_to, 1)


REBALANCE_MODES = ("migrate", "cold")


@dataclass(frozen=True)
class TransitionConfig:
    """How the engine (and the solver's switching costs) model a plan
    transition.  ``None`` anywhere an engine/solver accepts this config
    means the legacy instant-and-free reconfiguration (bit-reproduced).

    * ``boot_latency_s`` — warmup of a booted replica before it joins the
      serving set (``None`` = each type's ``ReplicaType.boot_s``; ``0.0``
      = instant join).
    * ``rebalance`` — partitioned-store ring resizes either ``migrate``
      reassigned KV entries (bytes over ``kv_transfer_gbps``, added load
      on the donors) or drop them ``cold`` (reassigned keys miss and
      re-prefill).
    * ``cache_ramp_s`` — a cache shrink evicts gradually over this window
      (in ``cache_ramp_steps`` steps) instead of teleporting to the new
      size.
    * ``drain`` — drained replicas finish their in-flight backlog powered
      (priced) instead of vanishing; ``decode_drain_s`` is the nominal
      residual per drained decode-pool replica (the analytic decode pool
      has no per-replica backlog to measure).
    * ``kv_transfer_gbps`` — migration bandwidth (``None`` = the serving
      model's ``kv_transfer_gbps``).
    """
    boot_latency_s: Optional[float] = None
    rebalance: str = "migrate"
    cache_ramp_s: float = 300.0
    cache_ramp_steps: int = 4
    drain: bool = True
    decode_drain_s: float = 20.0
    kv_transfer_gbps: Optional[float] = None

    def __post_init__(self):
        if self.rebalance not in REBALANCE_MODES:
            raise ValueError(f"rebalance must be one of {REBALANCE_MODES},"
                             f" got {self.rebalance!r}")

    def boot_s(self, type_name: str) -> float:
        """Warmup latency for one booted replica of the given type."""
        if self.boot_latency_s is not None:
            return float(self.boot_latency_s)
        return get_replica_type(type_name).boot_s

    @property
    def is_free(self) -> bool:
        """True when transitions cost nothing and take no time — the
        configuration whose trajectories bit-reproduce the legacy
        instant-switch path."""
        return (self.boot_latency_s == 0.0 and not self.drain
                and self.cache_ramp_s == 0.0)

    @classmethod
    def free(cls, rebalance: str = "migrate") -> "TransitionConfig":
        """Zero-cost transitions: instant boot, no drain accounting, no
        eviction ramp, free migration."""
        return cls(boot_latency_s=0.0, rebalance=rebalance,
                   cache_ramp_s=0.0, drain=False, decode_drain_s=0.0)


def enumerate_plans(prefill_fleets: Sequence[Sequence[str]],
                    decode_fleets: Sequence[Sequence[str]], *,
                    router: Optional[str] = None,
                    balance_eps: Union[float, None,
                                       _UnsetEps] = UNSET_EPS
                    ) -> List[ResourcePlan]:
    """Cross product of per-pool fleet enumerations (feed each side from
    ``repro_torch.core.solver.enumerate_fleets``) into open disaggregated
    candidate plans for the solver's (cache, prefill, decode) search."""
    return [ResourcePlan.disaggregated(None, prefill=pf, decode=df,
                                       router=router,
                                       balance_eps=balance_eps)
            for pf in prefill_fleets for df in decode_fleets]
