"""Wear-aware tiered cache storage (paper Figs. 19-20 made first-class).

The paper's central claim is that *storage* embodied carbon is the hidden
cost of LLM caching — yet a flat ``kg/TB × allocation / calendar-lifetime``
model (the seed's ``HardwareSpec.ssd_kg_per_tb`` path) cannot see the two
things that actually determine how fast that carbon is burned:

* **device class** — DRAM, TLC/QLC NAND and spinning rust differ by an
  order of magnitude in embodied carbon per TB, idle draw, bandwidth and
  write endurance; and
* **cache churn** — every insert/growth/migration is a device write, and
  an endurance-rated device (DWPD/TBW) whose write rate exceeds its
  rating dies *before* its calendar lifetime, so its embodied carbon
  amortizes over the **wear-driven** lifetime
  ``min(calendar, endurance / write-rate)`` (EcoServe's argument that
  embodied amortization must be provisioned against real device life).

This module provides:

* ``StorageDevice`` — the per-class datasheet: embodied kg/TB, idle
  W/TB, read/write bandwidth, calendar lifetime, write endurance
  (DWPD + write-amplification factor) and active I/O energy, with the
  endurance math (``tbw_bytes`` / ``wear_lifetime_s`` /
  ``effective_lifetime_s``).
* ``STORAGE_DEVICES`` — the registry (``dram``, ``nvme_gen4``,
  ``nvme_gen5``, ``qlc_ssd``, ``hdd``).  ``nvme_gen4`` is the
  **reference device**: its embodied/power/lifetime/read-bandwidth
  constants equal the legacy ``HardwareSpec`` scalars
  (30 kg/TB, 1.5 W/TB, 5 y, 14 GB/s), so a single-tier default spec
  bit-reproduces the flat-SSD pricing path.
* ``StorageTier`` / ``StorageSpec`` — a typed tiering of the cache
  allocation (``"dram:0.5tb+nvme_gen4:4tb"``; tier 0 is the hot tier)
  with full parse/str/JSON round-trip; ``ResourcePlan`` carries one and
  ``CarbonModel`` prices it.
* ``TieredKVStore`` — a two-tier hot/cold ``KVStore``: new entries land
  hot, hits promote cold entries, hot-tier pressure demotes by recency;
  per-tier read bandwidth sets the KV load time (TTFT emerges from tier
  placement) and per-tier write counters feed the wear clock.
* ``WriteAwareAdmission`` — only cache contexts whose *expected* reuse
  amortizes the write energy + wear carbon of inserting them.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.kvstore import CacheEntry, KVStore

SECONDS_PER_YEAR = 365.25 * 24 * 3600
TB = 1e12


# --------------------------------------------------------------------- #
# Device registry
# --------------------------------------------------------------------- #
@dataclass(frozen=True)
class StorageDevice:
    """One storage device class a cache tier can be provisioned on.

    ``idle_w_per_tb`` is the allocation-proportional draw (the legacy
    flat ``ssd_power_w_per_tb`` generalized per class); ``read_gbps`` is
    the *effective* KV-load bandwidth of the class in this serving stack
    (the reference ``nvme_gen4`` matches ``ServingModel.ssd_read_gbps``).
    ``dwpd`` is the rated drive-writes-per-day endurance over the
    calendar lifetime (``None`` = not endurance-limited: DRAM, HDD);
    ``write_amp`` converts host writes into endurance-consuming device
    writes (KV churn is large-sequential, but steady-state garbage
    collection still amplifies).  ``read_j_per_gb``/``write_j_per_gb``
    price the active I/O energy of tier migrations and the admission
    policy's write-cost side."""
    name: str
    embodied_kg_per_tb: float
    idle_w_per_tb: float
    read_gbps: float
    write_gbps: float
    lifetime_years: float = 5.0
    dwpd: Optional[float] = None          # None = no endurance limit
    write_amp: float = 1.0
    read_j_per_gb: float = 0.0
    write_j_per_gb: float = 0.0

    # ---- endurance math ---- #
    def tbw_bytes(self, capacity_tb: float) -> Optional[float]:
        """Rated write endurance of a ``capacity_tb`` allocation in host
        bytes (DWPD × capacity × rated-life days); None when the class
        is not endurance-limited."""
        if self.dwpd is None:
            return None
        return self.dwpd * capacity_tb * TB \
            * self.lifetime_years * 365.25

    def wear_lifetime_s(self, capacity_tb: float,
                        write_bytes_per_s: float) -> Optional[float]:
        """Time to burn through the allocation's endurance at the given
        host write rate (amplified by ``write_amp``)."""
        tbw = self.tbw_bytes(capacity_tb)
        if tbw is None or tbw <= 0.0 or write_bytes_per_s <= 0.0:
            return None                 # zero alloc wears nothing
        return tbw / (write_bytes_per_s * self.write_amp)

    def effective_lifetime_s(self, capacity_tb: float,
                             write_bytes_per_s: float = 0.0) -> float:
        """The lifetime embodied carbon actually amortizes over:
        ``min(calendar, endurance / write-rate)``.  With no write rate
        (or no endurance rating) this is exactly the calendar lifetime —
        the branch the legacy flat-SSD pricing bit-reproduces."""
        cal = self.lifetime_years * SECONDS_PER_YEAR
        wear = self.wear_lifetime_s(capacity_tb, write_bytes_per_s)
        if wear is None or wear >= cal:
            return cal
        return wear

    def io_energy_j(self, read_bytes: float = 0.0,
                    write_bytes: float = 0.0) -> float:
        return (read_bytes * self.read_j_per_gb
                + write_bytes * self.write_j_per_gb) / 1e9


# The reference device MUST keep embodied 30 kg/TB, idle 1.5 W/TB,
# lifetime 5 y and read 14 GB/s — the legacy ``HardwareSpec.ssd_*`` /
# ``ServingModel.ssd_read_gbps`` constants — so a single default tier
# bit-reproduces the flat-SSD energy/embodied path (tested).
STORAGE_DEVICES: Dict[str, StorageDevice] = {
    "dram": StorageDevice(
        "dram", embodied_kg_per_tb=60.0,      # ~30.8 kg / 512 GB DDR4 (ACT)
        idle_w_per_tb=55.0,                   # ~3.5 W per 64 GB RDIMM
        read_gbps=50.0, write_gbps=50.0,      # host-memory KV copy path
        lifetime_years=7.0, dwpd=None,        # no NAND to wear out
        read_j_per_gb=0.02, write_j_per_gb=0.02),
    "nvme_gen4": StorageDevice(
        "nvme_gen4", embodied_kg_per_tb=30.0, idle_w_per_tb=1.5,
        read_gbps=14.0, write_gbps=6.0,       # effective KV-load striping
        lifetime_years=5.0, dwpd=3.0,         # write-intensive enterprise
        write_amp=2.5,                        # large-sequential KV churn
        read_j_per_gb=1.0, write_j_per_gb=3.0),
    "nvme_gen5": StorageDevice(
        "nvme_gen5", embodied_kg_per_tb=35.0, idle_w_per_tb=2.2,
        read_gbps=24.0, write_gbps=11.0,
        lifetime_years=5.0, dwpd=3.5, write_amp=2.5,
        read_j_per_gb=1.2, write_j_per_gb=3.5),
    "qlc_ssd": StorageDevice(
        "qlc_ssd", embodied_kg_per_tb=24.0,   # denser NAND, fewer dies/TB
        idle_w_per_tb=1.2,
        read_gbps=10.0, write_gbps=2.5,
        lifetime_years=5.0, dwpd=0.3,         # read-optimized endurance
        write_amp=4.0,                        # QLC GC amplifies harder
        read_j_per_gb=1.2, write_j_per_gb=4.5),
    "hdd": StorageDevice(
        "hdd", embodied_kg_per_tb=6.0, idle_w_per_tb=0.8,
        read_gbps=0.25, write_gbps=0.25,
        lifetime_years=5.0, dwpd=None,        # magnetic media: no wear-out
        read_j_per_gb=30.0, write_j_per_gb=30.0),
}

DEFAULT_DEVICE = "nvme_gen4"


def get_storage_device(name: str) -> StorageDevice:
    try:
        return STORAGE_DEVICES[name]
    except KeyError:
        raise KeyError(f"unknown storage device {name!r}; one of "
                       f"{sorted(STORAGE_DEVICES)}") from None


def device_hardware_spec(device: StorageDevice, base=None):
    """Project a storage device's datasheet onto the legacy
    ``HardwareSpec`` SSD scalars — the bridge that turns the fig19/fig20
    lifetime/embodied sweeps into device-parameter sweeps (the default
    ``nvme_gen4`` device projects to exactly ``HardwareSpec()``'s
    values, so default-device results are zero-diff)."""
    import dataclasses

    from repro_torch.core.carbon import HardwareSpec
    return dataclasses.replace(
        base if base is not None else HardwareSpec(),
        ssd_kg_per_tb=device.embodied_kg_per_tb,
        ssd_lifetime_years=device.lifetime_years,
        ssd_power_w_per_tb=device.idle_w_per_tb)


# --------------------------------------------------------------------- #
# Typed tier specs
# --------------------------------------------------------------------- #
@dataclass(frozen=True)
class StorageTier:
    """One sized tier: a device class name plus its capacity.  Device
    objects are resolved through the registry so tiers stay JSON-plain."""
    device: str
    capacity_tb: float

    def __post_init__(self):
        get_storage_device(self.device)          # validate early
        if self.capacity_tb < 0:
            raise ValueError("tier capacity must be >= 0")

    @property
    def dev(self) -> StorageDevice:
        return get_storage_device(self.device)

    def __str__(self) -> str:
        return f"{self.device}:{self.capacity_tb:g}tb"


@dataclass(frozen=True)
class StorageSpec:
    """A typed tiering of the cache allocation.  Tier order is
    significance order: tier 0 is the *hot* tier, the last tier is the
    cold bulk.  One tier = a flat allocation on that device.  The
    two-tier form is *inclusive* (see ``TieredKVStore``): the cold tier
    is authoritative and its capacity is the usable cache size
    (``usable_tb``); the hot tier is a read mirror allocated on top —
    both tiers' allocations draw idle power and amortize embodied
    carbon (``total_tb`` prices the whole spec).

    String grammar (``parse`` / ``str`` round-trip, also embedded in
    plan strings as ``cache=dram:0.5tb+nvme_gen4:4tb``)::

        nvme_gen4:4tb
        dram:0.5tb+nvme_gen4:4tb
    """
    tiers: Tuple[StorageTier, ...]

    def __post_init__(self):
        object.__setattr__(self, "tiers", tuple(self.tiers))
        if not self.tiers:
            raise ValueError("a storage spec needs at least one tier")
        if len(self.tiers) > 2:
            raise ValueError("at most two tiers (hot + cold) are "
                             f"modeled, got {len(self.tiers)}")
        names = [t.device for t in self.tiers]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate tier devices in {names}")

    # ---- constructors ---- #
    @classmethod
    def flat(cls, capacity_tb: float,
             device: str = DEFAULT_DEVICE) -> "StorageSpec":
        """Single-tier spec; with the default device this is the legacy
        flat-SSD model, bit-reproduced by the pricing paths."""
        return cls((StorageTier(device, float(capacity_tb)),))

    @classmethod
    def tiered(cls, hot_tb: float, cold_tb: float, *,
               hot_device: str = "dram",
               cold_device: str = DEFAULT_DEVICE) -> "StorageSpec":
        return cls((StorageTier(hot_device, float(hot_tb)),
                    StorageTier(cold_device, float(cold_tb))))

    @classmethod
    def parse(cls, spec: str) -> "StorageSpec":
        tiers = []
        for part in spec.strip().split("+"):
            name, sep, cap = part.partition(":")
            if not sep:
                raise ValueError(f"bad storage tier {part!r} in {spec!r} "
                                 "(want device:SIZEtb)")
            cap = cap.strip().lower()
            if cap.endswith("tb"):
                cap = cap[:-2]
            tiers.append(StorageTier(name.strip().lower(), float(cap)))
        return cls(tuple(tiers))

    # ---- accessors ---- #
    @property
    def total_tb(self) -> float:
        return float(sum(t.capacity_tb for t in self.tiers))

    @property
    def usable_tb(self) -> float:
        """Usable cache capacity: the authoritative cold tier for an
        inclusive two-tier spec, the whole allocation for a flat one."""
        return self.cold.capacity_tb if self.is_tiered else self.total_tb

    @property
    def hot(self) -> StorageTier:
        return self.tiers[0]

    @property
    def cold(self) -> StorageTier:
        return self.tiers[-1]

    @property
    def is_tiered(self) -> bool:
        return len(self.tiers) > 1

    @property
    def idle_w(self) -> float:
        """Allocation-proportional draw of every tier (the flat
        ``ssd_tb × ssd_power_w_per_tb`` term generalized)."""
        return sum(t.capacity_tb * t.dev.idle_w_per_tb for t in self.tiers)

    def read_gbps(self, tier: int) -> float:
        return self.tiers[tier].dev.read_gbps

    def scaled_to(self, total_tb: float) -> "StorageSpec":
        """Rescale every tier proportionally to a new total (the
        gradual-shrink ramp resizes tiered stores through this).  A
        zero-capacity spec has no proportions to keep: the whole target
        lands on the cold/bulk tier, preserving the device topology."""
        cur = self.total_tb
        if cur <= 0.0:
            if not self.is_tiered:
                return StorageSpec.flat(total_tb, self.cold.device)
            return StorageSpec((replace(self.hot, capacity_tb=0.0),
                                replace(self.cold,
                                        capacity_tb=float(total_tb))))
        f = total_tb / cur
        return StorageSpec(tuple(replace(t, capacity_tb=t.capacity_tb * f)
                                 for t in self.tiers))

    # ---- round-trip ---- #
    def __str__(self) -> str:
        return "+".join(str(t) for t in self.tiers)

    def to_json(self) -> str:
        return json.dumps({"tiers": [{"device": t.device,
                                      "capacity_tb": t.capacity_tb}
                                     for t in self.tiers]})

    @classmethod
    def from_json(cls, payload: Union[str, dict]) -> "StorageSpec":
        d = json.loads(payload) if isinstance(payload, str) else payload
        return cls(tuple(StorageTier(t["device"], float(t["capacity_tb"]))
                         for t in d["tiers"]))


def enumerate_storage_specs(sizes_tb: Sequence[float], *,
                            devices: Sequence[str] = (DEFAULT_DEVICE,),
                            hot_device: str = "dram",
                            hot_fracs: Sequence[float] = ()
                            ) -> List[StorageSpec]:
    """Candidate specs for the solver's storage search.

    Without ``hot_fracs``: flat allocations of each device at each size.
    With ``hot_fracs``: every candidate is a two-tier spec where
    ``hot_frac`` of the total rides ``hot_device`` — include ``0.0`` to
    keep flat-equivalent candidates in the set (a zero-capacity hot tier
    behaves exactly like the flat cold device).  A controller run needs
    all candidates on one store topology, which is why the two forms are
    not mixed.  Duplicates (e.g. the zero size at every frac) collapse."""
    out: Dict[str, StorageSpec] = {}
    for d in devices:
        for s in sizes_tb:
            s = max(float(s), 0.0)
            if not hot_fracs:
                sp = StorageSpec.flat(s, d)
                out[str(sp)] = sp
                continue
            for f in hot_fracs:
                if not 0.0 <= f < 1.0:
                    raise ValueError(f"hot_frac must be in [0, 1), got "
                                     f"{f}")
                sp = StorageSpec.tiered(f * s, (1.0 - f) * s,
                                        hot_device=hot_device,
                                        cold_device=d)
                out[str(sp)] = sp
    return list(out.values())


def normalize_storage_candidates(specs: Sequence[Union[StorageSpec, str]]
                                 ) -> List[StorageSpec]:
    """Coerce a mixed candidate list onto one store topology: when any
    candidate is tiered, flat candidates become zero-hot two-tier specs
    (a 0 TB mirror behaves exactly like the flat cold device), so
    ``--storage nvme_gen4:8tb dram:0.5tb+nvme_gen4:8tb`` just works.
    Candidates that still disagree on devices raise downstream."""
    out = [StorageSpec.parse(s) if isinstance(s, str) else s
           for s in specs]
    hot = next((sp.hot.device for sp in out if sp.is_tiered), None)
    if hot is None:
        return out
    return [sp if sp.is_tiered
            else StorageSpec.tiered(0.0, sp.total_tb, hot_device=hot,
                                    cold_device=sp.cold.device)
            for sp in out]


# --------------------------------------------------------------------- #
# Write-aware admission
# --------------------------------------------------------------------- #
class WriteAwareAdmission:
    """Admit an insert only when its expected reuse amortizes the write.

    Cost of caching ``B`` bytes on the insert tier: the active write
    energy ``B × write_j_per_gb`` plus the wear carbon — the slice of the
    device's embodied budget the write consumes,
    ``B × write_amp / TBW_per_TB × embodied_g_per_TB`` (expressed as an
    energy-equivalent at the reference CI so both sides compare in
    joules).  Benefit: the expected number of future hits times the
    prefill energy a hit saves (``benefit_j_per_byte``, derived from the
    serving model's uncached prefill throughput by
    ``write_aware_admission``).  The expected hit count is estimated
    online from the store's own stream (hits per insertion, EMA-free —
    cumulative stats are stable at steady state); conversation turns ≥ 2
    are always admitted (the prefix is demonstrably live).
    """

    def __init__(self, device: StorageDevice, benefit_j_per_byte: float,
                 *, ci_g_per_kwh: float = 300.0, min_expected_hits: float
                 = 0.02, safety: float = 1.0):
        self.device = device
        self.benefit_j_per_byte = float(benefit_j_per_byte)
        self.ci = float(ci_g_per_kwh)
        self.min_expected_hits = float(min_expected_hits)
        self.safety = float(safety)

    def wear_g_per_byte(self) -> float:
        """Embodied carbon consumed per host byte written: the write
        burns ``write_amp`` bytes of a TBW budget that carries the
        device's whole embodied bill."""
        dev = self.device
        tbw_per_tb = dev.tbw_bytes(1.0)
        if tbw_per_tb is None:
            return 0.0
        return dev.write_amp * dev.embodied_kg_per_tb * 1000.0 / tbw_per_tb

    def write_cost_j_per_byte(self) -> float:
        """Write energy plus wear carbon converted to energy-equivalent
        joules at the reference CI (g / (g/kWh) → kWh → J)."""
        dev = self.device
        energy = dev.write_j_per_gb / 1e9
        wear_j = self.wear_g_per_byte() / max(self.ci, 1e-9) * 3.6e6
        return energy + wear_j

    def expected_hits(self, store: KVStore) -> float:
        st = store.stats
        if st.insertions < 50:          # cold start: admit everything
            return float("inf")
        return st.hits / st.insertions

    def admit(self, store: KVStore, size_bytes: float, *,
              turn: int = 1) -> bool:
        if turn > 1 or size_bytes <= 0.0:     # free writes cost nothing
            return True
        eh = max(self.expected_hits(store), self.min_expected_hits)
        benefit = eh * self.benefit_j_per_byte * size_bytes
        cost = self.safety * self.write_cost_j_per_byte() * size_bytes
        return benefit >= cost


def write_aware_admission(model, carbon, device: Union[str, StorageDevice],
                          *, ci_g_per_kwh: float = 300.0,
                          safety: float = 1.0) -> WriteAwareAdmission:
    """Build the admission gate from a ``ServingModel`` + ``CarbonModel``:
    a reused byte saves the prefill compute its tokens would have cost —
    the GPU power *span* (utilization-dependent part) over the uncached
    prefill throughput."""
    if isinstance(device, str):
        device = get_storage_device(device)
    hw = carbon.hw
    span_w = hw.gpu_power_max_w - hw.gpu_power_idle_w
    j_per_token = span_w * model.gpu_util_prefill * 4.0 \
        / model.prefill_tok_per_s + span_w / model.prefill_tok_per_s
    benefit_j_per_byte = j_per_token / model.kv_bytes_per_token
    return WriteAwareAdmission(device, benefit_j_per_byte,
                               ci_g_per_kwh=ci_g_per_kwh, safety=safety)


# --------------------------------------------------------------------- #
# Two-tier hot/cold store
# --------------------------------------------------------------------- #
class TieredKVStore(KVStore):
    """Hot/cold two-tier ``KVStore`` (spec tier 0 = hot, tier 1 = cold).

    The design is *inclusive*: the cold bulk tier is authoritative — it
    holds every cached entry and its capacity is the store's usable
    capacity — while the hot tier (DRAM) *mirrors* the most recently
    used entries.  Consequences:

    * **Writes** (inserts, growth, migration adoptions) always land on
      the cold device, so cold-tier wear is *identical* to the flat
      store's — the hot tier never amplifies NAND writes.
    * **Promotion** on a cold hit copies the entry into the mirror
      (cold read + DRAM fill, accounted as I/O energy); **demotion**
      under mirror pressure just drops the copy (the cold original is
      authoritative — no write-back).
    * **Reads**: a hit served from the mirror loads KV at the hot
      device's bandwidth, a cold hit at the cold device's.
      ``last_hit_tier`` reports where the most recent ``account``/
      ``lookup`` hit resided *before* promotion — that is the load path
      the request actually experienced, which is how TTFT emerges from
      tier placement.

    ``tier_written`` accumulates host bytes written per tier (mirror
    fills hot, authoritative writes cold); ``io_energy_j`` accumulates
    the active energy of promotions, drained by the engine into each
    window's operational carbon.  Single-tier specs should use a plain
    ``KVStore`` (the engine's flat path); this class asserts a two-tier
    spec."""

    def __init__(self, spec: StorageSpec, policy, kv_bytes_per_token: float,
                 admission=None):
        if not spec.is_tiered:
            raise ValueError("TieredKVStore needs a two-tier spec; use a "
                             "plain KVStore for flat allocations")
        super().__init__(spec.cold.capacity_tb * TB, policy,
                         kv_bytes_per_token)
        self.spec = spec
        self.admission = admission
        self.hot_capacity_bytes = spec.hot.capacity_tb * TB
        self.hot_used_bytes = 0.0
        # mirror index: the tier-0 entries, so demotion never scans the
        # whole (much larger) cold-resident entry population
        self._hot: Dict[str, CacheEntry] = {}
        self.tier_written = [0.0, 0.0]
        self.io_energy_j = 0.0
        self.promotions = 0
        self.demotions = 0
        self.last_hit_tier = -1

    # ---- mirror plumbing ---- #
    def _mirror(self, e: CacheEntry, dram_write_bytes: float):
        """Install (or keep) ``e`` in the hot mirror after writing
        ``dram_write_bytes`` of it to DRAM, then drop LRU mirror entries
        until the hot tier fits.  Entries larger than the whole mirror
        stay cold-only."""
        size = e.size_bytes
        if size > self.hot_capacity_bytes:
            if e.tier == 0:              # grew past the mirror: drop
                self._drop_hot(e)
            return
        if e.tier != 0:
            e.tier = 0
            self.hot_used_bytes += size
            self._hot[e.key] = e
        self.tier_written[0] += dram_write_bytes
        self.io_energy_j += self.spec.hot.dev.io_energy_j(
            write_bytes=dram_write_bytes)
        if self.hot_used_bytes > self.hot_capacity_bytes:
            # KV entries are hundreds of MB to GB, so the mirror holds
            # hundreds of entries — the per-overflow recency sort is
            # cheap at this population (unlike the base store's
            # 10^5-entry eviction index, which needs the batched path)
            lru = sorted((h for h in self._hot.values() if h is not e),
                         key=lambda h: h.last_access)
            for h in lru:
                if self.hot_used_bytes <= self.hot_capacity_bytes:
                    break
                self._drop_hot(h)

    def _drop_hot(self, e: CacheEntry):
        """Demotion: drop the mirror copy (the cold original is
        authoritative — no write-back I/O)."""
        e.tier = 1
        self.hot_used_bytes -= e.size_bytes
        self._hot.pop(e.key, None)
        self.demotions += 1

    def _promote(self, e: CacheEntry):
        """Cold hit: copy into the mirror (cold read + DRAM fill)."""
        size = e.size_bytes
        if size > self.hot_capacity_bytes:
            return
        self.io_energy_j += self.spec.cold.dev.io_energy_j(
            read_bytes=size)
        self.promotions += 1
        self._mirror(e, size)

    def drain_io_energy_j(self) -> float:
        j, self.io_energy_j = self.io_energy_j, 0.0
        return j

    def read_gbps_for(self, tier: int) -> float:
        return self.spec.read_gbps(0 if tier <= 0 else 1)

    # ---- CacheStore behaviour probes ---- #
    @property
    def is_tiered(self) -> bool:
        return True

    def clone_empty(self, capacity_bytes: float) -> KVStore:
        raise NotImplementedError(
            "TieredKVStore is shared-only: ring rebalance never clones it")

    # ---- overridden KVStore surface ---- #
    def account(self, key: str, context_tokens: int, prompt_tokens: int,
                now: float, turn: int = 1, collect_stats: bool = True,
                blocks=None, weight: float = 1.0):
        # ``blocks`` pass through to the (whole-context) base path, which
        # ignores them — a tiered radix store is a future combination
        e0 = self.entries.get(key)
        pre = (e0, e0.size_bytes, e0.tier) if e0 is not None else None
        ret = super().account(key, context_tokens, prompt_tokens, now,
                              turn, collect_stats, blocks, weight=weight)
        # ret >= 0 is the only true hit (a pre-captured entry can still
        # be evicted by a due gradual-resize step inside the base call,
        # making the re-insert a fresh cold write, not a grow)
        self._post_write(key, pre if ret >= 0 else None)
        return ret

    def insert(self, key: str, num_tokens: int, now: float, *,
               turn: int = 1, payload=None, size_bytes=None,
               weight: float = 1.0) -> Optional[CacheEntry]:
        e0 = self.entries.get(key)
        pre = (e0, e0.size_bytes, e0.tier) if e0 is not None else None
        out = super().insert(key, num_tokens, now, turn=turn,
                             payload=payload, size_bytes=size_bytes,
                             weight=weight)
        if out is not None:
            # a grow only if the surviving object is the captured one
            self._post_write(key, pre if pre is not None
                             and out is pre[0] else None)
        return out

    def lookup(self, key: str, context_tokens: int, now: float
               ) -> Optional[CacheEntry]:
        e = super().lookup(key, context_tokens, now)
        if e is None:
            self.last_hit_tier = -1
        else:
            self.last_hit_tier = e.tier
            if e.tier != 0:
                self._promote(e)
        return e

    def _post_write(self, key: str, pre):
        """Reconcile the mirror after the base class handled a
        lookup+insert: authoritative (cold) writes were already counted
        by the base wear clock; here the cold tier's clock mirrors them
        and the hot mirror is filled/refreshed.  ``pre`` is the
        ``(entry, size, tier)`` snapshot when the call was a real grow
        of that same entry, else None (fresh insert / refused)."""
        e = self.entries.get(key)
        if pre is None:
            self.last_hit_tier = -1
            if e is not None:            # fresh insert: cold write-through
                e.tier = 1               # authoritative copy lands cold
                self.tier_written[1] += e.size_bytes
                self._mirror(e, e.size_bytes)
            return
        _, pre_size, pre_tier = pre
        self.last_hit_tier = pre_tier    # load path the request saw
        if e is None:
            return                       # evicted during its own grow
        grow = e.size_bytes - pre_size
        if grow > 0:
            self.tier_written[1] += grow
        if pre_tier != 0:
            self._promote(e)             # copies the full grown entry
        elif grow > 0:
            self.hot_used_bytes += grow  # mirror copy grew in place
            self._mirror(e, grow)

    def _evict(self, key: str):
        e = self.entries.get(key)
        if e is not None and e.tier == 0:
            self._drop_hot(e)
        super()._evict(key)

    def pop_entry(self, key: str) -> CacheEntry:
        e = self.entries.get(key)
        if e is not None and e.tier == 0:
            self._drop_hot(e)            # leaves the mirror with it
        return super().pop_entry(key)

    def adopt(self, entry: CacheEntry, now: float) -> bool:
        entry.tier = 1                   # migrations land in the bulk tier
        ok = super().adopt(entry, now)
        if ok:
            self.tier_written[1] += entry.size_bytes
        return ok

    def apply_spec(self, spec: StorageSpec, now: float, *,
                   ramp_s: float = 0.0, steps: int = 4):
        """Retier/resize from a plan change: the mirror boundary moves
        immediately (demotions are free drops), the *cold* capacity
        shrink rides the gradual-eviction ramp exactly like a flat
        resize (``schedule_resize``), so tier resizes are priced by the
        transition machinery (staged evictions folded into the
        next window)."""
        if not spec.is_tiered:
            raise ValueError("cannot retier a TieredKVStore to a flat "
                             "spec mid-day (store topology is fixed)")
        if [t.device for t in spec.tiers] != \
                [t.device for t in self.spec.tiers]:
            raise ValueError("tier devices are fixed for the day; only "
                             "capacities may change")
        self.spec = spec
        self.hot_capacity_bytes = spec.hot.capacity_tb * TB
        if self.hot_used_bytes > self.hot_capacity_bytes:
            for h in sorted(self._hot.values(),
                            key=lambda h: h.last_access):
                if self.hot_used_bytes <= self.hot_capacity_bytes:
                    break
                self._drop_hot(h)
        cold = spec.cold.capacity_tb * TB
        if ramp_s > 0.0:
            self.schedule_resize(cold, now, ramp_s, steps=steps)
        else:
            self.resize(cold, now)
