"""Carbon accounting (paper §2.3, §3.2.1 — Eqs. 1–5).

    C = E·CI  +  S_alloc·(T/LT)·C_e,SSD_unit  +  Σ_comp (T/LT)·C_e,comp

Units: energy kWh, CI gCO₂e/kWh, embodied carbon kgCO₂e (converted to g),
time seconds, storage TB.

Fleets may be *heterogeneous*: a ``ReplicaType`` bundles a per-generation
``HardwareSpec`` (TDP, embodied kgCO₂e, service lifetime) with a
``perf_scale`` relative to the reference platform and an ``amortized_frac``
— the share of the server's embodied carbon already written off by prior
service (GreenLLM's argument for keeping old-generation GPUs in the mix).
``CarbonModel.energy_kwh`` / ``compute_embodied_g`` accept either a bare
replica count (homogeneous reference fleet, the seed behaviour) or a
``types`` list naming one ``ReplicaType`` per replica.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

SECONDS_PER_YEAR = 365.25 * 24 * 3600


@dataclass(frozen=True)
class HardwareSpec:
    """Paper Table 1 platform (4×L40 server) by default; TPU v5e variant
    provided for the hardware-adaptation scenario. These are inputs of the
    simulated fleet (one server generation each), not figures of the card
    this package runs on."""
    name: str = "l40-server"
    embodied_gpu_kg: float = 106.4          # 4× NVIDIA L40
    embodied_cpu_kg: float = 9.3            # AMD 7453
    embodied_mem_kg: float = 30.8           # 512 GB DDR4
    ssd_kg_per_tb: float = 30.0             # ACT model (sensitivity: 30–90)
    lifetime_years: float = 5.0
    ssd_lifetime_years: float = 5.0
    max_ssd_tb: float = 16.0
    # operational power (W)
    gpu_power_max_w: float = 1200.0         # 4× 300 W TDP
    gpu_power_idle_w: float = 420.0         # serving-loaded baseline
    cpu_power_w: float = 225.0
    mem_power_w: float = 40.0
    ssd_power_w_per_tb: float = 1.5         # enterprise NVMe ~12 W / 8 TB

    @property
    def embodied_compute_kg(self) -> float:
        return self.embodied_gpu_kg + self.embodied_cpu_kg + self.embodied_mem_kg


TPU_V5E_SPEC = HardwareSpec(
    name="tpu-v5e-4",
    embodied_gpu_kg=70.0,                   # 4× v5e chips + board (ACT-style)
    embodied_cpu_kg=9.3, embodied_mem_kg=30.8,
    gpu_power_max_w=4 * 220.0, gpu_power_idle_w=4 * 60.0,
)


# --------------------------------------------------------------------- #
# Heterogeneous replica types
# --------------------------------------------------------------------- #
@dataclass(frozen=True)
class ReplicaType:
    """One hardware generation a serving replica can run on.

    ``perf_scale`` is the throughput multiplier vs the reference platform
    (the 4×L40 server the performance profile is calibrated to): prefill
    compute and decode step time are divided by it. ``amortized_frac`` is
    the share of the server's embodied carbon already amortized by prior
    service, so only ``(1 - amortized_frac)`` of ``embodied_compute_kg``
    is charged over the remaining ``hw.lifetime_years`` — the reason an
    old-generation fleet can be the greener choice on clean grids even
    though it burns more energy per token. ``boot_s`` is the warmup
    latency of a freshly provisioned replica — minutes-scale in practice
    (scheduler placement + image pull + ~100 GB of weights over shared
    storage + engine compile/CUDA-graph capture, cf. EcoServe's
    provisioning overheads) — during which it draws boot power without
    serving; the per-type cost a plan transition prices.
    """
    name: str
    hw: HardwareSpec
    perf_scale: float = 1.0
    amortized_frac: float = 0.0
    boot_s: float = 300.0

    @property
    def effective_embodied_kg(self) -> float:
        return (1.0 - self.amortized_frac) * self.hw.embodied_compute_kg

    def embodied_g(self, seconds: float) -> float:
        """Amortized embodied share of one replica over ``seconds``."""
        lt = self.hw.lifetime_years * SECONDS_PER_YEAR
        return (seconds / lt) * self.effective_embodied_kg * 1000.0

    def idle_energy_kwh(self, seconds: float) -> float:
        """Whole-server idle-level draw over ``seconds`` — the rate a
        booting (weights loading) or draining (backlog flushing) replica
        burns without serving; the single formula every transition-cost
        site (engine, solver, ``transition_energy_kwh``) prices with."""
        return self.server_power_w(0.0) * seconds / 3.6e6

    def server_power_w(self, gpu_util: float) -> float:
        """Whole-server draw (GPU + CPU + DRAM; SSD pool counted once at
        the cluster level) at the given average accelerator utilization."""
        hw = self.hw
        gpu_w = hw.gpu_power_idle_w + gpu_util * (hw.gpu_power_max_w
                                                  - hw.gpu_power_idle_w)
        return gpu_w + hw.cpu_power_w + hw.mem_power_w


# Registry of simulated fleet generations (inputs of the simulation, from
# paper Table 1 and its cited sources; none is a measurement of this
# package on a card). ``l40`` is the paper's reference platform
# (Table 1) and MUST keep perf_scale=1.0 / amortized_frac=0.0 so an
# all-l40 fleet bit-reproduces the homogeneous engine. a100 is the
# "old generation": slower per watt, but most of its embodied carbon is
# already written off (GreenLLM, arXiv 2412.20322). h100 is the "new
# generation": ~2.4x the throughput at higher TDP and a bigger embodied
# bill (HBM3 + larger die, full charge).
REPLICA_TYPES: Dict[str, ReplicaType] = {
    "l40": ReplicaType("l40", HardwareSpec()),
    "a100": ReplicaType(
        "a100",
        HardwareSpec(name="a100-server",
                     embodied_gpu_kg=150.0,          # 4× A100-80G (ACT-style)
                     gpu_power_max_w=4 * 400.0, gpu_power_idle_w=4 * 140.0),
        perf_scale=1.4, amortized_frac=0.6,           # ~3y into a 5y life
        boot_s=360.0),                                # 4×80 GB weight load
    "h100": ReplicaType(
        "h100",
        HardwareSpec(name="h100-server",
                     embodied_gpu_kg=190.0,          # 4× H100 SXM + HBM3
                     gpu_power_max_w=4 * 700.0, gpu_power_idle_w=4 * 180.0),
        perf_scale=2.4, boot_s=420.0),               # bigger image + compile
    "tpu_v5e": ReplicaType("tpu_v5e", TPU_V5E_SPEC, perf_scale=1.1,
                           boot_s=180.0),            # slice attach is fast
}


def get_replica_type(name: str) -> ReplicaType:
    try:
        return REPLICA_TYPES[name]
    except KeyError:
        raise KeyError(f"unknown replica type {name!r}; one of "
                       f"{sorted(REPLICA_TYPES)}") from None


def parse_fleet(spec: str) -> Tuple[str, ...]:
    """Parse a CLI fleet spec like ``"a100:2,l40:4"`` (or bare ``"h100"``
    for a single replica) into a per-replica type tuple."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, count = part.partition(":")
        name = name.strip()
        get_replica_type(name)                       # validate early
        out.extend([name] * (int(count) if count else 1))
    if not out:
        raise ValueError(f"empty fleet spec {spec!r}")
    return tuple(out)


def fleet_str(types: Sequence[str]) -> str:
    """Canonical compact rendering of a fleet mix (``"a100:2,l40:4"``)."""
    counts = Counter(types)
    return ",".join(f"{n}:{counts[n]}" for n in sorted(counts))


def fleet_capacity(types: Sequence[str]) -> float:
    """Total throughput in reference-server units (sum of perf scales)."""
    return float(sum(get_replica_type(t).perf_scale for t in types))


# KV rebalancing power draw per migration stream: donor NVMe read +
# receiver NVMe write (~12 W each under sustained sequential I/O) plus the
# NIC pair (~20 W) — the wire cost of moving partitioned-store state when
# the consistent-hash ring changes size
KV_MIGRATION_W = 45.0


def _tier_rates(storage, write_bytes_per_s) -> list:
    """Normalize the wear-clock input to one host-write rate per tier
    (scalar = the same flow-through rate everywhere; None = no wear)."""
    n = len(storage.tiers)
    if write_bytes_per_s is None:
        return [0.0] * n
    if isinstance(write_bytes_per_s, (int, float)):
        return [float(write_bytes_per_s)] * n
    rates = [float(r) for r in write_bytes_per_s]
    if len(rates) != n:
        raise ValueError(f"need one write rate per tier ({n}), got "
                         f"{len(rates)}")
    return rates


def kv_migration_energy_kwh(migrate_bytes: float,
                            kv_transfer_gbps: float) -> float:
    """Energy of streaming ``migrate_bytes`` of KV state between
    partitioned stores: transfer time at ``kv_transfer_gbps`` drawing
    ``KV_MIGRATION_W`` — shared by the engine's measured rebalance, the
    solver's estimate, and ``CarbonModel.transition_energy_kwh``."""
    return KV_MIGRATION_W * migrate_bytes / (kv_transfer_gbps * 1e9) / 3.6e6

# 2024 grid average carbon intensities, gCO2e/kWh (paper Fig 2a + Fig 8)
GRID_CI: Dict[str, float] = {
    "FR": 33.0, "SE": 45.0, "FI": 79.0, "ES": 124.0, "GB": 211.0,
    "CISO": 230.0, "NL": 268.0, "DE": 344.0, "PJM": 396.0, "TX": 431.0,
    "PL": 662.0, "MISO": 485.0,
}

# ordering used for the 12-grid sweep in Fig 8 (ascending CI)
FIG8_GRIDS = sorted(GRID_CI, key=GRID_CI.get)


@dataclass
class CarbonModel:
    hw: HardwareSpec = field(default_factory=HardwareSpec)

    # ---- Eq (2): operational ----
    def operational_g(self, energy_kwh: float, ci: float) -> float:
        return energy_kwh * ci

    # ---- Eq (4): cache (SSD) embodied, proportional to allocation ----
    def cache_embodied_g(self, alloc_tb: float, seconds: float, *,
                         storage=None,
                         write_bytes_per_s=None) -> float:
        """Embodied carbon of the cache allocation over ``seconds``.

        Legacy form (``storage=None``): the flat-SSD model — allocation
        × ``ssd_kg_per_tb`` amortized over the calendar
        ``ssd_lifetime_years`` (the seed behaviour, bit-stable).

        Typed form: ``storage`` is a ``repro_torch.core.storage.StorageSpec``
        (duck-typed — this module stays import-free of storage); each
        tier amortizes its own device's kg/TB over that device's
        *effective* lifetime.  ``write_bytes_per_s`` (a scalar applied
        to every tier, or one rate per tier — the engine passes per-tier
        measured rates, the solver a predicted one) engages the wear
        clock: an endurance-rated device written faster than its DWPD
        rating dies before its calendar lifetime, so its embodied carbon
        amortizes over ``endurance / write-rate`` instead (paper Figs.
        19-20's hidden cost, made decidable per hour).  With no write
        rate the device path takes the calendar branch and a default
        single-tier spec bit-reproduces the legacy value."""
        if storage is None:
            lt = self.hw.ssd_lifetime_years * SECONDS_PER_YEAR
            return alloc_tb * (seconds / lt) * self.hw.ssd_kg_per_tb \
                * 1000.0
        rates = _tier_rates(storage, write_bytes_per_s)
        total = 0.0
        for tier, rate in zip(storage.tiers, rates):
            lt = tier.dev.effective_lifetime_s(tier.capacity_tb, rate)
            total += tier.capacity_tb * (seconds / lt) \
                * tier.dev.embodied_kg_per_tb * 1000.0
        return total

    # ---- non-storage embodied, amortized over lifetime ----
    def compute_embodied_g(self, seconds: float, n_replicas: int = 1,
                           types: Optional[Sequence[str]] = None) -> float:
        """Embodied carbon of the GPU/CPU/DRAM fleet over ``seconds``.

        Homogeneous form (``types=None``): each of ``n_replicas`` serving
        replicas is a full reference server (``self.hw``), so the amortized
        share scales linearly with the count — the knob the cluster solver
        trades against cache size.

        Typed form: ``types`` names one ``ReplicaType`` per replica; each
        type's *unamortized* embodied carbon is charged over its own
        remaining lifetime and summed (``n_replicas`` is ignored). Grouped
        by type so an all-reference fleet reproduces the homogeneous value
        bit-for-bit.
        """
        if types is not None:
            return sum(c * get_replica_type(n).embodied_g(seconds)
                       for n, c in Counter(types).items())
        lt = self.hw.lifetime_years * SECONDS_PER_YEAR
        return n_replicas * (seconds / lt) * self.hw.embodied_compute_kg \
            * 1000.0

    # ---- Eq (5): total ----
    def total_g(self, energy_kwh: float, ci: float, alloc_tb: float,
                seconds: float, n_replicas: int = 1,
                types: Optional[Sequence[str]] = None) -> float:
        return (self.operational_g(energy_kwh, ci)
                + self.cache_embodied_g(alloc_tb, seconds)
                + self.compute_embodied_g(seconds, n_replicas, types=types))

    # ---- transition pricing (repro_torch.core.plan.PlanTransition) ----
    def transition_energy_kwh(self, transition, *,
                              boot_latency_s: Optional[float] = None,
                              migrate_bytes: float = 0.0,
                              kv_transfer_gbps: float = 25.0,
                              drain_s: float = 0.0) -> float:
        """Energy of one plan transition — the costs of the
        reconfiguration event itself:

        * **boot** — every booted replica draws its server's idle power
          for ``boot_latency_s`` (or its type's ``boot_s`` when None)
          while serving nothing.  Note the deliberate overlap with
          window pricing: once the window opens, ``energy_kwh`` charges
          the booted replica whole-server power too, so up to
          ``boot_s × P_idle`` is counted twice per boot.  Charging the
          warmup to the transition keeps switching costs explicit and
          solver/engine symmetric, and the (small, conservative)
          overcount is identical for every schedule being compared;
        * **drain** — every drained replica stays powered for ``drain_s``
          (the engine passes the measured residual backlog; the solver an
          estimate) finishing in-flight work — these replicas have left
          the new fleet, so window pricing no longer sees them;
        * **migration I/O** — ``migrate_bytes`` of KV state stream between
          partitioned stores at ``kv_transfer_gbps``, drawing
          ``KV_MIGRATION_W`` (donor+receiver NVMe pair plus NIC) for the
          transfer time.

        ``transition`` is any object with ``boots``/``drains`` sequences
        of ``(pool_role, replica_type)`` pairs (duck-typed so this module
        stays import-free of ``repro_torch.core.plan``)."""
        kwh = 0.0
        for _, tname in transition.boots:
            rt = get_replica_type(tname)
            b = rt.boot_s if boot_latency_s is None else boot_latency_s
            kwh += rt.idle_energy_kwh(b)
        if drain_s > 0.0:
            for _, tname in transition.drains:
                kwh += get_replica_type(tname).idle_energy_kwh(drain_s)
        if migrate_bytes > 0.0:
            kwh += kv_migration_energy_kwh(migrate_bytes, kv_transfer_gbps)
        return kwh

    def transition_g(self, old, new, ci: float, **kwargs) -> float:
        """Carbon of switching from plan ``old`` to plan ``new`` at grid
        intensity ``ci``: the transition's energy (see
        ``transition_energy_kwh``, which takes the same keyword knobs)
        priced operationally.  Embodied carbon does not change — it
        amortizes per wall-clock second and is charged by the window
        pricing whichever plan is live."""
        from repro_torch.core.plan import PlanTransition
        tr = PlanTransition.diff(old, new)
        return self.operational_g(self.transition_energy_kwh(tr, **kwargs),
                                  ci)

    # ---- plan pricing (repro_torch.core.plan.ResourcePlan) ----
    def plan_embodied_g(self, plan, seconds: float,
                        write_bytes_per_s=None) -> float:
        """Embodied carbon of a whole ``ResourcePlan`` over ``seconds``:
        the cache allocation (typed tiers with the wear clock when the
        plan carries a ``StorageSpec``) plus every pool's typed compute
        fleet."""
        cache_tb = plan.cache_tb or 0.0
        return self.cache_embodied_g(cache_tb, seconds,
                                     storage=getattr(plan, "storage",
                                                     None),
                                     write_bytes_per_s=write_bytes_per_s) \
            + self.compute_embodied_g(seconds, types=plan.all_types)

    def plan_energy_kwh(self, plan, gpu_util, seconds: float,
                        pool_power_frac: Optional[Dict[str,
                                                       float]] = None
                        ) -> float:
        """Energy of a whole ``ResourcePlan`` over ``seconds``.

        ``gpu_util`` is either a scalar (applied to every pool) or a
        ``{role: util}`` mapping — disaggregated pools run at very
        different operating points (prefill compute-bound, decode
        memory-bound), so per-pool utilizations are the accurate call.
        ``pool_power_frac`` scales a pool's whole-server draw (the
        decode-pool power cap: memory-bound decode tolerates reduced
        clocks). The SSD allocation is cluster-wide and counted once
        (per tier, when the plan carries a ``StorageSpec``)."""
        cache_tb = plan.cache_tb or 0.0
        storage = getattr(plan, "storage", None)
        if not isinstance(gpu_util, dict):
            if pool_power_frac:        # apply caps via the per-pool path
                gpu_util = {p.role: float(gpu_util) for p in plan.pools}
            else:
                return self.energy_kwh(gpu_util, seconds, ssd_tb=cache_tb,
                                       types=plan.all_types,
                                       storage=storage)
        total = self.energy_kwh(0.0, seconds, ssd_tb=cache_tb, types=[],
                                storage=storage)
        for pool in plan.pools:
            frac = (pool_power_frac or {}).get(pool.role, 1.0)
            total += frac * self.energy_kwh(float(gpu_util[pool.role]),
                                            seconds, types=pool.fleet)
        return total

    # ---- power → energy helper ----
    def energy_kwh(self, gpu_util: float, seconds: float,
                   ssd_tb: float = 0.0, n_servers: int = 1,
                   types: Optional[Sequence[str]] = None,
                   storage=None) -> float:
        """Fleet energy: each replica draws whole-server power at the given
        (average) accelerator utilization; the SSD pool is a cluster-wide
        allocation and is counted once. With ``types``, per-replica power
        comes from each replica's own ``ReplicaType`` spec (grouped by type;
        ``n_servers`` is ignored); otherwise ``n_servers`` reference
        servers (``self.hw``) are assumed.  ``storage`` (a
        ``StorageSpec``) replaces the flat ``ssd_tb × ssd_power_w_per_tb``
        term with each tier's allocation-proportional idle draw (the
        default single-tier device reproduces the flat term exactly)."""
        ssd_w = storage.idle_w if storage is not None \
            else ssd_tb * self.hw.ssd_power_w_per_tb
        if types is not None:
            w = sum(c * get_replica_type(n).server_power_w(gpu_util)
                    for n, c in Counter(types).items()) + ssd_w
            return w * seconds / 3.6e6
        hw = self.hw
        gpu_w = hw.gpu_power_idle_w + gpu_util * (hw.gpu_power_max_w
                                                  - hw.gpu_power_idle_w)
        w = n_servers * (gpu_w + hw.cpu_power_w + hw.mem_power_w) + ssd_w
        return w * seconds / 3.6e6
