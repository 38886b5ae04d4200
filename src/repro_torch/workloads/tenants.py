"""Multi-tenant SLO tiers (gold / standard / scavenger).

One request class is the easy world; production serving multiplexes
tenants whose latency promises differ by an order of magnitude.  This
module defines the tier vocabulary shared by the whole stack:

  * ``TierSpec`` — priority (0 is served first), per-tier SLO scaling
    (tier SLO = base SLO × scale), whether the tier is *protected*
    (counts toward the solver's rho constraint) and whether its
    in-service work is *preemptible* by higher tiers.
  * ``TIERS`` — the standing three-tier contract.  ``gold`` carries the
    base SLO and absolute queue priority; ``standard`` is the default
    tier every un-stamped request belongs to (1.5× the base latency
    budget); ``scavenger`` is best-effort batch/backfill traffic — 6×
    budget, never protected, preempted mid-service by anything above it.
  * ``MultiTenantWorkload`` — wraps any workload generator and stamps
    ``Request.tenant``/``Request.tier`` from a share mix, drawing from
    its own seeded RNG so the base workload's draws are untouched.

The engine's priority queueing (``ClusterEngine``) and the solver's
per-tier attainment (``solve_cluster_schedule(tier_shares=...)``) both
key off this registry; a stream whose requests are all ``standard``
takes the legacy single-tier code paths bit-exactly.
"""
from __future__ import annotations

from dataclasses import dataclass, replace as _dc_replace
from typing import Dict, Sequence

import numpy as np


@dataclass(frozen=True)
class TierSpec:
    name: str
    priority: int          # 0 = served first (non-preemptive between
    #                        protected tiers; scavengers preempt-resume)
    ttft_scale: float      # tier TTFT SLO = base ttft_s × ttft_scale
    tpot_scale: float      # tier TPOT SLO = base tpot_s × tpot_scale
    protected: bool        # counts toward the solver's rho constraint
    preemptible: bool      # in-service work yields to higher tiers
    # cache eviction weight (``repro_torch.core.policies.tier_weighted``):
    # keep-priority multiplier on the tier's cached prefixes, so
    # best-effort churn cannot flush a protected tier's working set
    cache_weight: float = 1.0


TIERS: Dict[str, TierSpec] = {
    "gold": TierSpec("gold", 0, 1.0, 1.0, True, False,
                     cache_weight=4.0),
    "standard": TierSpec("standard", 1, 1.5, 1.5, True, False,
                         cache_weight=1.0),
    "scavenger": TierSpec("scavenger", 2, 6.0, 6.0, False, True,
                          cache_weight=0.25),
}

DEFAULT_TIER = "standard"


def default_cache_weights() -> Dict[str, float]:
    """The standing tier → eviction-weight mapping (what
    ``GreenCacheController(tier_cache_weights=True)`` resolves to)."""
    return {t: s.cache_weight for t, s in TIERS.items()}


def tier_spec(tier: str) -> TierSpec:
    try:
        return TIERS[tier]
    except KeyError:
        raise ValueError(f"unknown tier {tier!r}; one of "
                         f"{sorted(TIERS)}") from None


def tier_slo(base, tier: str):
    """The tier's SLO object: the base (gold) SLO with its latency
    budgets scaled by the tier's contract.  Gold scales by exactly 1.0
    and returns ``base`` itself, so single-tier attainment arithmetic is
    unchanged."""
    spec = tier_spec(tier)
    if spec.ttft_scale == 1.0 and spec.tpot_scale == 1.0:
        return base
    return _dc_replace(base, ttft_s=base.ttft_s * spec.ttft_scale,
                       tpot_s=base.tpot_s * spec.tpot_scale)


def normalize_shares(shares: Dict[str, float]) -> Dict[str, float]:
    """Validate a tier→share mapping and normalize it to sum 1."""
    if not shares:
        raise ValueError("tier shares must name at least one tier")
    for t in shares:
        tier_spec(t)
    total = float(sum(shares.values()))
    if total <= 0.0 or any(v < 0.0 for v in shares.values()):
        raise ValueError("tier shares must be non-negative with a "
                         "positive sum")
    return {t: float(v) / total for t, v in shares.items()}


class MultiTenantWorkload:
    """Stamp ``tenant``/``tier`` onto any base workload's requests.

    Tiers are drawn iid from ``shares`` and tenants uniformly within the
    tier (``tenants_per_tier`` logical customers per class), using a
    dedicated RNG derived from ``seed`` — the base workload consumes its
    own streams untouched, so a degenerate mix (``{"standard": 1.0}``)
    yields requests identical to the bare workload except the labels.
    Stamping is deterministic in (seed, call sequence), which is what
    makes same-seed controller runs bit-stable."""

    def __init__(self, base, shares: Dict[str, float], *, seed: int = 0,
                 tenants_per_tier: int = 4):
        self.base = base
        self.shares = normalize_shares(shares)
        self._names = sorted(self.shares,
                             key=lambda t: TIERS[t].priority)
        self._probs = np.array([self.shares[t] for t in self._names])
        self._rng = np.random.default_rng([int(seed) & 0xffffffff,
                                           0x7e4a47])
        self.tenants_per_tier = max(int(tenants_per_tier), 1)

    def _stamp(self, requests):
        k = len(requests)
        if k == 0:
            return requests
        ti = self._rng.choice(len(self._names), size=k, p=self._probs)
        uid = self._rng.integers(0, self.tenants_per_tier, size=k)
        for r, a, u in zip(requests, ti.tolist(), uid.tolist()):
            r.tier = self._names[a]
            r.tenant = f"{self._names[a]}-{u}"
        return requests

    def sample(self, arrival: float):
        return self._stamp([self.base.sample(arrival)])[0]

    def sample_batch(self, arrivals: Sequence[float]):
        batch = getattr(self.base, "sample_batch", None)
        if batch is not None:
            return self._stamp(batch(arrivals))
        return self._stamp([self.base.sample(float(t))
                            for t in arrivals])


def multi_tenant(factory, shares: Dict[str, float], *,
                 tenants_per_tier: int = 4):
    """Lift a workload *factory* (``seed -> workload``) to a
    multi-tenant one — the shape ``GreenCacheController.run_day``
    consumes."""
    shares = normalize_shares(shares)

    def make(seed, **kwargs):
        return MultiTenantWorkload(factory(seed, **kwargs), shares,
                                   seed=seed,
                                   tenants_per_tier=tenants_per_tier)
    return make
