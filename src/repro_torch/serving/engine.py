"""Serving-cluster simulation: continuous batching with a prefill queue and
an analytically-coupled decode phase.

Model (matches the paper's observations §3.1):
  * Prefill is a single logical server (the GPU pool) processing requests
    FIFO; a cache hit shrinks service time to uncached-suffix compute plus
    KV-load from SSD — higher request rates amplify the saving because queue
    wait compounds service time (Takeaway 2).
  * Decode runs as continuous batching; TPOT = base·(1+slope·(batch−1)),
    inflated by prefill utilization (prefill steals iterations — Takeaway 2's
    "reduced waiting time for decode"). Batch size is the λ·output·TPOT
    fixed point, capped at max_batch.
  * Energy integrates utilization-dependent GPU power plus CPU/DRAM/SSD
    (paper §5.2's measurement methodology, constants from the specs).

The *real-execution* counterpart (`repro_torch.serving.realexec`) runs an
actual PyTorch model for prefill/decode with true KV reuse behind the same
``KVStore`` — used by tests and the quickstart's part 1 at small scale. This
engine is host NumPy code: it simulates the fleet and runs nothing on a card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.carbon import CarbonModel
from repro_torch.core.kvstore import KVStore
from repro_torch.serving.perfmodel import SLO, ServingModel
from repro_torch.workloads.request import Request


@dataclass
class SimResult:
    ttft: np.ndarray
    tpot: np.ndarray
    energy_kwh: float
    duration_s: float
    carbon_g: float
    operational_g: float
    embodied_cache_g: float
    embodied_compute_g: float
    token_hit_rate: float
    gpu_util: float
    num_requests: int
    n_replicas: int = 1
    # per-request tier labels and work weights (uncached prefill + output
    # tokens), populated only for multi-tier streams — the functional-unit
    # attribution base for ``per_tier``. None on single-tier runs.
    tiers: Optional[np.ndarray] = None
    work: Optional[np.ndarray] = None
    # per-request tenant labels ("<tier>-<id>"), populated alongside
    # ``tiers`` when the stream carries tenant identity — the chargeback
    # attribution base for ``per_tenant``. None otherwise.
    tenants: Optional[np.ndarray] = None

    @property
    def carbon_per_request_g(self) -> float:
        return self.carbon_g / max(self.num_requests, 1)

    def p90(self, what: str = "ttft") -> float:
        arr = self.ttft if what == "ttft" else self.tpot
        return float(np.percentile(arr, 90)) if len(arr) else 0.0

    def slo_attainment(self, slo: SLO, which: str = "both") -> float:
        """Fraction of requests meeting the SLO; ``which`` selects the
        joint constraint (default) or a single metric ("ttft"/"tpot") —
        the split the disaggregation solver needs, since prefill and
        decode pools bind on different metrics."""
        if not len(self.ttft):
            return 1.0
        if which == "ttft":
            ok = self.ttft <= slo.ttft_s
        elif which == "tpot":
            ok = self.tpot <= slo.tpot_s
        elif which == "both":
            ok = (self.ttft <= slo.ttft_s) & (self.tpot <= slo.tpot_s)
        else:
            raise ValueError(f"which must be ttft/tpot/both, got {which!r}")
        return float(ok.mean())

    def per_tier(self, slo: SLO) -> dict:
        """Functional-unit metrics per SLO tier: request count, SLO
        attainment against the *tier's own* latency budget, and gCO2e
        attributed by each request's share of the work (uncached prefill
        plus output tokens — the tokens the fleet actually computed).
        The float-rounding residual is folded into the last tier (as in
        ``per_tenant``) so the tier cut partitions ``carbon_g`` exactly —
        the carbon-ledger audit treats any larger residual as an error.
        Empty dict on single-tier runs where ``tiers`` was not recorded."""
        if self.tiers is None or not len(self.ttft):
            return {}
        from repro_torch.workloads.tenants import tier_slo
        out = {}
        total_work = float(self.work.sum()) or 1.0
        for t in np.unique(self.tiers):
            mask = self.tiers == t
            n = int(mask.sum())
            ts = tier_slo(slo, str(t))
            ok = (self.ttft[mask] <= ts.ttft_s) \
                & (self.tpot[mask] <= ts.tpot_s)
            g = self.carbon_g * float(self.work[mask].sum()) / total_work
            out[str(t)] = {"requests": n, "slo_frac": float(ok.mean()),
                           "carbon_g": g}
        last = next(reversed(out))
        for _ in range(8):
            resid = self.carbon_g \
                - sum(d["carbon_g"] for d in out.values())
            if resid == 0.0:
                break
            out[last]["carbon_g"] += resid
        for d in out.values():
            d["g_per_request"] = d["carbon_g"] / max(d["requests"], 1)
        return out

    def per_tenant(self, slo: SLO) -> dict:
        """Chargeback metrics per tenant (``{tenant: {tier, requests,
        slo_frac, carbon_g, g_per_request}}``): carbon is attributed by
        each tenant's share of the computed work (as in ``per_tier``),
        then the float-rounding residual is folded into the largest-work
        tenant so the invoices partition ``carbon_g`` *exactly* — a
        chargeback ledger must sum to the bill.  Attainment is judged
        against the tenant's tier SLO (the tier is the prefix of the
        tenant label).  Empty when the stream carried no tenant
        identity."""
        if self.tenants is None or not len(self.ttft):
            return {}
        from repro_torch.workloads.tenants import tier_slo
        out = {}
        total_work = float(self.work.sum()) or 1.0
        for t in np.unique(self.tenants):
            mask = self.tenants == t
            n = int(mask.sum())
            tier = str(t).rsplit("-", 1)[0]
            ts = tier_slo(slo, tier)
            ok = (self.ttft[mask] <= ts.ttft_s) \
                & (self.tpot[mask] <= ts.tpot_s)
            w = float(self.work[mask].sum())
            out[str(t)] = {"tier": tier, "requests": n,
                           "slo_frac": float(ok.mean()),
                           "carbon_g": self.carbon_g * w / total_work}
        # fold the float-rounding residual into the *last* invoice in
        # iteration order: a sequential ``sum`` over the dict re-rounds
        # every partial after the adjusted entry, so correcting the
        # final addend leaves all earlier partials untouched and the
        # fixed-point iteration converges in a step or two
        last = next(reversed(out))
        for _ in range(8):
            resid = self.carbon_g \
                - sum(d["carbon_g"] for d in out.values())
            if resid == 0.0:
                break
            out[last]["carbon_g"] += resid
        for d in out.values():
            d["g_per_request"] = d["carbon_g"] / max(d["requests"], 1)
        return out


def _check_conservation(merged: "SimResult"):
    """Carbon/attribution conservation self-check on every merge (cheap,
    read-only, on by default): the component carbons must re-sum to the
    bill within float dust, and every per-request attribution array must
    cover every merged request.  A violation is a dropped array
    or a mispriced component and raises ``LedgerError``."""
    from repro_torch.obs.ledger import LedgerError
    comp = merged.operational_g + merged.embodied_cache_g \
        + merged.embodied_compute_g
    scale = max(abs(merged.carbon_g), abs(comp), 1e-12)
    if abs(merged.carbon_g - comp) > 1e-9 * scale:
        raise LedgerError(
            f"combine_results dropped carbon: components sum to "
            f"{comp:.9g}, bill is {merged.carbon_g:.9g}")
    n = len(merged.ttft)
    for name in ("tiers", "work", "tenants"):
        arr = getattr(merged, name)
        if arr is not None and len(arr) != n:
            raise LedgerError(
                f"combine_results merged {name} covers {len(arr)} of "
                f"{n} requests — attribution would drop carbon")


def combine_results(a: SimResult, b: SimResult) -> SimResult:
    """Merge two sequential segment results into one hour-level result —
    used when a mid-hour event (replica failure, storage degradation)
    splits the request stream. Totals add; rates are weighted by their
    natural denominators (tokens looked up -> request count proxy,
    busy time -> duration). The merged result is conservation-checked
    (``_check_conservation``) before being returned."""
    if a.num_requests == 0:
        return b
    if b.num_requests == 0:
        return a
    n = a.num_requests + b.num_requests
    dur = a.duration_s + b.duration_s

    def _cat(x, y):
        if x is None and y is None:
            return None
        x = x if x is not None else np.array([])
        y = y if y is not None else np.array([])
        return np.concatenate([x, y])

    tiers = None
    work = None
    tenants = None
    if a.tiers is not None or b.tiers is not None:
        fill_a = np.full(len(a.ttft), "standard", dtype=object)
        fill_b = np.full(len(b.ttft), "standard", dtype=object)
        tiers = np.concatenate([a.tiers if a.tiers is not None else fill_a,
                                b.tiers if b.tiers is not None else fill_b])
        work = _cat(a.work if a.work is not None else np.ones(len(a.ttft)),
                    b.work if b.work is not None else np.ones(len(b.ttft)))
    if a.tenants is not None or b.tenants is not None:
        fa = np.full(len(a.ttft), "standard-0", dtype=object)
        fb = np.full(len(b.ttft), "standard-0", dtype=object)
        tenants = np.concatenate(
            [a.tenants if a.tenants is not None else fa,
             b.tenants if b.tenants is not None else fb])
    merged = SimResult(
        ttft=np.concatenate([a.ttft, b.ttft]),
        tpot=np.concatenate([a.tpot, b.tpot]),
        energy_kwh=a.energy_kwh + b.energy_kwh,
        duration_s=dur,
        carbon_g=a.carbon_g + b.carbon_g,
        operational_g=a.operational_g + b.operational_g,
        embodied_cache_g=a.embodied_cache_g + b.embodied_cache_g,
        embodied_compute_g=a.embodied_compute_g + b.embodied_compute_g,
        token_hit_rate=(a.token_hit_rate * a.num_requests
                        + b.token_hit_rate * b.num_requests) / max(n, 1),
        gpu_util=(a.gpu_util * a.duration_s
                  + b.gpu_util * b.duration_s) / max(dur, 1e-9),
        num_requests=n, n_replicas=b.n_replicas,
        tiers=tiers, work=work, tenants=tenants)
    _check_conservation(merged)
    return merged


class ServingEngine:
    def __init__(self, model: ServingModel, store: KVStore,
                 carbon: CarbonModel):
        self.model = model
        self.store = store
        self.carbon = carbon
        self._server_free = 0.0

    # ------------------------------------------------------------------ #
    def warm(self, requests: Sequence[Request]):
        """Populate the cache without simulating timing (paper §6.1:
        the cache is initialized with 200k/50k prompts before measuring)."""
        for r in requests:
            self.store.lookup(r.context_key, r.context_tokens, r.arrival)
            self.store.insert(r.context_key, r.prompt_tokens, r.arrival,
                              turn=r.turn)

    # ------------------------------------------------------------------ #
    def run(self, requests: Sequence[Request], *,
            ci_fn: Callable[[float], float], cache_tb: float,
            rate_hint: Optional[float] = None, record: bool = True
            ) -> SimResult:
        """Simulate a request stream (must be arrival-sorted). ``ci_fn``
        maps absolute time (s) -> gCO2e/kWh. ``cache_tb`` is the *allocated*
        SSD capacity (embodied carbon accrues on allocation, Eq. 4)."""
        m = self.model
        if not requests:
            return self._empty(cache_tb)
        t0 = requests[0].arrival
        self._server_free = max(self._server_free, t0)
        lookup_tokens = 0
        hit_tokens = 0
        busy_prefill = 0.0
        busy_compute = 0.0
        ttfts, tpots = [], []

        # arrival-rate estimate for the decode-batch fixed point
        span = max(requests[-1].arrival - t0, 1.0)
        lam = rate_hint if rate_hint else len(requests) / span
        out_mean = float(np.mean([r.output_tokens for r in requests]))

        for r in requests:
            entry = self.store.lookup(r.context_key, r.context_tokens,
                                      r.arrival)
            reused = min(entry.num_tokens, r.context_tokens) if entry else 0
            uncached = r.prompt_tokens - reused
            lookup_tokens += r.prompt_tokens
            hit_tokens += reused
            r.reused_tokens = reused

            service = m.prefill_time(uncached, reused)
            start = max(r.arrival, self._server_free)
            self._server_free = start + service
            r.ttft = (start - r.arrival) + service
            busy_prefill += service
            # GPU-compute-busy part only (KV load is SSD/PCIe time at
            # near-idle GPU power)
            busy_compute += m.prefill_base_s + uncached / m.prefill_tok_per_s

            # cache the full context+question prefix for future turns
            self.store.insert(r.context_key, r.prompt_tokens, r.arrival,
                              turn=r.turn)
            if record:
                ttfts.append(r.ttft)

        duration = max(self._server_free, requests[-1].arrival) - t0
        prefill_util = min(busy_prefill / max(duration, 1e-9), 1.0)

        # decode: fixed-point batch estimate under continuous batching,
        # incl. the overload penalty once the arrival token rate wants a
        # batch far past max_batch (decode capacity is no longer free on
        # token-heavy streams)
        tpot, batch = m.decode_fixed_point(lam, out_mean,
                                           interference_util=prefill_util)
        for r in requests:
            r.tpot = tpot * float(np.random.default_rng(r.rid)
                                  .uniform(0.92, 1.08))
            if record:
                tpots.append(r.tpot)

        decode_busy = sum(r.output_tokens * r.tpot / max(batch, 1.0)
                          for r in requests)
        decode_frac = min(decode_busy / max(duration, 1e-9), 1.0)

        # fleet-level energy (paper §5.2 measures whole-server power with
        # RAPL/pyNVML): GPU power scales with the utilization mix of
        # compute-bound prefill and memory-bound decode; CPU/DRAM/SSD draw
        # base power for the whole window. Caching lowers the prefill
        # component only — decode compute is unchanged (paper §5.4.1), which
        # is why operational savings are a modest fraction of total energy.
        compute_util = min(busy_compute / max(duration, 1e-9), 1.0)
        util = min(m.gpu_util_prefill * compute_util
                   + m.gpu_util_decode * decode_frac, 1.0)
        energy = self.carbon.energy_kwh(util, duration, ssd_tb=cache_tb)
        for r in requests:           # per-request attribution for the ILP
            r.energy_kwh = energy / len(requests)

        ci_avg = float(np.mean([ci_fn(r.arrival) for r in requests]))
        op = self.carbon.operational_g(energy, ci_avg)
        emb_cache = self.carbon.cache_embodied_g(cache_tb, duration)
        emb_comp = self.carbon.compute_embodied_g(duration)
        return SimResult(
            ttft=np.array(ttfts), tpot=np.array(tpots), energy_kwh=energy,
            duration_s=duration, carbon_g=op + emb_cache + emb_comp,
            operational_g=op, embodied_cache_g=emb_cache,
            embodied_compute_g=emb_comp,
            token_hit_rate=hit_tokens / max(lookup_tokens, 1),
            gpu_util=util, num_requests=len(requests))

    def _empty(self, cache_tb: float) -> SimResult:
        return SimResult(np.array([]), np.array([]), 0.0, 0.0, 0.0, 0.0,
                         0.0, 0.0, 0.0, 0.0, 0)

    def reset_clock(self):
        self._server_free = 0.0
