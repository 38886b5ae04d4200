"""Constraint solver (paper §5.4 + cluster/fleet extensions).

The paper's core decision is the hourly cache size S_t that minimizes
predicted total carbon subject to the global SLO-attainment constraint
(≥ρ of requests meet TTFT and TPOT SLOs over the horizon):

    argmin_{S_t}  Σ_t n_t · [ p·TTFT·CI_t  +  (TTFT/LT)·S_t·C_unit
                              + Σ_comp (TTFT/LT)·C_comp ]
    s.t.          Σ_t n_t·sloF(S_t, j_t)  ≥  ρ · Σ_t n_t        (per metric)

This is a multiple-choice knapsack (NP-hard — paper Appendix A reduces 0-1
KNAPSACK to it); at 1 TB × 24 h granularity it is tractable. The paper
solves it with PuLP + COIN-OR CBC; this package solves it with the exact
dynamic program over discretized satisfied-request counts, which needs no
external solver (the reference's ILP branch is not carried, see
``solve_cache_schedule``).

Cluster generalizations reuse the same machinery by enlarging the
per-hour option set (the knapsack classes stay one-choice-per-hour);
``solve_cluster_schedule`` returns one sized ``ResourcePlan`` per hour
(``SolveResult.plans``) whatever the candidate source:

* ``replicas=[1,2,4]`` — options are sizes × homogeneous replica counts
  (EcoServe-style provisioning axis).
* ``fleets=enumerate_fleets(...)`` — options are sizes × heterogeneous
  fleet mixes; each mix's carbon sums per-type power and (amortization-
  discounted) embodied rates, the GreenLLM-style old-vs-new-generation
  tradeoff. Predicted load/SLO for a mix uses the capacity-normalized
  rate (see ``_fleet_cell_metrics``); ``type_profiles=`` swaps the
  rescale for measured per-generation cells.
* ``plans=[...]`` / ``prefill_fleets= + decode_fleets=`` — options are
  sizes × ``ResourcePlan`` candidates, including disaggregated
  prefill/decode pool pairs (``_disagg_cell_metrics``: profile-based
  TTFT side, analytic decode side, power-capped decode pool pricing).
* ``transitions=TransitionConfig(...)`` — the per-hour choice becomes a
  transition-aware DP over (cache-bucket, option) *states* with
  switching carbon between consecutive hours (boot + drain energy,
  partitioned-ring migration I/O) and a ``min_dwell_hours`` knob, so
  the schedule exhibits hysteresis instead of thrashing between plans
  that are near-tied hour to hour; zero-cost configs fall back to the
  plain solve bit-exactly.

Prefix-aware caching needs no new solver formula: profiles measured on a
``RadixKVStore`` (``run_profiler(prefix_aware=True)``) already fold
partial hits into every cell — ``hit_rate`` is the context-token-weighted
ledger ratio (Σ matched / Σ looked-up tokens), which is exactly the
quantity ``_storage_cell_adjust`` converts to hit bytes and saved compute
seconds, and TTFT/energy/``write_bytes_per_req`` were measured under
suffix-only re-prefill.  The solver therefore sizes against the smooth
prefix-aware hit-rate curve (``ProfileCell.matched_token_frac`` traces
the per-request prefill-shortening factor) the moment it is handed such
a profile, and picks smaller caches where dedup makes small caches good.
"""
from __future__ import annotations

import functools
import itertools
import time
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.carbon import (SECONDS_PER_YEAR, CarbonModel,
                               fleet_capacity, get_replica_type,
                               kv_migration_energy_kwh)
from repro_torch.core.plan import (PlanTransition, ResourcePlan,
                             TransitionConfig, ring_moved_fraction)
from repro_torch.core.profiler import Profile
from repro_torch.core.storage import StorageSpec
from repro_torch.serving.perfmodel import SLO
from repro_torch.workloads.tenants import TIERS, normalize_shares


@dataclass
class SolveResult:
    sizes_tb: List[float]             # chosen S_t per hour
    objective_g: float
    feasible: bool
    solve_time_s: float
    solver: str
    replicas: Optional[List[int]] = None   # chosen N_t (cluster co-decision)
    fleets: Optional[List[Tuple[str, ...]]] = None  # chosen mix per hour
    # the plan currency: one sized ResourcePlan per hour (populated by
    # every solve_cluster_schedule mode; sizes_tb/replicas/fleets are
    # views kept for the pre-plan call sites)
    plans: Optional[List[ResourcePlan]] = None
    # transition-aware mode: predicted switching carbon charged at each
    # hour boundary (hour 0 is the switch away from ``initial_plan``)
    transition_g: Optional[List[float]] = None
    # beam search only (``beam_width=``): upper bound on the extra carbon
    # (g) of the returned schedule vs the exhaustive optimum — 0.0 means
    # the beam provably did not change the solution; None = no beam
    beam_bound_g: Optional[float] = None
    # flight-recorder payload: the raw per-hour candidate tables the DP
    # chose from (labels, C, F, n, choice indices, prune/beam config) —
    # consumed lazily by ``explain()``/``prune_stats()``.  Excluded from
    # comparison/repr so solver results stay comparable across modes.
    explain_data: Optional[Dict] = field(default=None, compare=False,
                                         repr=False)

    # ------------------------------------------------------------------ #
    def _keeps(self, beam_width="cfg"):
        """Reconstruct the per-hour survivor sets exactly as the solve's
        dominance prune / beam saw them (lazy — only on explain)."""
        ed = self.explain_data
        cls = None
        if ed.get("class_keys") is not None:
            ids: Dict[object, int] = {}
            cls = np.array([ids.setdefault(k, len(ids))
                            for k in ed["class_keys"]], dtype=np.int64)
        bw = ed["beam_width"] if beam_width == "cfg" else beam_width
        return _hour_keeps(ed["C"], ed["F"], ed["n"], cls,
                           ed["prune"], bw)[0]

    def prune_stats(self) -> Optional[Dict]:
        """Pareto-prune effectiveness of this solve: candidate counts
        and the fraction of (hour, option) cells the dominance filter
        (plus beam, when configured) removed before the DP ran.
        ``None`` when no candidate table was recorded."""
        ed = self.explain_data
        if ed is None:
            return None
        T, n_opt = ed["C"].shape
        kept = sum(len(k) for k in self._keeps())
        total = T * n_opt
        return {"hours": T, "options": n_opt, "cells": total,
                "kept_cells": kept,
                "prune_ratio": 1.0 - kept / max(total, 1)}

    def explain(self, hours: Optional[Sequence[int]] = None,
                top: Optional[int] = 12) -> str:
        """Human-readable dump of each hour's surviving candidate table:
        per-request carbon, predicted attainment, the switching carbon
        paid on entry (transition mode), and why each losing option lost
        (``dominated`` = removed by the Pareto prune, ``beam`` = cut by
        the beam, ``kept`` = survived but cost more).  ``hours`` limits
        the dump; ``top`` caps rows per hour (chosen row always shown;
        ``None`` = all)."""
        ed = self.explain_data
        if ed is None:
            return ("explain: no candidate table recorded "
                    f"(solver={self.solver})")
        C, F, n = ed["C"], ed["F"], ed["n"]
        labels, choice = ed["labels"], ed["choice"]
        T, n_opt = C.shape
        keeps = [set(int(i) for i in k) for k in self._keeps()]
        pareto = keeps if ed["beam_width"] is None else \
            [set(int(i) for i in k) for k in self._keeps(beam_width=None)]
        tg = ed.get("transition_g")
        out = [f"solver={ed['solver']} rho={ed['rho']:g} "
               f"feasible={self.feasible} objective={self.objective_g:.1f}g "
               f"options={n_opt}"]
        for t in (range(T) if hours is None else hours):
            out.append(f"hour {t:02d}  n={n[t]:.0f} req"
                       + (f"  switch={tg[t]:.2f}g" if tg else ""))
            out.append(f"  {'option':<44s} {'g/req':>9s} {'attain':>7s} "
                       f"{'hour g':>10s}  status")
            order = np.lexsort((np.arange(n_opt), C[t]))
            rows = 0
            for o in order:
                o = int(o)
                if o == choice[t]:
                    status = "chosen"
                elif o in keeps[t]:
                    status = "kept"
                elif o in pareto[t]:
                    status = "beam"
                else:
                    status = "dominated"
                if top is not None and rows >= top \
                        and status != "chosen":
                    continue
                out.append(f"  {labels[o]:<44s} {C[t][o]:>9.4f} "
                           f"{F[t][o]:>7.3f} {n[t] * C[t][o]:>10.1f}  "
                           f"{status}")
                rows += 1
            if top is not None and n_opt > top:
                out.append(f"  ... ({n_opt - top} more options)")
        return "\n".join(out)


def _cell_metrics(profile: Profile, rate: float, size: float,
                  ci: float, carbon: CarbonModel):
    c = profile.interpolate(rate, size)
    carbon_req = c.carbon_per_req_g(ci, carbon)
    return carbon_req, c.slo_frac


def _option_label(o) -> str:
    """Short human label for one knapsack option (see ``explain()``)."""
    if isinstance(o, tuple) and len(o) == 2:
        return str(_option_plan(o, sized=True))
    return f"cache={o:g}tb" if isinstance(o, (int, float)) else str(o)


def _explain_payload(options, C, F, n, rho, res: SolveResult, *,
                     prune: bool = False, beam_width=None,
                     class_keys=None) -> Dict:
    """Candidate-table payload for ``SolveResult.explain()``.  Choice
    indices are recovered by identity: every solver mode returns the
    very option objects it was handed."""
    pos = {id(o): i for i, o in enumerate(options)}
    return {"labels": [_option_label(o) for o in options],
            "C": np.asarray(C), "F": np.asarray(F),
            "n": np.asarray(n), "rho": float(rho),
            "choice": [pos.get(id(o), -1) for o in res.sizes_tb],
            "transition_g": res.transition_g, "solver": res.solver,
            "prune": bool(prune), "beam_width": beam_width,
            "class_keys": class_keys}


def solve_cache_schedule(profile: Profile, pred_rates: Sequence[float],
                         pred_cis: Sequence[float], slo: SLO,
                         carbon: CarbonModel, *,
                         sizes_tb: Optional[Sequence[float]] = None,
                         rho: Optional[float] = None) -> SolveResult:
    """pred_rates/pred_cis: per-hour forecasts over the horizon.

    Solved with the exact DP (``solver="dp"``). The reference first tries
    an ILP through ``pulp`` and falls to the same DP when it cannot import
    it; ``pulp`` is not a dependency here, so that branch is left out."""
    t_start = time.time()
    rho = rho if rho is not None else slo.rho
    sizes = list(sizes_tb) if sizes_tb is not None else list(profile.sizes)
    T = len(pred_rates)
    n = np.array([max(r, 1e-3) * 3600.0 for r in pred_rates])   # requests/hr

    # carbon[t][s], slo_frac[t][s]
    C = np.zeros((T, len(sizes)))
    F = np.zeros((T, len(sizes)))
    for t in range(T):
        for si, s in enumerate(sizes):
            C[t, si], F[t, si] = _cell_metrics(
                profile, pred_rates[t], s, pred_cis[t], carbon)

    res = _solve_dp(C, F, n, sizes, rho, t_start)
    res.explain_data = _explain_payload(sizes, C, F, n, rho, res)
    return res


def _saturated_slo(profile: Profile, norm_rate: float,
                   slo_frac: float) -> float:
    """Penalize per-replica rates beyond the profiled envelope: the queue
    is saturated and attainment collapses at least quadratically
    (``Profile.interpolate`` clamps to the last cell, which would
    otherwise let the solver under-provision small fleets far past their
    capacity)."""
    rs_max = max(profile.rates)
    if norm_rate > rs_max:
        slo_frac *= (rs_max / norm_rate) ** 2
    return slo_frac


def _cluster_cell_metrics(profile: Profile, rate: float, size: float,
                          n_rep: int, ci: float, carbon: CarbonModel):
    """Predicted per-request carbon and SLO fraction for ``n_rep`` replicas
    sharing a ``size``-TB cache at cluster arrival rate ``rate``.

    Approximation (affinity/shared routing): each replica sees ~rate/n of
    the stream, so latency/SLO/energy-per-request follow the single-server
    profile cell at (rate/n, size). Per-request embodied compute is
    n · embodied(duration) / (n · requests) — the same expression as the
    single-server cell — while the shared cache allocation amortizes over
    n× the requests (the /n term the solver trades against SLO headroom)."""
    c = profile.interpolate(rate / n_rep, size)
    op = carbon.operational_g(c.energy_per_req_kwh, ci)
    emb_cache = carbon.cache_embodied_g(size, c.duration_per_req_s) / n_rep
    emb_comp = carbon.compute_embodied_g(c.duration_per_req_s)
    return (op + emb_cache + emb_comp) * _idle_floor(profile,
                                                     rate / n_rep), \
        _saturated_slo(profile, rate / n_rep, c.slo_frac)


def enumerate_fleets(type_names: Sequence[str], max_replicas: int,
                     min_replicas: int = 1) -> List[Tuple[str, ...]]:
    """Bounded enumeration of fleet mixes: every multiset of the given
    replica types with ``min_replicas``..``max_replicas`` members, sorted
    by (size, capacity) so option indices are stable. The option count is
    C(|types|+n-1, n) summed over n — e.g. 2 types × ≤6 replicas → 27
    mixes, well within the knapsack's per-hour budget."""
    for t in type_names:
        get_replica_type(t)
    out: List[Tuple[str, ...]] = []
    for n in range(max(min_replicas, 1), max_replicas + 1):
        out.extend(itertools.combinations_with_replacement(type_names, n))
    out.sort(key=lambda f: (len(f), fleet_capacity(f), f))
    return out


def _ref_util(cell, carbon: CarbonModel) -> float:
    """Invert the profiled average server power back to the reference
    platform's accelerator utilization (the profile stores whole-fleet
    power incl. the small SSD term; clamping absorbs that skew)."""
    hw = carbon.hw
    base = hw.gpu_power_idle_w + hw.cpu_power_w + hw.mem_power_w
    span = hw.gpu_power_max_w - hw.gpu_power_idle_w
    return float(np.clip((cell.avg_power_w - base) / max(span, 1e-9),
                         0.0, 1.0))


def _ref_watts(carbon: CarbonModel, util: float) -> float:
    hw = carbon.hw            # the platform the profile was measured on
    return hw.gpu_power_idle_w \
        + util * (hw.gpu_power_max_w - hw.gpu_power_idle_w) \
        + hw.cpu_power_w + hw.mem_power_w


def _idle_floor(profile: Profile, norm_rate: float) -> float:
    """Per-request carbon multiplier below the profiled rate floor.

    ``Profile.interpolate`` clamps to the lowest profiled cell, whose
    energy-per-request already amortizes the (idle-dominated) fleet
    power over that cell's arrival rate.  Below it the fleet burns
    roughly the same hourly power over ever fewer requests, so the
    honest per-request bill grows as ``rmin / rate`` (hourly carbon
    holds flat at its idle floor).  Without this an almost-idle fleet
    prices as free and the solver happily parks the *largest* fleet in
    a starved region — the ``/capacity`` cache amortization even
    rewards it.  Geo-distributed runs hit this constantly: a green
    router drains the dirty region to a trickle."""
    rmin = min(profile.rates)
    if norm_rate >= rmin or rmin <= 0.0:
        return 1.0
    return rmin / max(norm_rate, rmin * 1e-3)


def _fleet_cell_metrics(profile: Profile, rate: float, size: float,
                        fleet: Sequence[str], ci: float,
                        carbon: CarbonModel,
                        type_profiles: Optional[Dict[str, Profile]] = None):
    """Predicted per-request carbon and SLO fraction for a heterogeneous
    ``fleet`` sharing a ``size``-TB cache at cluster arrival rate ``rate``.

    Approximation: the router splits load in proportion to capacity, so
    every replica runs at the same *normalized* per-unit-capacity rate
    ``rate / Σ perf_scale`` and the reference profile cell at that rate
    describes each replica's queueing behaviour (a replica that is s×
    faster serving s× the arrivals is the reference server under time
    rescaling). Energy then scales by the fleet's summed per-type power
    relative to ``cap`` reference servers at the cell's operating point,
    and embodied compute sums each type's amortization-discounted rate —
    the terms that make an old-generation mix win on clean grids.

    ``type_profiles`` (``{replica type: Profile}``, e.g. from
    ``run_profiler(replica_type=...)``) replaces the rescaling with
    measured per-generation cells: each type's replicas are evaluated on
    that type's own profile at their *actual* per-replica rate
    ``rate · perf_scale / cap`` (no power inversion — the profile was
    metered on the type's own specs), and the fleet aggregates by request
    share. Types missing from the mapping fall back to the reference
    rescale. KV loads stay SSD-bound either way, which is exactly the
    error the measured profiles remove."""
    cap = fleet_capacity(fleet)
    norm_rate = rate / cap
    if not type_profiles:
        c = profile.interpolate(norm_rate, size)
        slo_frac = _saturated_slo(profile, norm_rate, c.slo_frac)
        util = _ref_util(c, carbon)
        ref_w = _ref_watts(carbon, util)
        fleet_w = sum(get_replica_type(t).server_power_w(util)
                      for t in fleet)
        op = carbon.operational_g(c.energy_per_req_kwh, ci) \
            * fleet_w / (cap * ref_w)
        emb_cache = carbon.cache_embodied_g(size, c.duration_per_req_s) / cap
        emb_comp = sum(get_replica_type(t).embodied_g(c.duration_per_req_s)
                       for t in fleet) / cap
        return (op + emb_cache + emb_comp) \
            * _idle_floor(profile, norm_rate), slo_frac

    from collections import Counter
    c_ref = profile.interpolate(norm_rate, size)
    op = slo_frac = 0.0
    for tname, count in Counter(fleet).items():
        rt = get_replica_type(tname)
        share = count * rt.perf_scale / cap       # fraction of requests
        per_replica_rate = rate * rt.perf_scale / cap
        tp = type_profiles.get(tname)
        if tp is not None:
            c = tp.interpolate(per_replica_rate, size)
            op_t = carbon.operational_g(c.energy_per_req_kwh, ci)
            slo_t = _saturated_slo(tp, per_replica_rate, c.slo_frac)
        else:                                     # reference rescale
            util = _ref_util(c_ref, carbon)
            op_t = carbon.operational_g(c_ref.energy_per_req_kwh, ci) \
                * rt.server_power_w(util) / (rt.perf_scale
                                             * _ref_watts(carbon, util))
            slo_t = _saturated_slo(profile, norm_rate, c_ref.slo_frac)
        op += share * op_t
        slo_frac += share * slo_t
    # embodied: same formula as the reference branch (the per-request
    # wall-clock share of the fleet's and cache's amortization), so
    # passing type_profiles shifts only the measured op/SLO terms
    emb_cache = carbon.cache_embodied_g(size, c_ref.duration_per_req_s) \
        / cap
    emb_comp = sum(get_replica_type(t).embodied_g(c_ref.duration_per_req_s)
                   for t in fleet) / cap
    return (op + emb_cache + emb_comp) \
        * _idle_floor(profile, norm_rate), slo_frac


# dedicated decode pools drop the (1 + decode_interference · ū) TPOT
# inflation the reference profile was measured under (ū ≈ 0.55 average
# prefill utilization across profiled cells): a decode capacity unit
# sustains ~1.5× the per-unit token rate of a fused server
DISAGG_DECODE_SPEEDUP = 1.5
# dedicated decode pools run power-capped (ServingModel
# .decode_pool_power_frac documents the mechanism); the solver prices
# their draw with the same default factor
DECODE_POOL_POWER_FRAC = 0.6
# the analytic decode-attainment curve is nearly a step function of the
# arrival rate, so a pool sized exactly to the *predicted* rate flips to
# violating on forecast error; size against this demand headroom instead
# (load-predictor MAPE band, cf. fig17)
DECODE_DEMAND_MARGIN = 1.15


def _disagg_decode_slo(model, slo: SLO, rate: float,
                       fleet: Sequence[str], out_mean: float) -> float:
    """Analytic TPOT attainment of a dedicated decode pool — the same
    continuous-batching fixed point (no prefill interference) plus
    overload penalty the ``DisaggEngine`` simulates, closed over the
    engine's U(0.92, 1.08) per-request noise. Mirroring the engine
    exactly is what lets the solver credit fast decode generations their
    absolute-SLO headroom, which the reference profile's cells (measured
    on the fused l40 platform) cannot express."""
    K = len(fleet)
    lam = rate * DECODE_DEMAND_MARGIN / K
    dec_slow = float(np.mean([1.0 / get_replica_type(t).perf_scale
                              for t in fleet]))
    tpot, _ = model.decode_fixed_point(lam, out_mean, dec_slow)
    lo, hi = 0.92 * tpot, 1.08 * tpot
    if hi <= slo.tpot_s:
        return 1.0
    if lo >= slo.tpot_s:
        return 0.0
    return (slo.tpot_s - lo) / (hi - lo)


def _disagg_cell_metrics(profile: Profile, rate: float, size: float,
                         plan: ResourcePlan, ci: float,
                         carbon: CarbonModel, slo: Optional[SLO] = None,
                         model=None):
    """Predicted per-request carbon and SLO fraction for a disaggregated
    plan at cluster arrival rate ``rate``.

    The pools bind on different metrics. The prefill pool's TTFT-side
    attainment comes from the reference cell at its capacity-normalized
    rate (plus the saturation penalty past the profiled envelope). The
    decode pool's TPOT-side attainment is computed analytically from the
    serving model when available (``_disagg_decode_slo``), else read from
    the cell at its normalized rate discounted by
    ``DISAGG_DECODE_SPEEDUP`` (no prefill interference on a dedicated
    pool). Each pool is priced with the *full* reference cell at its own
    operating point scaled by its fleet's draw per capacity unit — both
    pools burn their whole-server (idle-dominated) power for the entire
    window, the honest cost of splitting; the decode pool's draw carries
    the power cap. Embodied sums both typed fleets' amortization-
    discounted per-second rates over the request stream."""
    cp = plan.prefill.capacity
    cd = plan.decode.capacity
    c_pre = profile.interpolate(rate / cp, size)
    slo_t = _saturated_slo(profile, rate / cp, c_pre.slo_ttft_frac)
    if model is not None and c_pre.avg_prompt_tokens > 0:
        # the KV handoff shifts every TTFT right by the prompt's
        # transfer time; approximate the attained mass pushed past the
        # SLO as the shifted fraction of the SLO budget
        xfer = c_pre.avg_prompt_tokens * model.kv_bytes_per_token \
            / (model.kv_transfer_gbps * 1e9)
        slo_t *= max(0.0, 1.0 - xfer / (slo.ttft_s if slo is not None
                                        else 2.5))
    rate_d = rate / (cd * DISAGG_DECODE_SPEEDUP)
    c_dec = profile.interpolate(rate_d, size)
    if model is not None and slo is not None and c_pre.avg_out_tokens > 0:
        slo_p = _disagg_decode_slo(model, slo, rate, plan.decode.fleet,
                                   c_pre.avg_out_tokens)
    else:
        slo_p = _saturated_slo(profile, rate_d, c_dec.slo_tpot_frac)
    slo_frac = slo_t * slo_p

    util_p = _ref_util(c_pre, carbon)
    wp = sum(get_replica_type(t).server_power_w(util_p)
             for t in plan.prefill.fleet)
    op = carbon.operational_g(c_pre.energy_per_req_kwh, ci) \
        * wp / (cp * _ref_watts(carbon, util_p)) \
        * _idle_floor(profile, rate / cp)
    util_d = _ref_util(c_dec, carbon)
    cap_frac = model.decode_pool_power_frac if model is not None \
        else DECODE_POOL_POWER_FRAC
    wd = cap_frac * sum(get_replica_type(t).server_power_w(util_d)
                        for t in plan.decode.fleet)
    op += carbon.operational_g(c_dec.energy_per_req_kwh, ci) \
        * wd / (cd * DISAGG_DECODE_SPEEDUP
                * _ref_watts(carbon, util_d)) \
        * _idle_floor(profile, rate_d)
    inv_rate = 1.0 / max(rate, 1e-3)
    emb_cache = carbon.cache_embodied_g(size, inv_rate)
    emb_comp = sum(get_replica_type(t).embodied_g(inv_rate)
                   for t in plan.all_types)
    return op + emb_cache + emb_comp, slo_frac


def _option_plan(option, sized: bool = False) -> ResourcePlan:
    """Normalize a solver option (count / mix / plan) to a ResourcePlan.
    The size half of the option is either a bare TB float or a sized
    ``StorageSpec`` (the storage search), which the sized plan carries."""
    s, k = option
    if isinstance(k, ResourcePlan):
        plan = k
    elif isinstance(k, int):
        plan = ResourcePlan.single(None, n_replicas=k)
    else:
        plan = ResourcePlan.single(None, fleet=tuple(k))
    if not sized:
        return plan
    if isinstance(s, StorageSpec):
        return _dc_replace(plan, cache_tb=s.total_tb, storage=s)
    return plan.with_cache(s)


def _storage_cell_adjust(profile: Profile, norm_rate: float,
                         spec: StorageSpec, ci: float, carbon: CarbonModel,
                         cell, c: float, f: float,
                         divisor: float, cluster_rate: float, model,
                         wear_aware: bool):
    """Adjust a flat-SSD cell prediction to a typed ``StorageSpec``:

    * **idle power** — the profiled energy embeds the flat
      ``size × ssd_power_w_per_tb`` draw; replace it with the tiers'
      per-device draw (a DRAM tier is ~35× the W/TB of NVMe).
    * **embodied** — replace the flat calendar amortization with the
      per-tier device rates; with ``wear_aware`` the predicted host
      write rate (``rate × write_bytes_per_req`` from the cell) engages
      the wear clock, so churn-heavy operating points see their
      endurance-limited devices amortize over the shorter wear lifetime.
    * **attainment** — per-tier bandwidth changes the KV-load part of
      the service time, and queue wait compounds service time
      (Takeaway 2), so the shift is modeled as *time rescaling*: a
      server whose mean service shrinks by factor ``q`` behaves like
      the reference server at rate ``q × rate`` — the same argument the
      fleet solver's capacity normalization rests on.  The mean service
      is reconstructed from the cell's hit statistics and the serving
      model's constants; the hot tier's share of hit bytes is estimated
      from the profile's own hit-rate curve (a hot tier of capacity
      ``h`` keeps roughly what a cache of size ``h`` alone would hit).

    Every delta is exactly 0.0 (and ``q == 1``) for the default flat
    spec with ``wear_aware=False`` — that configuration bit-reproduces
    the untyped solve (tested)."""
    size = spec.usable_tb       # the cell was interpolated at this size
    dur = cell.duration_per_req_s
    dw = spec.idle_w - size * carbon.hw.ssd_power_w_per_tb
    c += ci * dw * dur / 3.6e6 / divisor
    rates = None
    if wear_aware:
        rates = cluster_rate * cell.write_bytes_per_req
    emb_flat = carbon.cache_embodied_g(size, dur)
    emb_spec = carbon.cache_embodied_g(size, dur, storage=spec,
                                       write_bytes_per_s=rates)
    c += (emb_spec - emb_flat) / divisor
    if model is not None and cell.hit_rate > 0.0:
        ref_gbps = model.ssd_read_gbps
        hot_share = 0.0
        if spec.is_tiered:
            hot_cell = profile.interpolate(norm_rate,
                                           spec.hot.capacity_tb)
            hot_share = min(hot_cell.hit_rate / max(cell.hit_rate, 1e-9),
                            1.0)
        hit_bytes = cell.hit_rate * cell.avg_prompt_tokens \
            * model.kv_bytes_per_token
        compute_s = model.prefill_base_s \
            + (1.0 - cell.hit_rate) * cell.avg_prompt_tokens \
            / model.prefill_tok_per_s
        # symmetric forms so the default flat spec yields q == 1.0
        # bit-exactly (same expression on both sides)
        inv_ref = 1.0 / (ref_gbps * 1e9)
        inv_spec = hot_share / (spec.hot.dev.read_gbps * 1e9) \
            + (1.0 - hot_share) / (spec.cold.dev.read_gbps * 1e9)
        load_ref = hit_bytes * inv_ref
        load_spec = hit_bytes * inv_spec
        q = (compute_s + load_spec) / max(compute_s + load_ref, 1e-9)
        if q != 1.0:
            cq = profile.interpolate(norm_rate * q, size)
            fq = _saturated_slo(profile, norm_rate * q, cq.slo_frac)
            f0 = _saturated_slo(profile, norm_rate, cell.slo_frac)
            if f0 > 0.0:
                f = min(1.0, f * fq / f0)
            elif fq > 0.0:
                f = min(1.0, fq)
    return c, f


# --------------------------------------------------------------------- #
# Transition-aware switching costs
# --------------------------------------------------------------------- #
# solver-side estimate of a drained replica's powered residual backlog
# (the engine measures the real one; the solver prices the expectation)
TRANSITION_DRAIN_S_EST = 30.0


@functools.lru_cache(maxsize=65536)
def _shape_switch_kwh(old_shape: ResourcePlan, new_shape: ResourcePlan,
                      cfg: TransitionConfig) -> float:
    """Boot + drain energy of switching between two plan *shapes*
    (cache-stripped plans: the fleet diff does not depend on the cache
    size). Memoized — the hourly loop re-solves with the same candidate
    set every hour."""
    tr = PlanTransition.diff(old_shape, new_shape)
    kwh = sum(get_replica_type(t).idle_energy_kwh(cfg.boot_s(t))
              for _, t in tr.boots)
    if cfg.drain:
        kwh += sum(get_replica_type(t)
                   .idle_energy_kwh(TRANSITION_DRAIN_S_EST)
                   for _, t in tr.drains)
    return kwh


def _fleet_key(plan: ResourcePlan):
    """Structural fleet identity of a plan — the part the dwell pins
    (routing knobs and cache size may differ between a live resolved
    plan and the unresolved candidate it came from)."""
    return tuple((p.role, p.fleet) for p in plan.pools)


def _migration_kwh(old_plan: ResourcePlan, new_plan: ResourcePlan,
                   cfg: TransitionConfig, model=None) -> float:
    """Partitioned-ring migration I/O energy: moved bytes estimated as
    the remapped key-space share (``|m-n|/max(m,n)``, the consistent-
    hashing minimal-movement bound) of the smaller allocation assumed
    full — the conservative bound."""
    if cfg.rebalance != "migrate" or cfg.is_free \
            or not old_plan.prefill.partitioned:
        return 0.0
    n_old = old_plan.prefill.n_replicas
    n_new = new_plan.prefill.n_replicas
    if n_old == n_new:
        return 0.0
    bytes_moved = ring_moved_fraction(n_old, n_new) \
        * min(old_plan.cache_tb or 0.0, new_plan.cache_tb or 0.0) * 1e12
    gbps = cfg.kv_transfer_gbps if cfg.kv_transfer_gbps is not None \
        else (model.kv_transfer_gbps if model is not None else 25.0)
    return kv_migration_energy_kwh(bytes_moved, gbps)


def _pair_switch_kwh(old_plan: ResourcePlan, new_plan: ResourcePlan,
                     cfg: TransitionConfig, model=None) -> float:
    """Full predicted switching energy between two *sized* plans: the
    memoized shape part (boot + drain) plus the partitioned-ring KV
    migration."""
    kwh = _shape_switch_kwh(_dc_replace(old_plan, cache_tb=None,
                                        storage=None),
                            _dc_replace(new_plan, cache_tb=None,
                                        storage=None), cfg)
    return kwh + _migration_kwh(old_plan, new_plan, cfg, model=model)


def _transition_matrices(opt_plans: Sequence[ResourcePlan],
                         cfg: TransitionConfig, model=None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """``E[o, o']`` switching energy (kWh) between every option pair and
    ``S[o, o']`` whether the pair differs in *shape* (fleet/pools — the
    part ``min_dwell_hours`` pins; cache-only moves stay free to change
    hourly, matching the paper's resize loop)."""
    n_opt = len(opt_plans)
    shapes = [_dc_replace(p, cache_tb=None, storage=None)
              for p in opt_plans]
    keys = [_fleet_key(p) for p in opt_plans]
    kid_map: Dict[object, int] = {}
    # (the original O(|options|²) per-pair loop survives as
    # _transition_matrices_reference for regression tests/benchmarks)
    kid = np.array([kid_map.setdefault(k, len(kid_map)) for k in keys])
    S = kid[:, None] != kid[None, :]
    np.fill_diagonal(S, False)

    # boot/drain energy only depends on the (shape, shape) class pair —
    # evaluate once per distinct pair instead of per option pair
    sid_map: Dict[object, int] = {}
    sid = np.array([sid_map.setdefault(s, len(sid_map)) for s in shapes])
    D = len(sid_map)
    rep = np.zeros(D, dtype=np.int64)
    rep[sid] = np.arange(n_opt)            # any member: shapes identical
    Esh = np.zeros((D, D))
    for a in range(D):
        for b in range(D):
            if a != b:
                Esh[a, b] = _shape_switch_kwh(shapes[rep[a]],
                                              shapes[rep[b]], cfg)
    E = Esh[sid[:, None], sid[None, :]]

    # partitioned-ring migration term, vectorized over the sized plans
    if cfg.rebalance == "migrate" and not cfg.is_free:
        part = np.array([p.prefill.partitioned for p in opt_plans])
        if part.any():
            nrep = np.array([p.prefill.n_replicas for p in opt_plans])
            cache = np.array([p.cache_tb or 0.0 for p in opt_plans])
            gbps = cfg.kv_transfer_gbps \
                if cfg.kv_transfer_gbps is not None \
                else (model.kv_transfer_gbps if model is not None
                      else 25.0)
            RMF = np.zeros((n_opt, n_opt))
            for a in np.unique(nrep):
                for b in np.unique(nrep):
                    if a != b:
                        RMF[np.ix_(nrep == a, nrep == b)] = \
                            ring_moved_fraction(int(a), int(b))
            bytes_moved = RMF \
                * np.minimum(cache[:, None], cache[None, :]) * 1e12
            mig = kv_migration_energy_kwh(bytes_moved, gbps)
            E = E + np.where(part[:, None]
                             & (nrep[:, None] != nrep[None, :]),
                             mig, 0.0)
    E = np.where(S, E, 0.0)
    return E, S


def _transition_matrices_reference(opt_plans: Sequence[ResourcePlan],
                                   cfg: TransitionConfig, model=None
                                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Pre-vectorization per-pair loop — the oracle
    ``_transition_matrices`` is regression-tested against."""
    n_opt = len(opt_plans)
    shapes = [_dc_replace(p, cache_tb=None, storage=None)
              for p in opt_plans]
    keys = [_fleet_key(p) for p in opt_plans]
    E = np.zeros((n_opt, n_opt))
    S = np.zeros((n_opt, n_opt), dtype=bool)
    for i in range(n_opt):
        for j in range(n_opt):
            if i == j:
                continue
            S[i, j] = keys[i] != keys[j]
            if S[i, j]:
                E[i, j] = _shape_switch_kwh(shapes[i], shapes[j], cfg) \
                    + _migration_kwh(opt_plans[i], opt_plans[j], cfg,
                                     model=model)
    return E, S


class PlannerCache:
    """Cross-solve memo for the hourly control loop.

    The controller re-solves every hour with the *same* candidate set;
    the O(|options|²) pairwise transition diff and the per-shape switch
    energies do not change between those solves.  A ``PlannerCache``
    threaded through ``solve_cluster_schedule(solver_cache=...)`` keeps
    the matrices across calls (``_shape_switch_kwh`` already memoizes the
    per-pair energies process-wide; this adds the assembled array)."""

    def __init__(self):
        self._transitions: Dict[tuple, Tuple[np.ndarray, np.ndarray]] = {}

    def transition_matrices(self, opt_plans, cfg: TransitionConfig,
                            model=None):
        key = (tuple(opt_plans), cfg,
               getattr(model, "kv_transfer_gbps", None))
        hit = self._transitions.get(key)
        if hit is None:
            hit = _transition_matrices(opt_plans, cfg, model=model)
            self._transitions[key] = hit
        return hit


def _pareto_keep(Ct, Ft, class_ids=None) -> np.ndarray:
    """Indices of options that can appear in *some* optimal DP schedule
    at this hour (lossless dominance prune).

    Option ``j`` is dropped iff some option ``i`` in the same
    switching-cost class has strictly lower carbon with at least equal
    attainment, or is an exact (carbon, attainment) duplicate with a
    lower index.  Substituting ``i`` for ``j`` in any path leaves every
    switching cost unchanged (same class), lands at a weakly higher
    bucket, and strictly lowers the cost (or ties it bit-exactly at the
    same bucket with a lower index, which every DP tie-break already
    prefers) — so no reconstructed optimal schedule contains ``j``.
    Weak dominance with *equal* carbon and higher attainment is NOT
    taken: the exhaustive DP's earliest-bucket final tie-break could
    still pick ``j``, changing the returned (equal-cost) plan."""
    Ct = np.asarray(Ct)
    Ft = np.asarray(Ft)
    S = len(Ct)
    cls = np.zeros(S, dtype=np.int64) if class_ids is None \
        else np.asarray(class_ids)
    keep = np.ones(S, dtype=bool)
    idx = np.arange(S)
    for u in np.unique(cls):
        m = idx[cls == u]
        if len(m) < 2:
            continue
        Cm = Ct[m]
        Fm = Ft[m]
        order = np.lexsort((m, -Fm, Cm))      # C asc, F desc, idx asc
        bestF = -np.inf
        gi = 0
        while gi < len(order):
            gj = gi
            cval = Cm[order[gi]]
            groupF = bestF
            seen: set = set()
            while gj < len(order) and Cm[order[gj]] == cval:
                o = order[gj]
                f = Fm[o]
                if f <= bestF or f in seen:
                    keep[m[o]] = False
                else:
                    seen.add(f)
                if f > groupF:
                    groupF = f
                gj += 1
            bestF = groupF
            gi = gj
    return idx[keep]


def _beam_select(kept, Ct, Ft, class_ids, beam_width: int):
    """Shrink a kept set to ≤ ``beam_width`` options per switching class:
    the cheapest-carbon members plus the class's max-attainment member
    (so a feasibility-critical option always survives).  Returns the new
    kept set and this hour's per-request optimality bound: the max over
    dropped options of the carbon premium of the cheapest same-class
    survivor with at least the dropped option's attainment — what
    patching any exhaustive-optimal path that used a dropped option
    costs (switching costs are class-invariant, buckets only improve)."""
    cls = np.zeros(len(Ct), dtype=np.int64) if class_ids is None \
        else np.asarray(class_ids)
    sel: List[int] = []
    bound = 0.0
    for u in np.unique(cls[kept]):
        m = kept[cls[kept] == u]
        if len(m) <= beam_width:
            sel.extend(int(i) for i in m)
            continue
        by_cost = m[np.lexsort((m, Ct[m]))]
        chosen = set(int(i) for i in by_cost[:beam_width])
        fbest = int(m[np.lexsort((m, -Ft[m]))[0]])
        if fbest not in chosen:
            chosen.discard(int(by_cost[beam_width - 1]))
            chosen.add(fbest)
        kept_arr = np.array(sorted(chosen))
        for j in m:
            if int(j) in chosen:
                continue
            cands = kept_arr[Ft[kept_arr] >= Ft[j]]
            if len(cands):
                bound = max(bound,
                            max(0.0, float(Ct[cands].min() - Ct[j])))
            else:                   # NaN attainment — no patch target
                bound = float("inf")
        sel.extend(int(i) for i in kept_arr)
    return np.array(sorted(sel)), bound


def _hour_keeps(C, F, n, cls, prune: bool, beam_width):
    """Per-hour kept option sets (and the accumulated beam bound)."""
    T, n_opt = C.shape
    bw = beam_width if beam_width is not None and beam_width >= 1 \
        else None
    keeps = []
    bound_total = 0.0
    for t in range(T):
        kt = _pareto_keep(C[t], F[t], cls) if prune \
            else np.arange(n_opt)
        if bw is not None:
            # the bound is in grams: per-request premium × hourly requests
            kt, bnd = _beam_select(kt, C[t], F[t], cls, bw)
            bound_total += float(n[t]) * bnd
        keeps.append(kt)
    return keeps, (bound_total if bw is not None else None)


def _solve_dp_transition_reference(C, F, n, options, rho, t_start, E, S,
                                   e_init, cis, min_dwell: int,
                                   dwell_offset: int, lock0=None,
                                   buckets: int = 400) -> SolveResult:
    """Original per-bucket-loop transition DP — kept as the oracle the
    vectorized engine is regression-tested (and benchmarked) against.
    O(T · buckets · |options|²) with a (T, B+1, O) int64 backpointer."""
    T, n_opt = C.shape
    total = float(n.sum())
    target = rho * total
    scale = buckets / max(total, 1e-9)
    INF = float("inf")
    oi = np.arange(n_opt)
    cis = np.asarray(cis, dtype=float)

    dp = np.full((buckets + 1, n_opt), INF)
    back = np.full((T, buckets + 1, n_opt), -1, dtype=np.int64)
    swg0 = e_init * cis[0] if e_init is not None else np.zeros(n_opt)
    cost0 = n[0] * C[0] + swg0
    if lock0 is not None:
        # re-solve mid-dwell-block: hour 0 may not change the shape
        cost0 = np.where(lock0, INF, cost0)
    nb0 = np.minimum((n[0] * F[0] * scale).astype(int), buckets)
    dp[nb0, oi] = np.minimum(dp[nb0, oi], cost0)

    for t in range(1, T):
        switch_ok = min_dwell <= 1 or (t + dwell_offset) % min_dwell == 0
        swg = E * cis[t]
        if not switch_ok:
            swg = swg + np.where(S, INF, 0.0)
        nCt = n[t] * C[t]
        nb = np.minimum(
            (np.arange(buckets + 1)[:, None] + n[t] * F[t] * scale)
            .astype(int), buckets)                      # (B+1, O)
        ndp = np.full((buckets + 1, n_opt), INF)
        for b in range(buckets + 1):
            row = dp[b]
            fin = row < INF
            if not fin.any():
                continue
            tot = np.where(fin[:, None], row[:, None] + swg, INF)
            pred = np.argmin(tot, axis=0)
            cost = tot[pred, oi] + nCt
            nbb = nb[b]
            cur = ndp[nbb, oi]
            m = cost < cur
            if m.any():
                ndp[nbb[m], oi[m]] = cost[m]
                back[t, nbb[m], oi[m]] = b * n_opt + pred[m]
        dp = ndp

    tb = int(np.floor(target * scale))
    flat_best = None
    for b in range(tb, buckets + 1):
        o = int(np.argmin(dp[b]))
        if dp[b, o] < INF and (flat_best is None
                               or dp[b, o] < flat_best[2]):
            flat_best = (b, o, dp[b, o])
    feasible = flat_best is not None
    if not feasible:
        choice = [_best_effort(F[t], C[t]) for t in range(T)]
    else:
        b, o, _ = flat_best
        choice = [0] * T
        for t in range(T - 1, 0, -1):
            choice[t] = o
            enc = back[t, b, o]
            o = int(enc % n_opt)
            b = int(enc // n_opt)
        choice[0] = o
    tg = [float(swg0[choice[0]])] + [
        float(E[choice[t - 1], choice[t]] * cis[t]) for t in range(1, T)]
    obj = float(sum(n[t] * C[t][c] for t, c in enumerate(choice))
                + sum(tg))
    return SolveResult([options[c] for c in choice], obj, feasible,
                       time.time() - t_start, "dp+transition",
                       transition_g=tg)


def _solve_dp_transition(C, F, n, options, rho, t_start, E, S, e_init,
                         cis, min_dwell: int, dwell_offset: int,
                         lock0=None, buckets: int = 400,
                         prune: bool = False, beam_width=None,
                         class_keys=None) -> SolveResult:
    """Transition-aware DP: state = (satisfied-count bucket, option),
    value = min carbon *including* the switching cost paid at each hour
    boundary — so the schedule exhibits hysteresis instead of flapping
    between near-tied options whenever the CI trace wiggles.
    ``min_dwell`` restricts *shape* changes to hours where
    ``(t + dwell_offset) % min_dwell == 0`` (block-aligned dwell; cache
    size may still move hourly).

    Vectorized engine (bit-identical to
    ``_solve_dp_transition_reference``, tested): options are grouped
    into switching-cost *classes* (``class_keys``; same E/S rows and
    columns), the old-option axis is collapsed class-first
    (min within class, then a lexicographic (value, option-index) pass
    per class — exactly ``np.argmin``'s first-occurrence tie-break),
    and the bucket scatter uses the per-column constant shift
    ``nb = b + k`` whenever the float bucket arithmetic admits one
    (verified cell-exact per column; the rare rounding-broken column
    falls back to the original per-bucket loop).  ``prune`` applies the
    per-hour ``_pareto_keep`` dominance filter within classes —
    lossless — and ``beam_width`` the per-class beam with its reported
    ``beam_bound_g``.  Backpointers are per-hour ragged
    (B+1, |kept_t|) int32/int64 arrays instead of the reference's
    (T, B+1, O) int64 block.  O(T·B·(|kept| + U·|classes|))."""
    T, n_opt = C.shape
    total = float(n.sum())
    target = rho * total
    scale = buckets / max(total, 1e-9)
    B = buckets
    INF = float("inf")
    cis = np.asarray(cis, dtype=float)

    if class_keys is not None:
        ids: Dict[object, int] = {}
        cls = np.empty(n_opt, dtype=np.int64)
        for i, key in enumerate(class_keys):
            cls[i] = ids.setdefault(key, len(ids))
    else:
        # no class structure known: every option is its own class
        # (always sound — just prunes/factors nothing across options)
        cls = np.arange(n_opt)

    keeps, bound_total = _hour_keeps(C, F, n, cls, prune, beam_width)

    enc_dtype = np.int32 if (B + 1) * n_opt < 2**31 else np.int64
    swg0 = e_init * cis[0] if e_init is not None else np.zeros(n_opt)
    K0 = keeps[0]
    cost0 = (n[0] * C[0] + swg0)[K0]
    if lock0 is not None:
        # re-solve mid-dwell-block: hour 0 may not change the shape
        cost0 = np.where(lock0[K0], INF, cost0)
    nb0 = np.minimum((n[0] * F[0] * scale).astype(int)[K0], B)
    dp = np.full((B + 1, len(K0)), INF)
    dp[nb0, np.arange(len(K0))] = cost0

    backs: List[np.ndarray] = []
    bgrid = np.arange(B + 1)
    for t in range(1, T):
        Kp = keeps[t - 1]
        Kt = keeps[t]
        nK = len(Kt)
        switch_ok = min_dwell <= 1 or (t + dwell_offset) % min_dwell == 0

        # ---- collapse the old-option axis class-first ---- #
        uniq_p, first_p, inv_p = np.unique(cls[Kp], return_index=True,
                                           return_inverse=True)
        U = len(uniq_p)
        G = np.empty((B + 1, U))
        Garg = np.empty((B + 1, U), dtype=np.int64)   # position in Kp
        for ui in range(U):
            pos = np.flatnonzero(inv_p == ui)
            sub = dp[:, pos]
            am = sub.argmin(axis=1)       # first min = lowest global idx
            G[:, ui] = sub[bgrid, am]
            Garg[:, ui] = pos[am]
        uniq_t, first_t, inv_t = np.unique(cls[Kt], return_index=True,
                                           return_inverse=True)
        V = len(uniq_t)
        repg_p = Kp[first_p]
        repg_t = Kt[first_t]
        W = E[np.ix_(repg_p, repg_t)] * cis[t]
        if not switch_ok:
            W = W + np.where(S[np.ix_(repg_p, repg_t)], INF, 0.0)

        # H[b, v] = min_u G[b, u] + W[u, v]; ties resolved on the actual
        # minimizing *old option's* global index — np.argmin semantics
        best = np.full((B + 1, V), INF)
        bestrep = np.full((B + 1, V), np.iinfo(np.int64).max,
                          dtype=np.int64)
        for ui in range(U):
            val = G[:, ui][:, None] + W[ui][None, :]
            gid = Kp[Garg[:, ui]][:, None]
            better = (val < best) | ((val == best) & (gid < bestrep))
            best = np.where(better, val, best)
            bestrep = np.where(better, gid, bestrep)

        nCt = n[t] * C[t]
        costm = best[:, inv_t] + nCt[Kt][None, :]         # (B+1, nK)
        predg = bestrep[:, inv_t]                         # global old opt

        # ---- bucket scatter ---- #
        # the reference computes nb = min(int(b + n·F·scale), B); the
        # addend is b-independent, so each column is a constant shift
        # *unless* float rounding of (b + add) crosses an integer —
        # verified per column on the identical expression
        raw = (bgrid[:, None] + (n[t] * F[t] * scale)[Kt][None, :]) \
            .astype(int)
        D = raw - bgrid[:, None]
        const = (D == D[0]).all(axis=0)
        ndp = np.full((B + 1, nK), INF)
        nback = np.full((B + 1, nK), -1, dtype=enc_dtype)
        cols = np.arange(nK)
        for k in np.unique(D[0][const]):
            cset = cols[const & (D[0] == k)]
            k = int(min(k, B))
            if k < B:
                # buckets k..B-1: exactly one source bucket each
                ndp[k:B, cset] = costm[0:B - k, cset]
                nback[k:B, cset] = \
                    (bgrid[0:B - k, None] * n_opt
                     + predg[0:B - k][:, cset]).astype(enc_dtype)
            lo = max(0, B - k)
            sub = costm[lo:, cset]         # tail: everything clips to B
            am = sub.argmin(axis=0)        # first min = lowest bucket
            ndp[B, cset] = sub[am, np.arange(len(cset))]
            nback[B, cset] = ((lo + am) * n_opt
                              + predg[lo + am, cset]).astype(enc_dtype)
        for j in cols[~const]:             # rounding-broken shift: exact
            nbc = np.minimum(raw[:, j], B)
            for b in range(B + 1):
                c = costm[b, j]
                if c < ndp[nbc[b], j]:
                    ndp[nbc[b], j] = c
                    nback[nbc[b], j] = b * n_opt + predg[b, j]
        # positions whose best predecessor is itself unreachable stay INF
        # (INF + W = INF), matching the reference's skipped rows
        nback[~np.isfinite(ndp)] = -1
        dp = ndp
        backs.append(nback)

    tb = int(np.floor(target * scale))
    KT = keeps[T - 1]
    flat_best = None
    for b in range(tb, B + 1):
        pos = int(np.argmin(dp[b]))
        if dp[b, pos] < INF and (flat_best is None
                                 or dp[b, pos] < flat_best[2]):
            flat_best = (b, pos, dp[b, pos])
    feasible = flat_best is not None
    if not feasible:
        choice = [_best_effort(F[t], C[t]) for t in range(T)]
    else:
        b, pos, _ = flat_best
        o = int(KT[pos])
        choice = [0] * T
        for t in range(T - 1, 0, -1):
            choice[t] = o
            enc = int(backs[t - 1][b, pos])
            o = int(enc % n_opt)
            b = int(enc // n_opt)
            pos = int(np.searchsorted(keeps[t - 1], o))
        choice[0] = o
    tg = [float(swg0[choice[0]])] + [
        float(E[choice[t - 1], choice[t]] * cis[t]) for t in range(1, T)]
    obj = float(sum(n[t] * C[t][c] for t, c in enumerate(choice))
                + sum(tg))
    return SolveResult([options[c] for c in choice], obj, feasible,
                       time.time() - t_start, "dp+transition",
                       transition_g=tg, beam_bound_g=bound_total)


def _tier_protected_slo(cell, rate: float, shares: Dict[str, float]
                        ) -> float:
    """Share-weighted attainment of the *protected* tiers under priority
    rate-thinning.

    The engine serves tiers in strict priority order (scavengers are
    even preempted), so a request in tier ``t`` effectively queues
    behind only the traffic at its priority and above — tier ``t``'s
    attainment is approximated by the profile cell evaluated at
    ``rate × (cumulative share through t's priority)``.  Gold is
    predicted at the gold-only rate (the protection the engine actually
    delivers), and unprotected tiers contribute load to the thinning of
    everyone below them but no term to the constraint.  The per-tier SLO
    widening (standard 1.5×, see ``tenants.TIERS``) is *not* credited —
    the profile measures attainment against the base SLO — which keeps
    the prediction conservative for the looser tiers."""
    order = sorted(shares, key=lambda t: TIERS[t].priority)
    cum = num = den = 0.0
    for t in order:
        w = shares[t]
        cum += w
        if not TIERS[t].protected or w <= 0.0:
            continue
        num += w * cell(rate * cum)[1]
        den += w
    if den == 0.0:            # nothing protected: fall back to average
        return cell(rate)[1]
    return num / den


# --------------------------------------------------------------------- #
# Columnar option-table construction
# --------------------------------------------------------------------- #
# The scalar closures above (`_cluster_cell_metrics` & co) are the
# readable specification; `_build_option_tables` below evaluates the same
# formulas columnar over the whole (hour, option) grid with a handful of
# `Profile.interpolate_many` calls.  Every array expression mirrors the
# scalar float-op order term by term (Python's `sum()` accumulation
# included), so both builders return bit-identical tables — tested, and
# the `vectorize=False` escape hatch keeps the scalar path reachable.


def _sat_arr(rs_max: float, norm, slo_frac):
    """Array form of ``_saturated_slo`` (same op order)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        pen = slo_frac * (rs_max / norm) ** 2
    return np.where(norm > rs_max, pen, slo_frac)


def _floor_arr(rmin: float, norm):
    """Array form of ``_idle_floor``."""
    if rmin <= 0.0:
        return np.ones_like(norm)
    with np.errstate(divide="ignore"):
        below = rmin / np.maximum(norm, rmin * 1e-3)
    return np.where(norm >= rmin, 1.0, below)


def _util_arr(avg_power_w, carbon: CarbonModel):
    """Array form of ``_ref_util``."""
    hw = carbon.hw
    base = hw.gpu_power_idle_w + hw.cpu_power_w + hw.mem_power_w
    span = hw.gpu_power_max_w - hw.gpu_power_idle_w
    return np.clip((avg_power_w - base) / max(span, 1e-9), 0.0, 1.0)


def _ref_watts_arr(carbon: CarbonModel, util):
    hw = carbon.hw
    return hw.gpu_power_idle_w \
        + util * (hw.gpu_power_max_w - hw.gpu_power_idle_w) \
        + hw.cpu_power_w + hw.mem_power_w


def _type_power_arr(rt, util):
    """``ReplicaType.server_power_w`` over a utilization array."""
    hw = rt.hw
    gpu_w = hw.gpu_power_idle_w + util * (hw.gpu_power_max_w
                                          - hw.gpu_power_idle_w)
    return gpu_w + hw.cpu_power_w + hw.mem_power_w


def _fleet_power_arr(fleet, util):
    """Termwise ``sum(rt.server_power_w(util) for t in fleet)`` — the
    accumulation order matches Python's ``sum()`` so the result is
    bit-identical to the scalar path."""
    acc = 0.0
    for t in fleet:
        acc = acc + _type_power_arr(get_replica_type(t), util)
    return acc


def _fleet_embodied_arr(fleet, seconds):
    """Termwise ``sum(rt.embodied_g(seconds) for t in fleet)``."""
    acc = 0.0
    for t in fleet:
        rt = get_replica_type(t)
        lt = rt.hw.lifetime_years * SECONDS_PER_YEAR
        acc = acc + (seconds / lt) * rt.effective_embodied_kg * 1000.0
    return acc


def _cache_emb_arr(carbon: CarbonModel, alloc_tb, seconds):
    """Array form of the flat ``CarbonModel.cache_embodied_g``."""
    lt = carbon.hw.ssd_lifetime_years * SECONDS_PER_YEAR
    return alloc_tb * (seconds / lt) * carbon.hw.ssd_kg_per_tb * 1000.0


def _build_option_tables(profile: Profile, options, pred_rates, pred_cis,
                         slo: Optional[SLO], carbon: CarbonModel, model,
                         type_profiles, wear_aware: bool, shares,
                         plans_mode: bool, fleets_mode: bool):
    """Vectorized (T, O) carbon / attainment tables for the cluster
    solve — one ``Profile.interpolate_many`` sweep per table instead of
    T·O scalar ``interpolate`` calls.  Bit-identical to
    ``_build_option_tables_scalar`` (the original per-cell closures)."""
    from collections import Counter      # noqa: F401  (parity with scalar)
    T = len(pred_rates)
    O = len(options)          # noqa: E741
    rates_T = np.asarray(pred_rates, dtype=float)
    cis = np.asarray(pred_cis, dtype=float)[:, None]
    rs_max = max(profile.rates)
    rmin = min(profile.rates)

    specs = [s if isinstance(s, StorageSpec) else None for s, _ in options]
    sizes_o = np.array([sp.usable_tb if sp is not None else float(s)
                        for (s, _), sp in zip(options, specs)])
    div = np.ones(O)
    is_disagg = np.zeros(O, dtype=bool)
    groups: Dict[object, List[int]] = {}
    for i, (s, k) in enumerate(options):
        if plans_mode and isinstance(k, ResourcePlan) \
                and k.is_disaggregated:
            if specs[i] is not None:
                raise ValueError("the storage search does not support "
                                 "disaggregated candidates yet")
            is_disagg[i] = True
            div[i] = k.prefill.capacity
        elif plans_mode or fleets_mode:
            fl = k.serve.fleet if isinstance(k, ResourcePlan) else k
            div[i] = fleet_capacity(fl)
        else:
            div[i] = float(k)
        groups.setdefault(k, []).append(i)

    st_cols = [i for i in range(O) if specs[i] is not None]

    def eval_tables(rv):
        """(C, F) over the whole option grid at cluster rates ``rv``."""
        norm = rv[:, None] / div[None, :]
        tab = profile.interpolate_many(norm, sizes_o[None, :])
        floor = _floor_arr(rmin, norm)
        C = np.zeros((T, O))
        F = np.zeros((T, O))
        if not (plans_mode or fleets_mode):
            # homogeneous replica counts: fully columnar
            op = tab.energy_per_req_kwh * cis
            emb_cache = _cache_emb_arr(carbon, sizes_o[None, :],
                                       tab.duration_per_req_s) \
                / div[None, :]
            lt = carbon.hw.lifetime_years * SECONDS_PER_YEAR
            emb_comp = (tab.duration_per_req_s / lt) \
                * carbon.hw.embodied_compute_kg * 1000.0
            C = (op + emb_cache + emb_comp) * floor
            F = _sat_arr(rs_max, norm, tab.slo_frac)
        else:
            for k, idxs in groups.items():
                cols = np.array(idxs)
                nm = norm[:, cols]
                dur = tab.duration_per_req_s[:, cols]
                if is_disagg[cols[0]]:
                    p = k
                    cp = p.prefill.capacity
                    cd = p.decode.capacity
                    slo_t = _sat_arr(rs_max, nm,
                                     tab.slo_ttft_frac[:, cols])
                    if model is not None:
                        apt = tab.avg_prompt_tokens[:, cols]
                        xfer = apt * model.kv_bytes_per_token \
                            / (model.kv_transfer_gbps * 1e9)
                        budget = slo.ttft_s if slo is not None else 2.5
                        fac = np.maximum(0.0, 1.0 - xfer / budget)
                        slo_t = np.where(apt > 0, slo_t * fac, slo_t)
                    rate_d = rv / (cd * DISAGG_DECODE_SPEEDUP)
                    dec = profile.interpolate_many(
                        rate_d[:, None], sizes_o[None, cols])
                    slo_p = _sat_arr(rs_max, rate_d[:, None],
                                     dec.slo_tpot_frac)
                    if model is not None and slo is not None:
                        aot = tab.avg_out_tokens[:, cols]
                        memo: Dict[Tuple[float, float], float] = {}
                        for ti, ji in np.argwhere(aot > 0):
                            key = (float(rv[ti]), float(aot[ti, ji]))
                            v = memo.get(key)
                            if v is None:
                                v = _disagg_decode_slo(
                                    model, slo, key[0], p.decode.fleet,
                                    key[1])
                                memo[key] = v
                            slo_p[ti, ji] = v
                    F[:, cols] = slo_t * slo_p
                    util_p = _util_arr(tab.avg_power_w[:, cols], carbon)
                    wp = _fleet_power_arr(p.prefill.fleet, util_p)
                    op = tab.energy_per_req_kwh[:, cols] * cis * wp \
                        / (cp * _ref_watts_arr(carbon, util_p)) \
                        * _floor_arr(rmin, nm)
                    util_d = _util_arr(dec.avg_power_w, carbon)
                    cap_frac = model.decode_pool_power_frac \
                        if model is not None else DECODE_POOL_POWER_FRAC
                    wd = cap_frac * _fleet_power_arr(p.decode.fleet,
                                                     util_d)
                    op = op + dec.energy_per_req_kwh * cis * wd \
                        / (cd * DISAGG_DECODE_SPEEDUP
                           * _ref_watts_arr(carbon, util_d)) \
                        * _floor_arr(rmin, rate_d[:, None])
                    inv_rate = (1.0 / np.maximum(rv, 1e-3))[:, None]
                    emb_cache = _cache_emb_arr(carbon,
                                               sizes_o[None, cols],
                                               inv_rate)
                    emb_comp = _fleet_embodied_arr(p.all_types, inv_rate)
                    C[:, cols] = op + emb_cache + emb_comp
                    continue
                if plans_mode or fleets_mode:
                    fl = k.serve.fleet if isinstance(k, ResourcePlan) \
                        else k
                    cap = fleet_capacity(fl)
                    if not type_profiles:
                        slo_g = _sat_arr(rs_max, nm,
                                         tab.slo_frac[:, cols])
                        util = _util_arr(tab.avg_power_w[:, cols],
                                         carbon)
                        ref_w = _ref_watts_arr(carbon, util)
                        fleet_w = _fleet_power_arr(fl, util)
                        op = tab.energy_per_req_kwh[:, cols] * cis \
                            * fleet_w / (cap * ref_w)
                    else:
                        op = 0.0
                        slo_g = 0.0
                        for tname, count in Counter(fl).items():
                            rt = get_replica_type(tname)
                            share = count * rt.perf_scale / cap
                            prr = rv * rt.perf_scale / cap
                            tp = type_profiles.get(tname)
                            if tp is not None:
                                ct = tp.interpolate_many(
                                    prr[:, None], sizes_o[None, cols])
                                op_t = ct.energy_per_req_kwh * cis
                                slo_t = _sat_arr(max(tp.rates),
                                                 prr[:, None],
                                                 ct.slo_frac)
                            else:
                                util = _util_arr(
                                    tab.avg_power_w[:, cols], carbon)
                                op_t = tab.energy_per_req_kwh[:, cols] \
                                    * cis * _type_power_arr(rt, util) \
                                    / (rt.perf_scale
                                       * _ref_watts_arr(carbon, util))
                                slo_t = _sat_arr(rs_max, nm,
                                                 tab.slo_frac[:, cols])
                            op = op + share * op_t
                            slo_g = slo_g + share * slo_t
                    emb_cache = _cache_emb_arr(carbon,
                                               sizes_o[None, cols],
                                               dur) / cap
                    emb_comp = _fleet_embodied_arr(fl, dur) / cap
                    C[:, cols] = (op + emb_cache + emb_comp) \
                        * floor[:, cols]
                    F[:, cols] = slo_g
        if st_cols:
            sc = np.array(st_cols)
            nm = norm[:, sc]
            dur = tab.duration_per_req_s[:, sc]
            size = sizes_o[sc]
            idle_w = np.array([specs[i].idle_w for i in st_cols])
            dw = idle_w - size * carbon.hw.ssd_power_w_per_tb
            Cs = C[:, sc] + cis * dw[None, :] * dur / 3.6e6 \
                / div[None, sc]
            rates_w = rv[:, None] * tab.write_bytes_per_req[:, sc] \
                if wear_aware else None
            emb_flat = _cache_emb_arr(carbon, size[None, :], dur)
            emb_spec = np.zeros_like(dur)
            for ji, i in enumerate(st_cols):
                spec = specs[i]
                tot = np.zeros(T)
                rw = rates_w[:, ji] if rates_w is not None else None
                for tier in spec.tiers:
                    cal = tier.dev.lifetime_years * SECONDS_PER_YEAR
                    lt_t = np.full(T, cal)
                    if rw is not None:
                        tbw = tier.dev.tbw_bytes(tier.capacity_tb)
                        if tbw is not None and tbw > 0.0:
                            with np.errstate(divide="ignore"):
                                wear = tbw / (rw * tier.dev.write_amp)
                            lt_t = np.where((rw > 0.0) & (wear < cal),
                                            wear, cal)
                    tot = tot + tier.capacity_tb * (dur[:, ji] / lt_t) \
                        * tier.dev.embodied_kg_per_tb * 1000.0
                emb_spec[:, ji] = tot
            Cs = Cs + (emb_spec - emb_flat) / div[None, sc]
            C[:, sc] = Cs
            if model is not None:
                hr = tab.hit_rate[:, sc]
                hot_share = np.zeros_like(hr)
                tiered = np.array([specs[i].is_tiered for i in st_cols])
                if tiered.any():
                    hot_caps = np.array(
                        [specs[i].hot.capacity_tb for i in st_cols
                         if specs[i].is_tiered])
                    hot_tab = profile.interpolate_many(
                        nm[:, tiered], hot_caps[None, :])
                    hot_share[:, tiered] = np.minimum(
                        hot_tab.hit_rate
                        / np.maximum(hr[:, tiered], 1e-9), 1.0)
                apt = tab.avg_prompt_tokens[:, sc]
                hit_bytes = hr * apt * model.kv_bytes_per_token
                compute_s = model.prefill_base_s \
                    + (1.0 - hr) * apt / model.prefill_tok_per_s
                inv_ref = 1.0 / (model.ssd_read_gbps * 1e9)
                hot_g = np.array([specs[i].hot.dev.read_gbps * 1e9
                                  for i in st_cols])
                cold_g = np.array([specs[i].cold.dev.read_gbps * 1e9
                                   for i in st_cols])
                inv_spec = hot_share / hot_g[None, :] \
                    + (1.0 - hot_share) / cold_g[None, :]
                load_ref = hit_bytes * inv_ref
                load_spec = hit_bytes * inv_spec
                q = (compute_s + load_spec) \
                    / np.maximum(compute_s + load_ref, 1e-9)
                adj = (hr > 0.0) & (q != 1.0)
                if adj.any():
                    cq = profile.interpolate_many(nm * q,
                                                  size[None, :])
                    fq = _sat_arr(rs_max, nm * q, cq.slo_frac)
                    f0 = _sat_arr(rs_max, nm, tab.slo_frac[:, sc])
                    Fs = F[:, sc]
                    with np.errstate(divide="ignore",
                                     invalid="ignore"):
                        f1 = np.minimum(1.0, Fs * fq / f0)
                    new = np.where(f0 > 0.0, f1,
                                   np.where(fq > 0.0,
                                            np.minimum(1.0, fq), Fs))
                    F[:, sc] = np.where(adj, new, Fs)
        return C, F

    if shares is None:
        return eval_tables(rates_T)
    C_full, F_full = eval_tables(rates_T)
    order = sorted(shares, key=lambda t: TIERS[t].priority)
    cum = 0.0
    den = 0.0
    num = np.zeros((T, O))
    for tname in order:
        w = shares[tname]
        cum += w
        if not TIERS[tname].protected or w <= 0.0:
            continue
        num = num + w * eval_tables(rates_T * cum)[1]
        den += w
    if den == 0.0:
        return C_full, F_full
    return C_full, num / den


def _build_option_tables_scalar(profile: Profile, options, pred_rates,
                                pred_cis, slo: Optional[SLO],
                                carbon: CarbonModel, model, type_profiles,
                                wear_aware: bool, shares,
                                plans_mode: bool, fleets_mode: bool):
    """The original per-(hour, option) scalar closures — kept verbatim as
    the reference implementation (``vectorize=False``) and the baseline
    the scaling benchmark measures speedups against."""
    T = len(pred_rates)
    C = np.zeros((T, len(options)))
    F = np.zeros((T, len(options)))
    for t in range(T):
        for oi, (s, k) in enumerate(options):
            spec = s if isinstance(s, StorageSpec) else None
            # queueing/hit behaviour follows the *usable* capacity (the
            # cold tier of an inclusive spec); pricing uses the full spec
            size = spec.usable_tb if spec is not None else s

            def cell(rate, s=s, k=k, spec=spec, size=size, t=t):
                """(carbon/request, slo_frac) for this option at an
                arbitrary cluster rate — evaluated once at the forecast
                rate for the single-tier solve, and at thinned rates per
                protected tier for ``tier_shares``."""
                if plans_mode and isinstance(k, ResourcePlan) \
                        and k.is_disaggregated:
                    if spec is not None:
                        raise ValueError("the storage search does not "
                                         "support disaggregated "
                                         "candidates yet")
                    return _disagg_cell_metrics(
                        profile, rate, size, k, pred_cis[t], carbon,
                        slo=slo, model=model)
                if plans_mode or fleets_mode:
                    fl = k.serve.fleet if isinstance(k, ResourcePlan) \
                        else k
                    c, f = _fleet_cell_metrics(
                        profile, rate, size, fl, pred_cis[t], carbon,
                        type_profiles=type_profiles)
                    divisor = fleet_capacity(fl)
                else:
                    c, f = _cluster_cell_metrics(
                        profile, rate, size, k, pred_cis[t], carbon)
                    divisor = float(k)
                if spec is not None:
                    cellp = profile.interpolate(rate / divisor, size)
                    c, f = _storage_cell_adjust(
                        profile, rate / divisor, spec, pred_cis[t],
                        carbon, cellp, c, f, divisor, rate,
                        model, wear_aware)
                return c, f

            if shares is None:
                C[t, oi], F[t, oi] = cell(pred_rates[t])
            else:
                C[t, oi] = cell(pred_rates[t])[0]
                F[t, oi] = _tier_protected_slo(cell, pred_rates[t],
                                               shares)
    return C, F


def solve_cluster_schedule(profile: Profile, pred_rates: Sequence[float],
                           pred_cis: Sequence[float], slo: SLO,
                           carbon: CarbonModel, *,
                           sizes_tb: Optional[Sequence[float]] = None,
                           replicas: Sequence[int] = (1,),
                           fleets: Optional[Sequence[Sequence[str]]] = None,
                           plans: Optional[Sequence[ResourcePlan]] = None,
                           prefill_fleets: Optional[
                               Sequence[Sequence[str]]] = None,
                           decode_fleets: Optional[
                               Sequence[Sequence[str]]] = None,
                           type_profiles: Optional[Dict[str,
                                                        Profile]] = None,
                           model=None,
                           rho: Optional[float] = None,
                           transitions: Optional[TransitionConfig] = None,
                           min_dwell_hours: int = 1,
                           dwell_offset: int = 0,
                           initial_plan: Optional[ResourcePlan] = None,
                           storage: Optional[Sequence[
                               Union[StorageSpec, str]]] = None,
                           wear_aware: bool = True,
                           tier_shares: Optional[Dict[str, float]] = None,
                           vectorize: bool = True,
                           prune: bool = True,
                           beam_width: Optional[int] = None,
                           solver_cache: Optional["PlannerCache"] = None
                           ) -> SolveResult:
    """Joint hourly plan over (cache size, resource plan): the option set
    is the cross product sizes × plan candidates and the same
    multiple-choice knapsack machinery picks one option per hour (paper
    §5.4 extended with the EcoServe-style provisioning axis). Every mode
    populates ``SolveResult.plans`` — one sized ``ResourcePlan`` per hour,
    the object the controller applies.

    Candidate sources (first match wins):

    * ``plans`` — explicit ``ResourcePlan`` candidates (single-pool or
      disaggregated; an open ``cache_tb=None`` is solver-sized over the
      grid, a concrete value pins that candidate's allocation).
    * ``prefill_fleets`` + ``decode_fleets`` — the disaggregation search:
      the cross product (cache, prefill fleet, decode fleet), each side
      typically from ``enumerate_fleets``.
    * ``fleets`` — heterogeneous single-pool mixes (pre-plan spelling).
    * ``replicas`` — homogeneous reference-platform counts.

    ``type_profiles`` feeds measured per-generation profiles into the
    single-pool fleet metrics (see ``_fleet_cell_metrics``); ``model``
    (a ``ServingModel``) enables the analytic decode-pool attainment for
    disaggregated candidates (see ``_disagg_decode_slo``).

    ``transitions`` (a ``TransitionConfig``) makes the solve
    *transition-aware*: consecutive hours pay the switching carbon of the
    plan diff (boot + drain energy, partitioned-ring migration I/O), so
    the schedule exhibits hysteresis instead of flapping between
    near-tied options; ``min_dwell_hours`` additionally pins the plan
    *shape* between block-aligned hours (``dwell_offset`` aligns the
    blocks to absolute hours when re-solving mid-day), and
    ``initial_plan`` prices the first hour's switch away from the live
    configuration.  Transition mode solves with the transition-aware DP
    (``_solve_dp_transition``); a zero-cost
    config falls back to the plain solve and bit-reproduces its
    schedules.  ``SolveResult.transition_g`` reports the per-hour
    switching carbon.

    ``storage`` makes the size axis a *typed* search: a list of sized
    ``StorageSpec`` candidates (or spec strings; see
    ``repro_torch.core.storage.enumerate_storage_specs``) replaces the flat
    ``sizes_tb`` grid — every (candidate, spec) pair is an option, cell
    predictions are adjusted for the spec's device power, per-tier
    embodied rates and hot-tier KV-load credit
    (``_storage_cell_adjust``), and the hourly plans carry the chosen
    sized tiers.  ``wear_aware`` engages the endurance clock in those
    predictions (``False`` = calendar lifetimes, the baseline the
    wear-aware schedule is compared against); with the default flat
    spec and ``wear_aware=False`` the solve bit-reproduces the untyped
    path.  Candidates already carrying a ``plan.storage`` pin it.
    Disaggregated candidates do not support the storage search yet.

    ``tier_shares`` (``{tier: traffic share}``, tiers from
    ``repro_torch.workloads.tenants.TIERS``) makes the SLO constraint
    *tier-aware*: each option's attainment becomes the share-weighted
    attainment of the **protected** tiers only, each evaluated under
    priority rate-thinning (see ``_tier_protected_slo``) — gold is
    predicted at the rate of gold traffic alone, scavengers drop out of
    the rho constraint entirely.  Carbon still prices the full stream.
    ``tier_shares=None`` (default) is the single-tier solve, bit-exact."""
    t_start = time.time()
    rho = rho if rho is not None else slo.rho
    sizes = list(sizes_tb) if sizes_tb is not None else list(profile.sizes)
    specs = None
    if storage is not None:
        specs = [StorageSpec.parse(s) if isinstance(s, str) else s
                 for s in storage]
        if not specs:
            raise ValueError("storage= needs at least one StorageSpec")
    if plans is None and prefill_fleets is not None:
        from repro_torch.core.plan import enumerate_plans
        plans = enumerate_plans(prefill_fleets, decode_fleets or [("l40",)])
    if plans is not None:
        cands = list(plans) or [ResourcePlan.single(None, n_replicas=1)]
        if specs is not None:
            # a candidate carrying its own tiers pins them; open
            # candidates search the spec set.  A bare cache_tb pin is
            # ambiguous here (which device?) — refuse rather than
            # silently overriding the user's size with the spec grid
            for p in cands:
                if p.cache_tb is not None and p.storage is None:
                    raise ValueError(
                        f"candidate plan pins cache={p.cache_tb:g}tb "
                        "without tiers; under a storage search pin a "
                        "spec instead (e.g. cache=nvme_gen4:"
                        f"{p.cache_tb:g}tb) or leave the cache open")
            options = [(sp, p) for p in cands
                       for sp in ([p.storage] if p.storage is not None
                                  else specs)]
        else:
            # a candidate carrying a concrete cache_tb pins its
            # allocation; open candidates (cache_tb=None) search the grid
            options = [(s, p) for p in cands
                       for s in ([p.cache_tb] if p.cache_tb is not None
                                 else sizes)]
    elif fleets is not None:
        mixes = [tuple(f) for f in fleets] or [("l40",)]
        options = [(s, f) for f in mixes
                   for s in (specs if specs is not None else sizes)]
    else:
        reps = sorted(set(int(k) for k in replicas)) or [1]
        options = [(s, k) for k in reps
                   for s in (specs if specs is not None else sizes)]
    T = len(pred_rates)
    n = np.array([max(r, 1e-3) * 3600.0 for r in pred_rates])

    shares = normalize_shares(tier_shares) if tier_shares is not None \
        else None
    builder = _build_option_tables if vectorize \
        else _build_option_tables_scalar
    C, F = builder(profile, options, pred_rates, pred_cis, slo, carbon,
                   model, type_profiles, wear_aware, shares,
                   plans is not None, fleets is not None)

    res = None
    class_keys = None
    if transitions is not None:
        opt_plans = [_option_plan(o, sized=True) for o in options]
        if solver_cache is not None:
            E, S = solver_cache.transition_matrices(opt_plans,
                                                    transitions,
                                                    model=model)
        else:
            E, S = _transition_matrices(opt_plans, transitions,
                                        model=model)
        e_init = lock0 = None
        if initial_plan is not None:
            init_key = _fleet_key(initial_plan)
            fleet_diff0 = np.array([_fleet_key(p) != init_key
                                    for p in opt_plans])
            e_init = np.array([_pair_switch_kwh(initial_plan, p,
                                                transitions, model=model)
                               if d else 0.0
                               for p, d in zip(opt_plans, fleet_diff0)])
            if min_dwell_hours > 1 and dwell_offset % min_dwell_hours:
                lock0 = fleet_diff0       # mid-block re-solve: hold shape
        if E.any() or min_dwell_hours > 1 \
                or (e_init is not None and e_init.any()):
            # switch-cost classes for the dominance prune: two options
            # with the same structural fleet key (and, when partitioned
            # ring migration is in play, the same cache size) have
            # identical E/S rows *and* columns, so pruning within a
            # class never changes any path's switching cost
            mig = transitions.rebalance == "migrate" \
                and not transitions.is_free \
                and any(p.prefill.partitioned for p in opt_plans)
            class_keys = [
                (_fleet_key(p), p.cache_tb if mig else None,
                 None if e_init is None else float(e_init[i]),
                 None if lock0 is None else bool(lock0[i]))
                for i, p in enumerate(opt_plans)]
            res = _solve_dp_transition(C, F, n, options, rho, t_start,
                                       E, S, e_init, pred_cis,
                                       min_dwell_hours, dwell_offset,
                                       lock0=lock0, prune=prune,
                                       beam_width=beam_width,
                                       class_keys=class_keys)
        # else: every switch is free — the plain solve is identical (and
        # bit-reproduces the pre-transition schedules)
    if res is None:
        res = _solve_dp(C, F, n, options, rho, t_start,
                        prune=prune, beam_width=beam_width)
    chosen = list(res.sizes_tb)       # option tuples, split into the plan
    hourly = [_option_plan(o, sized=True) for o in chosen]
    tg = res.transition_g
    ed = _explain_payload(options, C, F, n, rho, res, prune=prune,
                          beam_width=beam_width, class_keys=class_keys)
    szs = [s.total_tb if isinstance(s, StorageSpec) else s
           for s, _ in chosen]
    if plans is not None:
        return SolveResult(szs, res.objective_g,
                           res.feasible, time.time() - t_start, res.solver,
                           replicas=[p.n_replicas for p in hourly],
                           plans=hourly, transition_g=tg,
                           beam_bound_g=res.beam_bound_g,
                           explain_data=ed)
    if fleets is not None:
        return SolveResult(szs, res.objective_g,
                           res.feasible, time.time() - t_start, res.solver,
                           replicas=[len(f) for _, f in chosen],
                           fleets=[f for _, f in chosen], plans=hourly,
                           transition_g=tg, beam_bound_g=res.beam_bound_g,
                           explain_data=ed)
    return SolveResult(szs, res.objective_g,
                       res.feasible, time.time() - t_start, res.solver,
                       replicas=[k for _, k in chosen], plans=hourly,
                       transition_g=tg, beam_bound_g=res.beam_bound_g,
                       explain_data=ed)


def _best_effort(Ft, Ct) -> int:
    """Infeasible fallback: maximize SLO; among near-ties (<2 %), min carbon."""
    fmax = float(np.max(Ft))
    cand = [s for s in range(len(Ft)) if Ft[s] >= fmax - 0.02]
    return min(cand, key=lambda s: Ct[s])


def _solve_dp_reference(C, F, n, sizes, rho, t_start, buckets: int = 400
                        ) -> SolveResult:
    """Original triple-loop DP — kept as the oracle the vectorized
    ``_solve_dp`` is regression-tested (and benchmarked) against.
    O(T·S·buckets) in Python."""
    T, S = C.shape
    total = float(n.sum())
    target = rho * total
    # satisfied counts scaled to bucket units
    scale = buckets / max(total, 1e-9)
    NEG = -1
    INF = float("inf")
    dp = np.full(buckets + 1, INF)
    dp[0] = 0.0
    back = np.full((T, buckets + 1), NEG, dtype=int)
    for t in range(T):
        ndp = np.full(buckets + 1, INF)
        for b in range(buckets + 1):
            if dp[b] == INF:
                continue
            for s in range(S):
                add = n[t] * F[t, s] * scale
                nb = min(int(b + add), buckets)
                cost = dp[b] + n[t] * C[t, s]
                if cost < ndp[nb]:
                    ndp[nb] = cost
                    back[t, nb] = b * S + s
        dp = ndp
    tb = int(np.floor(target * scale))
    best_b, best_cost = -1, INF
    for b in range(tb, buckets + 1):
        if dp[b] < best_cost:
            best_b, best_cost = b, dp[b]
    feasible = best_b >= 0
    if not feasible:
        choice = [_best_effort(F[t], C[t]) for t in range(T)]
        obj = float(sum(n[t] * C[t][c] for t, c in enumerate(choice)))
        return SolveResult([sizes[c] for c in choice], obj, False,
                           time.time() - t_start, "dp")
    # backtrack
    choice = [0] * T
    b = best_b
    for t in range(T - 1, -1, -1):
        enc = back[t, b]
        choice[t] = enc % S
        b = enc // S
    obj = float(sum(n[t] * C[t][c] for t, c in enumerate(choice)))
    return SolveResult([sizes[c] for c in choice], obj, True,
                       time.time() - t_start, "dp")


def _solve_dp(C, F, n, sizes, rho, t_start, buckets: int = 400,
              prune: bool = False, beam_width=None) -> SolveResult:
    """Exact-to-discretization DP: state = hours processed × satisfied-count
    bucket; value = min carbon.

    Vectorized engine, bit-identical to ``_solve_dp_reference`` (tested):
    the per-hour (bucket × option) relaxation becomes one gathered-matrix
    ``argmin`` — each option column advances buckets by a constant shift
    ``k = int(b + n·F·scale) - b`` (verified cell-exact per column on the
    identical float expression; a rounding-broken column drops the hour
    back to the reference loop), columns are ordered (k desc, index asc)
    so the row-wise first-minimum reproduces the reference's
    (bucket-major, option-minor) strict-< tie-break, and the clipped top
    bucket takes a flat argmin over the masked cost matrix in the same
    order.  ``prune``/``beam_width`` apply the per-hour dominance filter
    and beam of ``_hour_keeps`` (no switching costs here, so dominance
    needs no class structure)."""
    T, S = C.shape
    total = float(n.sum())
    target = rho * total
    # satisfied counts scaled to bucket units
    scale = buckets / max(total, 1e-9)
    B = buckets
    NEG = -1
    INF = float("inf")
    keeps, bound_total = _hour_keeps(C, F, n, None, prune, beam_width)
    dp = np.full(B + 1, INF)
    dp[0] = 0.0
    back = np.full((T, B + 1), NEG, dtype=np.int64)
    bgrid = np.arange(B + 1)
    for t in range(T):
        kt = keeps[t]
        nCt = n[t] * C[t]
        raw = (bgrid[:, None] + (n[t] * F[t] * scale)[kt][None, :]) \
            .astype(int)
        D = raw - bgrid[:, None]
        const = (D == D[0]).all(axis=0)
        if not const.all():
            # float rounding broke a column's constant shift: run the
            # reference inner loop (restricted to the kept set) exactly
            ndp = np.full(B + 1, INF)
            for b in range(B + 1):
                if dp[b] == INF:
                    continue
                for j, s in enumerate(kt):
                    nb = min(raw[b, j], B)
                    cost = dp[b] + nCt[s]
                    if cost < ndp[nb]:
                        ndp[nb] = cost
                        back[t, nb] = b * S + s
            dp = ndp
            continue
        ks = D[0]
        order = np.lexsort((kt, -ks))       # k desc, then option asc:
        k_s = ks[order]                     # == (bucket asc, option asc)
        s_g = kt[order]
        nC_s = nCt[s_g]
        bmat = np.arange(B)[:, None] - k_s[None, :]
        cand = np.where(bmat >= 0,
                        dp[np.clip(bmat, 0, B)] + nC_s[None, :], INF)
        am = cand.argmin(axis=1)
        v = cand[np.arange(B), am]
        ndp = np.full(B + 1, INF)
        ndp[:B] = v
        fin = np.isfinite(v)
        enc = (np.arange(B) - k_s[am]) * S + s_g[am]
        back[t, :B][fin] = enc[fin]
        # clipped top bucket: flat argmin over (bucket, option) C-order
        costm = np.where(raw >= B, dp[:, None] + nCt[kt][None, :], INF)
        flat = int(np.argmin(costm))
        bB, jB = divmod(flat, len(kt))
        if np.isfinite(costm[bB, jB]):
            ndp[B] = costm[bB, jB]
            back[t, B] = bB * S + int(kt[jB])
        dp = ndp
    tb = int(np.floor(target * scale))
    best_b, best_cost = -1, INF
    for b in range(tb, B + 1):
        if dp[b] < best_cost:
            best_b, best_cost = b, dp[b]
    feasible = best_b >= 0
    if not feasible:
        choice = [_best_effort(F[t], C[t]) for t in range(T)]
        obj = float(sum(n[t] * C[t][c] for t, c in enumerate(choice)))
        return SolveResult([sizes[c] for c in choice], obj, False,
                           time.time() - t_start, "dp",
                           beam_bound_g=bound_total)
    # backtrack
    choice = [0] * T
    b = best_b
    for t in range(T - 1, -1, -1):
        enc = back[t, b]
        choice[t] = int(enc % S)
        b = int(enc // S)
    obj = float(sum(n[t] * C[t][c] for t, c in enumerate(choice)))
    return SolveResult([sizes[c] for c in choice], obj, True,
                       time.time() - t_start, "dp",
                       beam_bound_g=bound_total)

# ---------------------------------------------------------------------------
# Geo-distributed joint solve: global traffic split × per-region plan
# ---------------------------------------------------------------------------

@dataclass
class GeoSolveResult:
    """Joint schedule over (traffic split, per-region plan).

    ``splits[t]`` is the fraction of the global stream each region serves
    at hour ``t``; ``per_region[r]`` is the ordinary ``SolveResult`` for
    region ``r`` solved at its *split-thinned* rates, so
    ``per_region[r].plans[t]`` is what region ``r`` applies at hour
    ``t``.  ``transition_g`` is the predicted cross-region KV-migration
    carbon charged when the split shifts between consecutive hours."""
    splits: List[Tuple[float, ...]]
    per_region: List[SolveResult]
    objective_g: float
    feasible: bool
    solve_time_s: float
    solver: str = "geo-dp"
    transition_g: Optional[List[float]] = None


def _simplex_splits(n_regions: int, quantum: float,
                    eligible: Optional[Sequence[bool]] = None
                    ) -> List[Tuple[float, ...]]:
    """Candidate weight vectors on the ``quantum``-granular simplex over
    ``n_regions`` (one-hots always included).  ``eligible`` zeroes out
    regions that no population may use — ineligible regions get weight 0
    in every candidate."""
    steps = max(1, int(round(1.0 / quantum)))
    elig = [True] * n_regions if eligible is None else list(eligible)
    if not any(elig):
        elig = [True] * n_regions
    splits: set = set()
    idx = [r for r in range(n_regions) if elig[r]]

    def rec(pos: int, left: int, acc: List[int]):
        if pos == len(idx) - 1:
            full = [0] * n_regions
            for i, r in enumerate(idx[:-1]):
                full[r] = acc[i]
            full[idx[-1]] = left
            splits.add(tuple(k / steps for k in full))
            return
        for k in range(left + 1):
            rec(pos + 1, left - k, acc + [k])

    rec(0, steps, [])
    for r in idx:                         # one-hots, even off-grid quanta
        oh = [0.0] * n_regions
        oh[r] = 1.0
        splits.add(tuple(oh))
    return sorted(splits, reverse=True)


def _region_best_cell(profile: Profile, rate: float, sizes, cands,
                      ci: float, carbon: CarbonModel, slo: SLO, model,
                      rho: float) -> Tuple[float, float]:
    """Cheapest-feasible (carbon/request, slo_frac) over one region's
    option set (plans × sizes) at one rate/CI — the inner per-hour pick
    the split DP scores each candidate split with.  Falls back to the
    max-attainment option when nothing meets ``rho``."""
    best_feas = best_any = None
    for p in cands:
        szs = [p.cache_tb] if p.cache_tb is not None else sizes
        for s in szs:
            if p.is_disaggregated:
                c, f = _disagg_cell_metrics(profile, rate, s, p, ci,
                                            carbon, slo=slo, model=model)
            else:
                c, f = _fleet_cell_metrics(profile, rate, s,
                                           p.serve.fleet, ci, carbon)
            if f >= rho and (best_feas is None or c < best_feas[0]):
                best_feas = (c, f)
            if best_any is None or (f, -c) > (best_any[1], -best_any[0]):
                best_any = (c, f)
    return best_feas if best_feas is not None else best_any


def _region_cell_tables(profile: Profile, pred_rates, region_cis, sizes,
                        cands, weights, slo: SLO, carbon: CarbonModel,
                        model, rho: float):
    """Batched ``_region_best_cell`` over every (hour, split weight) a
    region can see: one columnar table build per region instead of
    T·|weights|·|options| scalar interpolations.  Returns
    ``{(t, w): (carbon, slo_frac)}`` — bit-identical to the scalar
    per-cell picks (same option order, same first-wins tie-breaks)."""
    T = len(pred_rates)
    ws = sorted(weights)
    if not ws:
        return {}
    options = [(s, p) for p in cands
               for s in ([p.cache_tb] if p.cache_tb is not None
                         else sizes)]
    # flatten the (hour, weight) grid into the builder's "hours" axis
    flat_rates = [pred_rates[t] * w for t in range(T) for w in ws]
    flat_cis = [region_cis[t] for t in range(T) for _ in ws]
    C, F = _build_option_tables(profile, options, flat_rates, flat_cis,
                                slo, carbon, model, None, True, None,
                                True, False)
    feas = F >= rho
    cfeas = np.where(feas, C, np.inf)
    jf = np.argmin(cfeas, axis=1)          # first min = first-wins tie
    has_f = feas.any(axis=1)
    fmax = F.max(axis=1)
    cany = np.where(F == fmax[:, None], C, np.inf)
    ja = np.argmin(cany, axis=1)           # lexicographic (f, -c) max
    rows = np.arange(len(flat_rates))
    j = np.where(has_f, jf, ja)
    cf = (C[rows, j], F[rows, j])
    return {(t, w): (float(cf[0][t * len(ws) + wi]),
                     float(cf[1][t * len(ws) + wi]))
            for t in range(T) for wi, w in enumerate(ws)}


def _pareto_prune_splits(splits, C, F):
    """Drop candidate splits dominated at *every* hour (≥ carbon and
    ≤ attainment, strict somewhere) — keeps the DP over splits tractable
    as the region count grows without changing its optimum."""
    S = len(splits)
    keep = np.ones(S, dtype=bool)
    for i in range(S):
        if not keep[i]:
            continue
        dom = np.all(C[:, i:i + 1] <= C, axis=0) \
            & np.all(F[:, i:i + 1] >= F, axis=0) \
            & (np.any(C[:, i:i + 1] < C, axis=0)
               | np.any(F[:, i:i + 1] > F, axis=0))
        dom[i] = False
        keep &= ~dom
    return [s for s, k in zip(splits, keep) if k], C[:, keep], F[:, keep]


def solve_geo_schedule(profile: Profile, pred_rates: Sequence[float],
                       region_cis: Sequence[Sequence[float]], slo: SLO,
                       carbon: CarbonModel, *,
                       region_plans: Sequence[Sequence[ResourcePlan]],
                       sizes_tb: Optional[Sequence[float]] = None,
                       eligible: Optional[Sequence[bool]] = None,
                       quantum: float = 0.25,
                       rho: Optional[float] = None,
                       model=None,
                       migrate_gb_per_shift: float = 1.0,
                       inter_region_gbps: float = 5.0,
                       min_dwell_hours: int = 1,
                       dwell_offset: int = 0,
                       prune: bool = True,
                       beam_width: Optional[int] = None,
                       solver_cache: Optional["PlannerCache"] = None
                       ) -> GeoSolveResult:
    """Joint hourly solve over (global traffic split, per-region plan).

    Stage 1 runs a DP over candidate splits from the ``quantum``-granular
    simplex (Pareto-pruned): each (hour, split) is scored by the
    weight-averaged cheapest-feasible option of every loaded region at
    its thinned rate and its *effective* CI (``region_cis[r][t]``, PUE/
    grid factors folded in by the caller), and consecutive differing
    splits pay cross-region KV-migration carbon
    (``migrate_gb_per_shift`` GB per unit of total weight moved, priced
    through ``kv_migration_energy_kwh`` at the hour's mean CI).  Stage 2
    re-solves each region exactly with ``solve_cluster_schedule`` at its
    split-thinned rates, so the per-region plan schedules carry all the
    machinery of the single-site solve (transitions, dwell, storage)."""
    t_start = time.time()
    rho = rho if rho is not None else slo.rho
    R = len(region_cis)
    T = len(pred_rates)
    if len(region_plans) != R:
        raise ValueError(f"region_plans has {len(region_plans)} entries "
                         f"for {R} regions")
    sizes = list(sizes_tb) if sizes_tb is not None else list(profile.sizes)
    cands = [list(ps) or [ResourcePlan.single(None, n_replicas=1)]
             for ps in region_plans]

    splits = _simplex_splits(R, quantum, eligible)
    n = np.array([max(r, 1e-3) * 3600.0 for r in pred_rates])
    # lazy: each region's cell table only covers the distinct positive
    # weights that actually appear in a candidate split — ineligible
    # regions (weight 0 everywhere) are never evaluated at all
    weights_r = [{sp[r] for sp in splits if sp[r] > 0.0}
                 for r in range(R)]
    tbl = [_region_cell_tables(profile, pred_rates, region_cis[r], sizes,
                               cands[r], weights_r[r], slo, carbon,
                               model, rho)
           for r in range(R)]

    C = np.zeros((T, len(splits)))
    F = np.zeros((T, len(splits)))
    for t in range(T):
        for si, sp in enumerate(splits):
            c = f = 0.0
            for r, w in enumerate(sp):
                if w <= 0.0:
                    continue            # idle region: no load, no term
                cr, fr = tbl[r][(t, w)]
                c += w * cr
                f += w * fr
            C[t, si], F[t, si] = c, f

    splits, C, F = _pareto_prune_splits(splits, C, F)
    n_sp = len(splits)
    mean_cis = np.asarray(region_cis, dtype=float).mean(axis=0)

    # cross-region KV-migration energy for a split shift: half the L1
    # distance is the total weight that changes hands
    A = np.array(splits, dtype=float)
    moved = 0.5 * np.abs(A[:, None, :] - A[None, :, :]).sum(axis=2)
    Sm = moved > 0.0
    E = np.where(Sm, kv_migration_energy_kwh(
        moved * migrate_gb_per_shift * 1e9, inter_region_gbps), 0.0)

    if E.any() or min_dwell_hours > 1:
        res = _solve_dp_transition(C, F, n, splits, rho, t_start, E, Sm,
                                   None, mean_cis, min_dwell_hours,
                                   dwell_offset)
    else:
        res = _solve_dp(C, F, n, splits, rho, t_start)
    chosen: List[Tuple[float, ...]] = list(res.sizes_tb)
    tg = res.transition_g if res.transition_g is not None \
        else [0.0] * T

    per_region: List[SolveResult] = []
    feasible = res.feasible
    objective = float(sum(tg))
    for r in range(R):
        rates_r = [pred_rates[t] * chosen[t][r] for t in range(T)]
        sub = solve_cluster_schedule(
            profile, rates_r, list(region_cis[r]), slo, carbon,
            plans=cands[r], sizes_tb=sizes, rho=rho, model=model,
            min_dwell_hours=min_dwell_hours,
            dwell_offset=dwell_offset, prune=prune,
            beam_width=beam_width, solver_cache=solver_cache)
        per_region.append(sub)
        objective += sub.objective_g
        # an hour a region serves no traffic cannot violate its SLO
        loaded = any(chosen[t][r] > 0.0 for t in range(T))
        feasible = feasible and (sub.feasible or not loaded)
    return GeoSolveResult(chosen, per_region, objective, feasible,
                          time.time() - t_start, transition_g=tg)
