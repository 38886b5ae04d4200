"""Cache performance profiler (paper §5.2).

Sweeps (cache size × request rate) for an LLM task, measuring TTFT/TPOT
distributions, power, SLO attainment, and hit rate on a warmed cache (using
the LCS policy, §5.4.2), producing the profile consumed by the constraint
solver. Rates are swept up to the maximum the system sustains before SLO
violation; carbon savings are derived per-CI at solve time (operational and
embodied parts stored separately).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.carbon import CarbonModel
from repro_torch.core.kvstore import KVStore
from repro_torch.core.policies import POLICIES
from repro_torch.serving.cluster import ClusterEngine
from repro_torch.serving.perfmodel import SLO, ServingModel


@dataclass
class ProfileCell:
    rate: float
    cache_tb: float
    avg_ttft: float
    p90_ttft: float
    avg_tpot: float
    p90_tpot: float
    slo_frac: float              # fraction of requests meeting BOTH SLOs
    hit_rate: float
    energy_per_req_kwh: float    # operational energy per request
    duration_per_req_s: float    # wall seconds per request (T in Eq. 4/5)
    avg_power_w: float
    # per-metric SLO splits (default to the joint fraction for profiles
    # recorded before the split existed): the disaggregation solver binds
    # prefill pools on the TTFT side and decode pools on the TPOT side
    slo_ttft_frac: Optional[float] = None
    slo_tpot_frac: Optional[float] = None
    # mean output/prompt tokens of the measured stream: the decode-pool
    # demand and KV-handoff volume the disaggregation solver prices
    # analytically
    avg_out_tokens: float = 0.0
    avg_prompt_tokens: float = 0.0
    # host bytes written into the cache per request (inserts + growth) at
    # this operating point — the churn signal the wear-aware storage
    # solver turns into a device write rate (rate × this) and prices
    # against endurance (profiles recorded before the field default to 0:
    # no wear prediction, calendar lifetimes)
    write_bytes_per_req: float = 0.0
    # mean per-request fraction of *prompt* tokens served from cache
    # (reused / prompt).  Under a prefix-aware store this is the
    # prefix-aware hit-rate curve: partial matches contribute their
    # matched fraction instead of rounding down to 0, so the curve rises
    # smoothly with cache size where whole-context keying steps.  It is
    # exactly the mean prefill-shortening factor (TTFT and prefill energy
    # scale with 1 - matched_token_frac).  ``hit_rate`` stays the
    # context-token-weighted ledger ratio both store kinds share.
    matched_token_frac: float = 0.0

    def __post_init__(self):
        if self.slo_ttft_frac is None:
            self.slo_ttft_frac = self.slo_frac
        if self.slo_tpot_frac is None:
            self.slo_tpot_frac = self.slo_frac

    def carbon_per_req_g(self, ci: float, carbon: CarbonModel) -> float:
        op = carbon.operational_g(self.energy_per_req_kwh, ci)
        emb_c = carbon.cache_embodied_g(self.cache_tb,
                                        self.duration_per_req_s)
        emb_o = carbon.compute_embodied_g(self.duration_per_req_s)
        return op + emb_c + emb_o


_CELL_FIELDS = tuple(f.name for f in dataclasses.fields(ProfileCell))
_MIX_FIELDS = tuple(n for n in _CELL_FIELDS if n not in ("rate", "cache_tb"))


@dataclass
class CellTable:
    """Columnar batch of interpolated ``ProfileCell``s: one float64 array
    per cell field, aligned with the (broadcast) query arrays handed to
    ``Profile.interpolate_many``.  The solver's vectorized table build
    consumes these columns directly — one NumPy gather per hour instead
    of thousands of dataclass constructions."""
    rate: np.ndarray
    cache_tb: np.ndarray
    avg_ttft: np.ndarray
    p90_ttft: np.ndarray
    avg_tpot: np.ndarray
    p90_tpot: np.ndarray
    slo_frac: np.ndarray
    hit_rate: np.ndarray
    energy_per_req_kwh: np.ndarray
    duration_per_req_s: np.ndarray
    avg_power_w: np.ndarray
    slo_ttft_frac: np.ndarray
    slo_tpot_frac: np.ndarray
    avg_out_tokens: np.ndarray
    avg_prompt_tokens: np.ndarray
    write_bytes_per_req: np.ndarray
    matched_token_frac: np.ndarray

    def cell(self, i: int) -> ProfileCell:
        """Materialize entry ``i`` (flat index) as a ProfileCell — the
        scalar view the equality tests compare against."""
        kw = {name: float(np.asarray(getattr(self, name)).ravel()[i])
              for name in _CELL_FIELDS}
        return ProfileCell(**kw)


@dataclass
class Profile:
    model_name: str
    task: str
    rates: List[float]
    sizes: List[float]
    cells: Dict[Tuple[float, float], ProfileCell] = field(default_factory=dict)

    def cell(self, rate: float, cache_tb: float) -> ProfileCell:
        """Nearest-rate lookup at exact cache size."""
        r = min(self.rates, key=lambda x: abs(x - rate))
        return self.cells[(r, cache_tb)]

    def interpolate(self, rate: float, cache_tb: float) -> ProfileCell:
        """Linear interpolation between the two bracketing profiled rates;
        cache size snaps to the nearest profiled size."""
        if cache_tb not in self.sizes:
            cache_tb = min(self.sizes, key=lambda s: abs(s - cache_tb))
        rs = sorted(self.rates)
        if rate <= rs[0]:
            return self.cells[(rs[0], cache_tb)]
        if rate >= rs[-1]:
            return self.cells[(rs[-1], cache_tb)]
        import bisect
        i = bisect.bisect_left(rs, rate)
        lo, hi = rs[i - 1], rs[i]
        w = (rate - lo) / (hi - lo)
        a, b = self.cells[(lo, cache_tb)], self.cells[(hi, cache_tb)]
        mix = {f.name: (1 - w) * getattr(a, f.name) + w * getattr(b, f.name)
               for f in dataclasses.fields(ProfileCell)
               if f.name not in ("rate", "cache_tb")}
        return ProfileCell(rate=rate, cache_tb=cache_tb, **mix)

    # ---- batched interpolation (the solver's columnar hot path) ---- #
    def _columns(self):
        """Lazy (R, Z) float64 column per cell field over (sorted rates ×
        sizes in declaration order), rebuilt when the grid changes."""
        key = (len(self.cells), tuple(self.rates), tuple(self.sizes))
        cached = getattr(self, "_col_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        rs = sorted(self.rates)
        cols = {name: np.array([[getattr(self.cells[(r, s)], name)
                                 for s in self.sizes] for r in rs],
                               dtype=float)
                for name in _MIX_FIELDS}
        data = (np.asarray(rs, dtype=float),
                np.asarray(self.sizes, dtype=float), cols)
        self._col_cache = (key, data)
        return data

    def interpolate_many(self, rates, cache_tbs) -> CellTable:
        """Vectorized ``interpolate`` over arrays of (rate, cache size).

        ``rates`` and ``cache_tbs`` broadcast against each other; the
        returned ``CellTable`` columns carry the broadcast shape.  Every
        entry is bit-identical to the scalar ``interpolate`` call at the
        same point: sizes snap to the nearest profiled size (first wins
        on ties, matching ``min(key=abs)`` over the declaration order),
        rates at or beyond the profiled ends return the stored edge cell
        verbatim, and interior rates mix the two bracketing cells with
        the same ``(1-w)·a + w·b`` expression (tested)."""
        rs, sz, cols = self._columns()
        r, q = np.broadcast_arrays(np.asarray(rates, dtype=float),
                                   np.asarray(cache_tbs, dtype=float))
        shape = r.shape
        r = r.ravel()
        q = q.ravel()
        # nearest-size snap; argmin returns the first minimal index,
        # matching min(self.sizes, key=abs) tie-breaking
        j = np.argmin(np.abs(sz[None, :] - q[:, None]), axis=1)
        R = len(rs)
        lo_mask = r <= rs[0]
        hi_mask = r >= rs[-1]
        if R > 1:
            i = np.clip(np.searchsorted(rs, r, side="left"), 1, R - 1)
            ilo, ihi = i - 1, i
            with np.errstate(divide="ignore", invalid="ignore"):
                w = (r - rs[ilo]) / (rs[ihi] - rs[ilo])
        else:                    # single profiled rate: always clamped
            ilo = ihi = np.zeros(len(r), dtype=int)
            w = np.zeros(len(r))
        out = {}
        for name in _MIX_FIELDS:
            colf = cols[name]
            mixed = (1.0 - w) * colf[ilo, j] + w * colf[ihi, j]
            out[name] = np.where(lo_mask, colf[0, j],
                                 np.where(hi_mask, colf[-1, j],
                                          mixed)).reshape(shape)
        # clamped entries return the stored edge cell, whose .rate is the
        # profiled edge rate (not the query rate) — mirror that here
        rate_out = np.where(lo_mask, rs[0], np.where(hi_mask, rs[-1], r))
        return CellTable(rate=rate_out.reshape(shape),
                         cache_tb=sz[j].reshape(shape), **out)


def run_profiler(model: ServingModel, task: str, workload_factory: Callable,
                 carbon: CarbonModel, *,
                 rates: List[float], sizes_tb: List[float],
                 meas_seconds: float = 1200.0, ramp_seconds: float = 420.0,
                 warmup_prompts: int = 30000,
                 policy: str = "lcs", seed: int = 0,
                 replica_type: Optional[str] = None,
                 prefix_aware: bool = False) -> Profile:
    """Profile each (rate, size) cell on a warmed cache (paper: profiling is
    collected after warm-up with the LCS policy; distinct prompt sets for
    profiling vs evaluation — we use a distinct seed). The measurement is a
    fixed *time window* (not a fixed prompt count) so steady-state queueing
    at high rates is captured.

    ``replica_type`` profiles on a specific hardware generation: the
    serving model's compute throughput is rescaled by the type's
    ``perf_scale`` and energy is metered against the type's power specs.
    Default (None) is the reference platform — the profile the fleet
    solver's capacity-normalized interpolation expects.

    ``prefix_aware=True`` profiles on a ``RadixKVStore`` so structured
    workloads (``prefix=True`` factories) get longest-prefix partial
    hits; every cell's ``matched_token_frac`` then traces the
    prefix-aware hit-rate curve the solver sizes against.  Legacy
    workloads measure identically to the flat store (exact-key parity)."""
    from repro_torch.core.carbon import get_replica_type
    from repro_torch.workloads import sample_many
    from repro_torch.workloads.traces import make_poisson_arrivals

    if replica_type is not None:
        rt = get_replica_type(replica_type)
        model = model.scaled(rt.perf_scale)
        if rt.hw != carbon.hw:
            carbon = CarbonModel(hw=rt.hw)

    prof = Profile(model.name, task, rates=list(rates), sizes=list(sizes_tb))
    for size in sizes_tb:
        for rate in rates:
            wl = workload_factory(seed + 17)
            store_cls = KVStore
            if prefix_aware:
                from repro_torch.core.radix import RadixKVStore
                store_cls = RadixKVStore
            store = store_cls(size * 1e12, POLICIES[policy],
                              model.kv_bytes_per_token)
            # vectorized single-replica cluster: per-server cells, ~5-10x
            # faster than the seed per-request loop
            eng = ClusterEngine(model, store, carbon)
            n_warm = warmup_prompts if size > 0 else 0
            n_ramp = max(int(rate * ramp_seconds), 20)
            n_meas = max(int(rate * meas_seconds), 100)
            arr = make_poisson_arrivals(
                np.full(96, rate), seed=seed + 3,
                max_requests=n_warm + n_ramp + n_meas)
            reqs = sample_many(wl, arr)
            eng.warm(reqs[:n_warm])
            eng.run(reqs[n_warm:n_warm + n_ramp], ci_fn=lambda t: 0.0,
                    cache_tb=size, record=False)
            meas = reqs[n_warm + n_ramp:n_warm + n_ramp + n_meas]
            w0 = store.stats.written_bytes
            res = eng.run(meas, ci_fn=lambda t: 0.0, cache_tb=size)
            slo = _slo_for(model.name, task)
            dur_per_req = res.duration_s / max(res.num_requests, 1)
            cell = ProfileCell(
                rate=rate, cache_tb=size,
                avg_ttft=float(res.ttft.mean()), p90_ttft=res.p90("ttft"),
                avg_tpot=float(res.tpot.mean()), p90_tpot=res.p90("tpot"),
                slo_frac=res.slo_attainment(slo),
                slo_ttft_frac=res.slo_attainment(slo, "ttft"),
                slo_tpot_frac=res.slo_attainment(slo, "tpot"),
                avg_out_tokens=float(np.mean([r.output_tokens
                                              for r in meas])),
                avg_prompt_tokens=float(np.mean([r.prompt_tokens
                                                 for r in meas])),
                hit_rate=res.token_hit_rate,
                energy_per_req_kwh=res.energy_kwh / max(res.num_requests, 1),
                duration_per_req_s=dur_per_req,
                avg_power_w=res.energy_kwh * 3.6e6 / max(res.duration_s,
                                                         1e-9),
                write_bytes_per_req=(store.stats.written_bytes - w0)
                / max(res.num_requests, 1),
                matched_token_frac=float(np.mean(
                    [r.reused_tokens / max(r.prompt_tokens, 1)
                     for r in meas])) if meas else 0.0)
            prof.cells[(rate, size)] = cell
    return prof


def run_type_profiles(model: ServingModel, task: str,
                      workload_factory: Callable, carbon: CarbonModel,
                      types: List[str], *, rates: List[float],
                      sizes_tb: List[float], **kwargs
                      ) -> Dict[str, "Profile"]:
    """Measure one profile per hardware generation (``replica_type=``),
    keyed by type name — the mapping ``solve_cluster_schedule`` /
    ``GreenCacheController`` accept as ``type_profiles`` so the fleet
    solver interpolates measured per-generation cells instead of
    rescaling the reference profile."""
    return {t: run_profiler(model, task, workload_factory, carbon,
                            rates=rates, sizes_tb=sizes_tb,
                            replica_type=t, **kwargs)
            for t in types}


def _slo_for(model_name: str, task: str) -> SLO:
    from repro_torch.serving.perfmodel import SLOS
    key = (model_name, "chat" if task.startswith("conv") else "doc")
    return SLOS.get(key, SLO(2.5, 0.2))
