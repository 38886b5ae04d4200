"""Analytical performance & power model of the serving platform.

The paper's 4×L40 measurements cannot be re-taken here, so the engine
simulation uses a calibrated linear performance model whose constants are
pinned to the paper's reported numbers. They describe the simulated fleet
(its servers are the paper's), not the card this package runs on:

  * Llama-3 70B (INT8, 4×L40): avg ShareGPT TTFT ≈ 1.7 s (paper §2.2) at
    ~2.3k prompt tokens → ~1500 uncached tok/s prefill throughput.
  * KV-cache load from SSD ≈ 0.03 s for an average cached context
    (paper §2.2) → ~14 GB/s effective SSD read bandwidth.
  * KV bytes/token: L·kv·hd·2·2 (Llama-3 70B ≈ 320 KB/token, consistent
    with the LMCache calculator's ">300 TB per 1M 1000-token prompts").

``serving_model_for_arch`` derives the same ServingModel abstraction from
first principles for any assigned architecture on a server of four NVIDIA
H100 SXM cards (its roofline defaults: 989 TFLOP/s dense bf16 and 3,350
GB/s of HBM3 per card).

Host NumPy code, as the rest of the simulator: nothing here runs on a card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from repro_torch.configs import get_config


# decode-overload grace band (see ServingModel.overload_tpot): demand may
# exceed max_batch by this factor before the queue-growth penalty engages
OVERLOAD_GRACE = 1.8


@dataclass(frozen=True)
class SLO:
    ttft_s: float
    tpot_s: float
    rho: float = 0.9               # required attainment


@dataclass(frozen=True)
class ServingModel:
    name: str
    kv_bytes_per_token: float
    prefill_tok_per_s: float       # uncached prefill token throughput
    prefill_base_s: float          # fixed per-request overhead
    decode_base_s: float           # per decode iteration (batch of 1)
    decode_batch_slope: float      # added seconds per extra batched request
    decode_interference: float     # TPOT inflation at 100% prefill utilization
    ssd_read_gbps: float           # KV-cache load bandwidth
    max_batch: int
    max_cache_tb: float
    # prefill->decode pool interconnect (disaggregated plans): effective
    # point-to-point KV-handoff bandwidth, e.g. 2x200G IB / NVLink-network
    # class links land at ~25 GB/s per stream
    kv_transfer_gbps: float = 25.0
    # dedicated decode pools run power-capped: decode is HBM-bandwidth
    # bound, so dropping core clocks to ~60 % of TDP costs little TPOT
    # (the DynamoLLM/EcoServe energy lever); fused servers cannot cap —
    # they interleave compute-bound prefill on the same accelerators
    decode_pool_power_frac: float = 0.6
    gpu_util_prefill: float = 0.12
    gpu_util_decode: float = 0.50

    def decode_fixed_point(self, lam: float, out_mean: float,
                           dec_slow: float = 1.0,
                           interference_util: float = 0.0
                           ) -> Tuple[float, float]:
        """Continuous-batching decode equilibrium: TPOT and batch size at
        per-replica arrival rate ``lam`` (req/s) with mean output length
        ``out_mean``, fleet slowdown ``dec_slow`` (mean inverse
        perf_scale) and prefill-interference utilization (0 on a
        dedicated decode pool), followed by the overload penalty. The
        single shared implementation keeps the seed engine, both cluster
        engines and the solver's analytic decode attainment in exact
        agreement (``x * 1.0`` is exact, so degenerate factors preserve
        bit parity)."""
        tpot = self.decode_base_s
        for _ in range(8):
            batch = np.clip(lam * out_mean * tpot, 1.0, self.max_batch)
            tpot = self.decode_step_time(batch) * dec_slow \
                * (1.0 + self.decode_interference * interference_util)
        return self.overload_tpot(tpot, lam * out_mean * tpot), batch

    def overload_tpot(self, tpot: float, demand_batch: float) -> float:
        """Decode-overload penalty: once the arrival token rate wants a
        batch beyond ``OVERLOAD_GRACE x max_batch``, the decode queue
        grows without bound and effective TPOT inflates quadratically in
        the overload ratio (mirroring the solver's saturation penalty).
        The grace band absorbs the transient clipping the fixed point
        already tolerates at profiled operating points."""
        ratio = demand_batch / (OVERLOAD_GRACE * self.max_batch)
        return tpot * ratio * ratio if ratio > 1.0 else tpot

    def prefill_time(self, uncached_tokens: int, reused_tokens: int) -> float:
        load = reused_tokens * self.kv_bytes_per_token / (self.ssd_read_gbps
                                                          * 1e9)
        return self.prefill_base_s + uncached_tokens / self.prefill_tok_per_s \
            + load

    def decode_step_time(self, batch: float) -> float:
        return self.decode_base_s + self.decode_batch_slope * max(batch - 1, 0)

    def scaled(self, perf_scale: float) -> "ServingModel":
        """Rescale the platform's compute throughput by ``perf_scale``
        (e.g. a ``ReplicaType``'s scale for per-generation profiling):
        prefill speeds up, decode iterations shorten; the SSD KV-load
        bandwidth is storage-bound and stays put. ``scaled(1.0)`` returns
        ``self`` so the reference path is untouched."""
        if perf_scale == 1.0:
            return self
        import dataclasses
        return dataclasses.replace(
            self,
            prefill_tok_per_s=self.prefill_tok_per_s * perf_scale,
            prefill_base_s=self.prefill_base_s / perf_scale,
            decode_base_s=self.decode_base_s / perf_scale,
            decode_batch_slope=self.decode_batch_slope / perf_scale)


def _kv_bpt(arch: str) -> float:
    return float(get_config(arch).kv_bytes_per_token)


SERVING_MODELS = {
    "llama3-70b": ServingModel(
        name="llama3-70b", kv_bytes_per_token=_kv_bpt("llama3-70b"),  # 327 KB
        prefill_tok_per_s=6800.0, prefill_base_s=0.12,
        decode_base_s=0.038, decode_batch_slope=0.0006,
        decode_interference=0.9, ssd_read_gbps=14.0,
        max_batch=64, max_cache_tb=16.0),
    "llama3-8b": ServingModel(
        name="llama3-8b", kv_bytes_per_token=_kv_bpt("llama3-8b"),    # 131 KB
        prefill_tok_per_s=16000.0, prefill_base_s=0.04,
        decode_base_s=0.014, decode_batch_slope=0.0002,
        decode_interference=0.9, ssd_read_gbps=14.0,
        max_batch=160, max_cache_tb=8.0),
}

# paper §6.1 SLOs
SLOS = {
    ("llama3-70b", "chat"): SLO(2.5, 0.2),
    ("llama3-70b", "doc"): SLO(15.0, 0.2),
    ("llama3-8b", "chat"): SLO(0.5, 0.15),
    ("llama3-8b", "doc"): SLO(2.5, 0.15),
}


def serving_model_for_arch(arch: str, *, chips: int = 4,
                           peak_tflops: float = 989.0,
                           hbm_gbps: float = 3350.0) -> ServingModel:
    """Derive a first-principles ServingModel for any assigned architecture
    on ``chips`` cards of ``peak_tflops`` and ``hbm_gbps`` each (defaults:
    the NVIDIA H100 SXM's dense bf16 peak and HBM3 rate) — used by the
    per-arch serving examples."""
    cfg = get_config(arch)
    n_active = cfg.active_param_count
    flops_per_tok = 2.0 * n_active
    eff = 0.45
    prefill_tps = chips * peak_tflops * 1e12 * eff / flops_per_tok
    decode_s = max(n_active * 2.0 / (chips * hbm_gbps * 1e9 * 0.6), 1e-4)
    kv_bpt = max(cfg.kv_bytes_per_token, 2 * cfg.d_model * 4)  # ssm: state amortized
    return ServingModel(
        name=arch, kv_bytes_per_token=kv_bpt,
        prefill_tok_per_s=prefill_tps, prefill_base_s=0.05,
        decode_base_s=decode_s, decode_batch_slope=decode_s * 0.02,
        decode_interference=0.9, ssd_read_gbps=14.0,
        max_batch=64, max_cache_tb=16.0)
