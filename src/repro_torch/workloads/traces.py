"""Synthetic traces statistically matched to the paper's sources.

* ``azure_rate_trace`` — Azure LLM inference trace [AzurePublicDataset 2024]:
  strong diurnal pattern (paper §6.1 downscales it to platform capacity).
* ``ci_trace`` — CarbonCast-style hourly carbon intensity for FR/FI/ES/CISO:
  grid-characteristic shapes (CISO duck curve with the paper's reported
  37 gCO₂e/kWh 7–9 AM minimum and 232 g 8 PM peak on the evaluated day).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.carbon import GRID_CI

HOURS = 24


def azure_rate_trace(peak_rate: float, days: int = 1, seed: int = 0,
                     noise: float = 0.06) -> np.ndarray:
    """Hourly request rates (req/s), diurnal, scaled so max == peak_rate."""
    if not peak_rate > 0.0:
        raise ValueError(f"peak_rate must be > 0, got {peak_rate!r}")
    if days < 1:
        raise ValueError(f"days must be >= 1, got {days!r}")
    rng = np.random.default_rng(seed)
    h = np.arange(HOURS)
    base = (0.25
            + 0.55 * np.exp(-0.5 * ((h - 11.0) / 3.2) ** 2)
            + 0.45 * np.exp(-0.5 * ((h - 15.5) / 2.6) ** 2)
            + 0.18 * np.exp(-0.5 * ((h - 20.0) / 1.8) ** 2))
    base = base / base.max()
    out = []
    for _ in range(days):
        day = base * (1.0 + noise * rng.standard_normal(HOURS))
        out.append(np.clip(day, 0.05, None))
    trace = np.concatenate(out)
    return trace / trace.max() * peak_rate


_GRID_SHAPE = {
    # (solar_dip_depth, evening_peak, noise)
    "FR": (0.05, 0.10, 0.10),
    "FI": (0.10, 0.15, 0.12),
    "ES": (0.35, 0.25, 0.10),
    "CISO": (0.75, 0.45, 0.08),
}


def ci_trace(grid: str, days: int = 1, seed: int = 1) -> np.ndarray:
    """Hourly gCO2e/kWh. Mean ≈ GRID_CI[grid]; shape grid-characteristic.
    The grid name is folded into the RNG seed with a process-stable hash
    (builtin ``hash`` is salted per interpreter run, which made the
    "same" trace differ between processes — figures must reproduce)."""
    import zlib
    if grid not in GRID_CI:
        raise ValueError(f"unknown grid {grid!r}; one of "
                         f"{sorted(GRID_CI)}")
    if days < 1:
        raise ValueError(f"days must be >= 1, got {days!r}")
    rng = np.random.default_rng(seed + zlib.crc32(grid.encode()) % 1000)
    mean = GRID_CI[grid]
    dip, peak, noise = _GRID_SHAPE.get(grid, (0.2, 0.2, 0.1))
    h = np.arange(HOURS)
    solar = np.exp(-0.5 * ((h - 11.5) / 3.0) ** 2)         # midday sun
    evening = np.exp(-0.5 * ((h - 20.0) / 1.7) ** 2)
    shape = 1.0 - dip * solar + peak * evening
    shape = shape / shape.mean()
    out = []
    for _ in range(days):
        day = mean * shape * (1.0 + noise * rng.standard_normal(HOURS))
        out.append(np.clip(day, 5.0, None))
    return np.concatenate(out)


def make_poisson_arrivals(rate_per_hour: np.ndarray, seed: int = 0,
                          max_requests: int | None = None) -> np.ndarray:
    """Arrival timestamps (s) for a piecewise-constant hourly rate trace."""
    rng = np.random.default_rng(seed)
    ts = []
    for hour, lam in enumerate(rate_per_hour):
        t = hour * 3600.0
        end = t + 3600.0
        while True:
            lam = max(float(lam), 1e-6)
            t += rng.exponential(1.0 / lam)
            if t >= end:
                break
            ts.append(t)
            if max_requests and len(ts) >= max_requests:
                return np.array(ts)
    return np.array(ts)
