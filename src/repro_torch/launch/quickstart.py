"""Quickstart of the port, the twin of ``examples/quickstart.py``:
GreenCache in three parts.

1. Real KV-prefix caching with a PyTorch model (reduced yi-6b, 2 layers
   x 128): a cache hit prefills only the uncached suffix.
2. The carbon tradeoff (paper Eq. 5): when is caching green?
3. One carbon-aware sizing decision for the profiled Llama-3 70B (chat),
   in FR and in CISO.

    PYTHONPATH=src python -m repro_torch.launch.quickstart            # card
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu

Part 1 runs on ``cuda`` unless ``--device cpu`` is passed, and raises when
no card is there. Parts 2 and 3 are the simulator's host NumPy code and run
on the CPU either way. The solver is the exact DP (``solver=dp``), as the
reference's is wherever ``pulp`` cannot be imported.
"""
from __future__ import annotations

import argparse
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.carbon import GRID_CI, CarbonModel
from repro_torch.core.kvstore import KVStore
from repro_torch.core.policies import POLICIES
from repro_torch.core.profiler import Profile, run_profiler
from repro_torch.core.solver import SolveResult, solve_cache_schedule
from repro_torch.models.transformer import init_params
from repro_torch.serving.perfmodel import SERVING_MODELS, SLOS
from repro_torch.serving.realexec import RealExecutionEngine, resolve_device
from repro_torch.workloads.conversations import ConversationWorkload

# part 2: kWh a request without and with the cache (profiled), 16 TB cached,
# 0.67 s of the server a request
E_NO_CACHE, E_CACHED, CACHE_TB, SECONDS = 3.1e-4, 2.8e-4, 16.0, 0.67
GRIDS_TRADEOFF = ("FR", "ES", "MISO")
# part 3: the profile's grid and the next six hours' predicted rates
RATES = (0.4, 1.0, 1.6)
SIZES_TB = (0, 2, 8, 16)
WARMUP, MEAS_SECONDS = 6000, 500
PRED_RATES = (0.3, 0.4, 0.9, 1.5, 1.6, 1.2)
GRIDS_SOLVE = ("FR", "CISO")


def _banner(title: str):
    print("=" * 70)
    print(title)
    print("=" * 70)


def part1(device="cuda", params=None):
    """Two turns of one conversation through the port's real engine: turn 2
    reuses turn 1's cached prefix. ``params`` default to a draw from
    ``torch.Generator`` seed 0; returns the two ``GenerationResult``s."""
    dev = resolve_device(device)
    cfg = get_config("yi-6b").reduced(num_layers=2, d_model=128)
    _banner(f"1) Real KV-prefix caching (reduced yi-6b, {dev.type})")
    if params is None:
        params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                             torch.float32)
    store = KVStore(64e6, POLICIES["lcs_chat"], cfg.kv_bytes_per_token)
    eng = RealExecutionEngine(cfg, params, store, max_len=128,
                              dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    turn1 = [int(t) for t in rng.integers(0, cfg.vocab_size, 24)]
    r1 = eng.generate("conv-demo", turn1, num_new=4)
    print(f"turn 1: prefilled {r1.prefill_tokens_computed} tokens "
          f"(cache miss), generated {r1.tokens}")
    turn2 = turn1 + r1.tokens + [int(t) for t in rng.integers(0, cfg.vocab_size, 8)]
    r2 = eng.generate("conv-demo", turn2, num_new=4)
    print(f"turn 2: prefilled {r2.prefill_tokens_computed} tokens, "
          f"REUSED {r2.reused_tokens} cached tokens, generated {r2.tokens}")
    return r1, r2


def part2(cm: CarbonModel) -> List[Tuple[str, float, float, str]]:
    """(grid, no-cache g, cached g, verdict) of one request in each grid."""
    _banner("2) The carbon tradeoff (paper Eq. 5): cache 16 TB for one request")
    rows = []
    for grid in GRIDS_TRADEOFF:
        ci = GRID_CI[grid]
        nc = cm.total_g(E_NO_CACHE, ci, 0.0, SECONDS)
        c = cm.total_g(E_CACHED, ci, CACHE_TB, SECONDS)
        verdict = "cache is GREEN" if c < nc else "cache EMITS MORE"
        print(f"  {grid:5s} (CI={ci:3.0f}): no-cache {nc:.4f} g, "
              f"16TB-cache {c:.4f} g -> {verdict}")
        rows.append((grid, nc, c, verdict))
    return rows


def profile_chat(cm: CarbonModel) -> Profile:
    """The §5.2 profile of the simulated Llama-3 70B serving chat."""
    return run_profiler(SERVING_MODELS["llama3-70b"], "conversation",
                        lambda s: ConversationWorkload(seed=s), cm,
                        rates=list(RATES), sizes_tb=list(SIZES_TB),
                        warmup_prompts=WARMUP, meas_seconds=MEAS_SECONDS)


def part3(cm: CarbonModel, prof: Profile = None
          ) -> List[Tuple[str, SolveResult]]:
    """Hourly cache sizes for the next six hours in FR and CISO."""
    _banner("3) One carbon-aware sizing decision (profiled llama3-70B, chat)")
    if prof is None:
        prof = profile_chat(cm)
    out = []
    for grid in GRIDS_SOLVE:
        cis = [GRID_CI[grid]] * len(PRED_RATES)
        res = solve_cache_schedule(prof, list(PRED_RATES), cis,
                                   SLOS[("llama3-70b", "chat")], cm)
        print(f"  {grid:5s}: hourly cache sizes {res.sizes_tb} TB "
              f"(solver={res.solver}, {res.solve_time_s:.2f}s)")
        out.append((grid, res))
    return out


def main(device="cuda", params=None, prof: Profile = None):
    """All three parts; returns their results. ``params`` (part 1's
    weights) and ``prof`` (part 3's profile) default to fresh ones."""
    r = part1(device, params)
    print()
    cm = CarbonModel()
    rows = part2(cm)
    print()
    solves = part3(cm, prof)
    print("\nDone. The 24-hour day (the controller) is not in this "
          "package yet.")
    return r, rows, solves


def _cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args(argv).device)


if __name__ == "__main__":
    _cli()
