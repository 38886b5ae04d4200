"""Per-architecture serving demo of the port, the twin of
``examples/multiarch_decode.py``: real prefill and decode with context-cache
reuse for every served family (reduced configs, fp32), KV-prefix reuse for
the attention archs and state-snapshot reuse for the recurrent ones.

    PYTHONPATH=src python -m repro_torch.launch.multiarch --device cpu

The same six archs as the reference's demo, reduced as it reduces them (4
layers for the hybrid, 2 for the rest, d_model 128), on the same
conversation: 20 context tokens and 3 decoded, then those, the 3 and 6 new
ones, which must reuse the 20. qwen2-vl-2b is served on its token path, as
the reference serves it. seamless-m4t-large-v2 (enc-dec) is skipped, as the
reference's demo skips it: no engine serves enc-dec (the reference's fails
on it, the port's refuses it).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.kvstore import KVStore
from repro_torch.core.policies import POLICIES
from repro_torch.models.transformer import init_params
from repro_torch.serving.realexec import RealExecutionEngine

ARCHS = ("yi-6b", "h2o-danube-1.8b", "dbrx-132b", "rwkv6-1.6b",
         "recurrentgemma-2b", "qwen2-vl-2b")
SKIPPED = "seamless-m4t-large-v2"
MAX_LEN = 128


def demo_config(arch: str):
    cfg = get_config(arch)
    return cfg.reduced(num_layers=4 if cfg.family == "hybrid" else 2, d_model=128)


def serve_arch(arch: str, device="cuda", params=None):
    """(cfg, turn-2 prompt, r1, r2) of the demo's conversation for ``arch``,
    on ``params`` (default: drawn from ``torch.Generator`` seed 0)."""
    cfg = demo_config(arch)
    if params is None:
        params = init_params(torch.Generator(device=device).manual_seed(0), cfg,
                             torch.float32)
    store = KVStore(64e6, POLICIES["lcs"], max(cfg.kv_bytes_per_token, 1.0))
    eng = RealExecutionEngine(cfg, params, store, max_len=MAX_LEN,
                              dtype=torch.float32, device=device)
    rng = np.random.default_rng(1)
    ctx = [int(t) for t in rng.integers(0, cfg.vocab_size, 20)]
    r1 = eng.generate(f"{arch}-c0", ctx, num_new=3)
    ctx2 = ctx + r1.tokens + [int(t) for t in rng.integers(0, cfg.vocab_size, 6)]
    r2 = eng.generate(f"{arch}-c0", ctx2, num_new=3)
    return cfg, ctx2, r1, r2


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for arch in ARCHS:
        t0 = time.perf_counter()
        cfg, ctx2, _, r2 = serve_arch(arch, args.device)
        kind = "state-snapshot" if cfg.family in ("ssm", "hybrid") else "KV-prefix"
        print(f"{arch:22s} [{cfg.family:6s}] {kind:14s} reuse: "
              f"turn2 computed {r2.prefill_tokens_computed:2d}/{len(ctx2)} tokens "
              f"(reused {r2.reused_tokens}) in {time.perf_counter() - t0:.1f}s")
        if r2.reused_tokens == 0:
            raise SystemExit(f"{arch}: expected a cache hit on turn 2")
    print(f"{SKIPPED:22s} [encdec] skipped: no engine serves enc-dec (the "
          "reference's fails on it with KeyError: 'frames'); it runs through the "
          "model functions")
    print("\nAll families serve with context-cache reuse.")


if __name__ == "__main__":
    main()
