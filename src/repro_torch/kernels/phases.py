"""Where a key tile's time goes in the bf16 flash kernel, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.phases

Builds ``csrc/flash_attention.cu`` with ``-DFLASH_PHASE_CLOCKS`` into a
library of its own beside the shipped one (which has no clock reads), binds
its entry and calls it once at
each bf16 flash shape of the main paths: yi-6b's turn-1, turn-2 and cold
prefills and recurrentgemma-2b's 2,560-token prefill. In that build one
thread of each warpgroup adds up the ``clock64`` cycles of each phase of the
tile loop. Prints, per shape and warpgroup, cycles per tile in each phase
and its share:

- ring barrier: the block barrier that frees a slot, and the wait on the
  ``mbarrier`` of this tile's TMA copies;
- copy issue: issuing the TMA copies of a later tile (one thread);
- S = QK^T and O += PV: issuing the ``wgmma`` products and waiting for them;
- softmax: masks, row maxima, exponentials, row sums, the rescale of O and
  P's conversion to bf16.

The clock reads cost time of their own, so the kernel's times come from
``chip_smoke.py``; these shares say which phase bounds it.
"""
from __future__ import annotations

import ctypes
import hashlib
import subprocess
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.kernels import build, cases, flash_attention
from repro_torch.launch import serve

SOURCE = build.CSRC / "flash_attention.cu"
FLAGS = build.NVCC_FLAGS + ("-DFLASH_PHASE_CLOCKS",)
PHASES = ("ring barrier", "copy issue", "S = QK^T", "softmax", "O += PV")


def shapes():
    """The bf16 flash calls of the main paths, as ``cases`` tuples."""
    cfg = get_config("yi-6b")
    ctx, new, num_new, _ = serve.FULL_TURNS["yi-6b"]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    n2 = ctx + num_new + new
    return {"yi-6b turn 1": (1, H, KV, ctx, ctx, hd, 0, None, True),
            "yi-6b turn 2": (1, H, KV, n2 - ctx, n2, hd, ctx, None, True),
            "yi-6b cold": (1, H, KV, n2, n2, hd, 0, None, True),
            "recurrentgemma-2b prefill": cases.FLASH_GRIFFIN[0]}


def library_path() -> Path:
    """The clock build, named by a hash of the source and the flags."""
    digest = hashlib.sha256(build.source_bytes("flash_attention")
                            + " ".join(FLAGS).encode()).hexdigest()[:16]
    return build.BUILD_DIR / f"libflash_attention_clocks-{digest}.so"


def load() -> ctypes.CDLL:
    """The clock build of the flash kernel, compiled first if needed."""
    path = library_path()
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        subprocess.run([build.nvcc_path(), *FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, timeout=600)
        tmp.replace(path)
    lib = ctypes.CDLL(str(path))
    restype, argtypes = build._SIGNATURES["flash_attention"]["flash_attention_launch"]
    lib.flash_attention_launch.restype = restype
    lib.flash_attention_launch.argtypes = argtypes
    lib.flash_phase_clocks.restype = ctypes.c_int
    lib.flash_phase_clocks.argtypes = [ctypes.c_void_p]
    return lib


def per_tile(counts):
    """{warpgroup: (tiles, [cycles per tile by phase])} from the 2 x 6
    counters (five phases, then the tiles)."""
    out = {}
    for wg in range(2):
        row = counts[6 * wg: 6 * wg + 6]
        tiles = row[5]
        out[wg] = (tiles, [c / max(tiles, 1) for c in row[:5]])
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("phases: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    lib = load()
    stream = torch.cuda.current_stream().cuda_stream
    buf = (ctypes.c_ulonglong * 12)()

    def read():
        torch.cuda.synchronize()
        if lib.flash_phase_clocks(buf):
            raise RuntimeError("reading the phase clocks failed")
        return list(buf)

    for label, case in shapes().items():
        q, k, v = cases.flash_inputs(case, torch.bfloat16, "cuda")
        off, win, causal = case[6:]
        out = torch.empty_like(q)
        args = flash_attention._entry_args(q, k, v, out, off, causal, win, stream)
        for _ in range(2):                # a warm-up call, then the counted one
            read()
            if lib.flash_attention_launch(*args):
                raise RuntimeError("flash_attention launch failed")
        for wg, (tiles, cyc) in per_tile(read()).items():
            total = sum(cyc)
            print(f"{label} {case} warpgroup {wg}: {tiles} tiles, {total:.0f} cycles per "
                  "tile: " + ", ".join(f"{n} {c:.0f} ({c / total:.1%})"
                                       for n, c in zip(PHASES, cyc)))


if __name__ == "__main__":
    main()
