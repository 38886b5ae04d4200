"""The twin of ``examples/train_100m.py``: yi-6b reduced to 12 layers of
d_model 768 (4 heads of 192; the reduced vocabulary of 512 makes it about
72M parameters) trained in fp32 for a few hundred steps through
``launch.train``, with the whole substrate (data pipeline, AdamW, remat,
chunked cross-entropy, a checkpoint), then checks that the loss fell.

    PYTHONPATH=src python -m repro_torch.launch.train_100m [--steps 300] [--device cpu]

The checkpoint goes to ``build/train_100m_ckpt`` in the checkout (the
reference's example writes ``/tmp/repro_100m_ckpt``).
"""
from __future__ import annotations

import argparse

from repro_torch.kernels.build import BUILD_DIR
from repro_torch.launch.train import main as train_main

CHECKPOINT = BUILD_DIR.parent / "train_100m_ckpt"
LAYERS, D_MODEL, BATCH, SEQ = 12, 768, 4, 256


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint", default=str(CHECKPOINT))
    a = ap.parse_args(argv)
    losses = train_main([
        "--arch", a.arch, "--reduced", "--layers", str(LAYERS),
        "--d-model", str(D_MODEL), "--batch", str(BATCH), "--seq", str(SEQ),
        "--steps", str(a.steps), "--checkpoint", a.checkpoint, "--device", a.device])
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss should decrease: {losses[0]} -> {losses[-1]}")
    print("OK: loss decreased", losses[0], "->", losses[-1])
    return losses


if __name__ == "__main__":
    main()
