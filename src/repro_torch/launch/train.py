"""Training entry point of the port, the twin of ``repro/launch/train.py``.

On the CPU (the reduced variant; ``launch/train_100m.py`` runs the ~100M
example):

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
        --d-model 512 --layers 8 --batch 8 --seq 256 --steps 300

On the card (``--device cuda``, the default), the same step with the
kernels' gradients (the flash backward, the wkv6 backward, the RG-LRU
scan's backward), e.g. at full width and depth:

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
        --batch 1 --seq 8192 --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \\
        --batch 1 --seq 4096 --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \\
        --batch 1 --seq 8192 --steps 3

The reference's flags, plus ``--device``; weights in fp32, as the
reference's ``launch/train.py`` draws them. ``--device cuda`` raises where there is no
card. Before any weight is drawn it refuses, with a ``ValueError``, a
config whose training state (``serve.train_bytes``) does not fit one card.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.train import tree
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.data import batch_iterator, batch_to
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.steps import init_train_state, make_train_step

DTYPE = torch.float32


def train_device(name: str, cfg, dtype=DTYPE) -> torch.device:
    """The device to train ``cfg`` on; raises where it cannot train there."""
    device = torch.device(name)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"trains on cpu or cuda, not {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card here: pass --device cpu to train on the CPU")
    need = serve.train_bytes(cfg, dtype)
    if need > serve.CARD_BYTES:
        raise ValueError(f"{cfg.name}: its training state in {str(dtype)[6:]} takes "
                         f"{need / 1e9:.1f} GB ({need} bytes: weights, gradients, AdamW "
                         "moments and the update's temporaries), more than one card's "
                         f"{serve.CARD_BYTES / 1e9:.0f} GB")
    return device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (CPU-scale) variant")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(num_layers=args.layers, d_model=args.d_model)
    device = train_device(args.device, cfg)

    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 10))
    params, opt_state = init_train_state(args.seed, cfg, dtype=DTYPE, device=device)
    n = sum(p.numel() for p in tree.leaves(params))
    print(f"arch={cfg.name} family={cfg.family} params={n / 1e6:.1f}M device={device}")
    start_step = 0
    if args.restore and args.checkpoint:
        params, start_step = restore_checkpoint(args.checkpoint, params)
        print(f"restored step {start_step}")

    step_fn = make_train_step(cfg, opt_cfg)
    it = batch_iterator(cfg, args.batch, args.seq, seed=args.seed)

    t0 = time.time()
    losses = []
    for step in range(start_step, args.steps):
        batch = batch_to(next(it), device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} ({dt:.3f}s)", flush=True)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, params, step=args.steps)
        print(f"saved {args.checkpoint}")
    print(f"first-10 mean loss {sum(losses[:10])/min(len(losses),10):.4f} -> "
          f"last-10 mean {sum(losses[-10:])/min(len(losses),10):.4f}")
    return losses


if __name__ == "__main__":
    main()
