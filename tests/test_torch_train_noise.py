"""How far rwkv6-1.6b's bf16 grad norms move under rounding-level noise in
the wkv6 backward, on the card.

    PYTHONPATH=src python -m pytest -m gpu -s tests/test_torch_train_noise.py

rwkv6-1.6b at full width and depth, bf16 weights and fp32 moments from
``init_train_state`` (seed 0), batches of 1 x 4,096 tokens
(``batch_iterator`` seed 0), two steps of ``make_train_step`` with
chip_smoke.py's AdamW settings. The wkv6 backward of a step is one of

* ``kernel``: the CUDA kernel (``wkv6._launch_bwd``); in the first run
  every call is also held against the float64 plain version
  ``ref.wkv6_bwd_ref`` on the same inputs;
* ``plain``: the plain version itself, its dr, dk and dv rounded to r's
  dtype as the kernel's are;
* ``flips``: the kernel with a share of dr, dk and dv's nonzero entries
  moved by one bf16 unit in the last place, up or down at random
  (``torch.Generator`` seed 1), ``DRAWS`` draws at each share of
  ``SHARES``.

The runs: the kernel at both steps, twice (the path's determinism); the
plain version at both; the two splits, step 1 through the kernel from the
plain version's step-0 state and through the plain version from the
kernel's; the draws. Each prints its steps' loss and global grad norm and
its three largest leaves at step 1; the first run also prints, per step,
the share of dr, dk, dv entries that differ from the plain version's and
their largest relative error. Asserts that every kernel call of the first
run holds the plain version (dr, dk, dv of bf16 r at ``TOL[bf16]``, fp32
gradients at ``WKV6_TOL``) and that every grad norm is finite. Ends with
the card's name and power limit.
"""
import subprocess

import pytest
import torch
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

from repro_torch.configs import get_config
from repro_torch.kernels import cases, ref
from repro_torch.kernels import wkv6 as wkv6_mod
from repro_torch.train import steps as steps_mod
from repro_torch.train import tree
from repro_torch.train.data import batch_iterator, batch_to
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.steps import init_train_state, make_train_step

ARCH = "rwkv6-1.6b"
TOKENS = 4096                   # chip_smoke.py's RWKV_TRAIN_TOKENS
DRAWS = 8
SHARES = (0.1, 1e-4)            # of dr, dk, dv entries moved by one ulp
GRADS = ("r", "k", "v", "w", "u", "s0")


def _to(x, device):
    """``x`` (tensors in dicts, tuples and named tuples) copied to ``device``."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device, copy=True)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, tuple):
        items = [_to(v, device) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def _rel(x, want):
    x, want = x.double(), want.double()
    return float((x - want).norm() / want.norm().clamp_min(1e-300))


@pytest.mark.gpu
def test_rwkv6_bf16_grad_norms_under_rounding_noise(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(ARCH)
    step = make_train_step(cfg, AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=3))
    it = batch_iterator(cfg, 1, TOKENS, seed=0)
    batches = [next(it) for _ in range(2)]
    kernel = wkv6_mod._launch_bwd
    leaves = []
    adamw_update = steps_mod.adamw_update

    def recording(opt_cfg, grads, opt_state, params):
        leaves[:] = [(path, float(g.float().norm())) for path, g in tree.items(grads)]
        return adamw_update(opt_cfg, grads, opt_state, params)

    monkeypatch.setattr(steps_mod, "adamw_update", recording)

    def train(bwds, start=None):
        """[(loss, grad norm, three largest leaves)] of steps 0 and 1 (of step
        1 alone from ``start``, a CPU copy of the state after step 0), the
        i-th step's wkv6 backward through bwds[i]; and the state after step
        0, copied to the CPU."""
        if start is None:
            params, opt = init_train_state(0, cfg, torch.bfloat16, device="cuda")
        else:
            params, opt = _to(start, "cuda")
        out, saved = [], None
        for i, bwd in enumerate(bwds, start=0 if start is None else 1):
            monkeypatch.setattr(wkv6_mod, "_launch_bwd", bwd)
            params, opt, m = step(params, opt, batch_to(batches[i], "cuda"))
            top = sorted(leaves, key=lambda kv: -kv[1])[:3]
            out.append((float(m["loss"]), float(m["grad_norm"]), top))
            if i == 0 and start is None and len(bwds) > 1:
                saved = _to((params, opt), "cpu")
        monkeypatch.setattr(wkv6_mod, "_launch_bwd", kernel)
        del params, opt
        torch.cuda.empty_cache()
        return out, saved

    def show(label, out):
        first = 0 if len(out) == 2 else 1
        print(f"{label}: " + "; ".join(
            f"step {first + i} loss {loss:.4f} grad norm {g:.4f}"
            for i, (loss, g, _) in enumerate(out))
            + "; step 1's largest leaves " + ", ".join(f"{n} {g:.4f}" for n, g in out[-1][2]),
            flush=True)
        assert all(torch.isfinite(torch.tensor(g)) for _, g, _ in out)
        return [g for _, g, _ in out]

    calls = []

    def held(r, k, v, w, u, ckpt, dy, ds_n):
        got = kernel(r, k, v, w, u, ckpt, dy, ds_n)
        want = ref.wkv6_bwd_ref(r, k, v, w, u, None, ckpt, dy, ds_n)
        for n, a, b in zip(GRADS, got, want):
            cases.held(f"wkv6_bwd d{n} in training", (ARCH, len(calls)), a, b,
                       cases.TOL[torch.bfloat16] if b.dtype == torch.bfloat16
                       else cases.WKV6_TOL)
        calls.append([(float((a != b).float().mean()), _rel(a, b))
                      for a, b in zip(got[:3], want[:3])])
        return got

    def plain(r, k, v, w, u, ckpt, dy, ds_n):
        return ref.wkv6_bwd_ref(r, k, v, w, u, None, ckpt, dy, ds_n)

    print(f"\n{ARCH}, bf16, 1 x {TOKENS} tokens", flush=True)
    out, kernel_state = train((held, held))
    show("kernel", out)
    per_step = len(calls) // 2
    for st in range(2):
        part = calls[st * per_step:(st + 1) * per_step]
        print(f"  step {st}, over its {per_step} wkv6_bwd calls against the plain version: "
              + "; ".join(f"d{n} entries that differ at most {max(c[q][0] for c in part):.3e}, "
                          f"relative error at most {max(c[q][1] for c in part):.3e}"
                          for q, n in enumerate("rkv")), flush=True)
    show("kernel again", train((kernel, kernel))[0])
    out, plain_state = train((plain, plain))
    show("plain", out)
    show("plain's step 0, then the kernel", train((kernel,), plain_state)[0])
    show("kernel's step 0, then plain", train((plain,), kernel_state)[0])
    del plain_state, kernel_state
    gen = torch.Generator(device="cuda")
    for share in SHARES:
        gen.manual_seed(1)

        def flipped(*inputs):
            out = list(kernel(*inputs))
            for q in range(3):
                bits = out[q].view(torch.int16)
                # a zero stays: one step down from +0 or -0 in the bits is a NaN
                flip = (torch.rand(bits.shape, device="cuda", generator=gen) < share) \
                    & ((bits & 0x7FFF) != 0)
                up = torch.rand(bits.shape, device="cuda", generator=gen) < 0.5
                out[q] = (bits + flip.to(torch.int16) * (2 * up.to(torch.int16) - 1)).view(
                    out[q].dtype)
            return tuple(out)

        drawn = [show(f"flips {share:g}, draw {d}", train((flipped, flipped))[0])
                 for d in range(DRAWS)]
        for st in range(2):
            g = sorted(n[st] for n in drawn)
            print(f"flips {share:g}, step {st}: grad norms {g[0]:.4f} .. {g[-1]:.4f} over "
                  f"{DRAWS} draws, median {(g[DRAWS // 2 - 1] + g[DRAWS // 2]) / 2:.4f}",
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
