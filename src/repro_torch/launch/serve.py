"""Real-execution serving demo of the port: a two-turn conversation with
prefix reuse, the ``--real --arch`` route of ``repro/launch/serve.py``.

    # full width in bf16 on the card (random weights from seed 0); --arch
    # also takes llama3-8b, h2o-danube-1.8b, minitron-8b, nemotron-4-15b,
    # dbrx-132b, grok-1-314b, qwen2-vl-2b, rwkv6-1.6b and recurrentgemma-2b
    PYTHONPATH=src python -m repro_torch.launch.serve --real --arch yi-6b

    # the reference's reduced demo (2 layers, d_model 128, fp32) on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --real --arch yi-6b \
        --device cpu --reduced

Turn 1 serves a context and decodes; turn 2 sends the same context plus
the generated tokens plus new ones, and must reuse the stored prefix: its
K/V for the dense archs, its recurrent state for rwkv6-1.6b and
recurrentgemma-2b (whose uncached tokens are fed one at a time, as the
reference does). The reduced demo keeps the reference's 2 layers for every
arch, which for recurrentgemma-2b is 0 units and 2 tail recurrent layers.
llama3-70b runs only reduced: its bf16 weights do not fit one 80 GB card.
The two MoE archs do not fit it at their published depth either (dbrx-132b
263.2 GB of bf16 weights at 40 layers, grok-1-314b 633.0 GB at 64): at full
width they are served at every published width with the depth cut to
``FULL_DEPTH`` layers (8 and 5: 54.6 and 52.4 GB), which ``build_engine``
logs; ``--reduced`` keeps the reference's 2 layers. qwen2-vl-2b is served on
its token path, as the reference's engine serves it; seamless-m4t-large-v2
(enc-dec) is not served: the reference's engine fails on it, and the port's
refuses it with a ``ValueError`` that says so. The simulation modes of
``repro.launch.serve`` are not ported.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.kvstore import KVStore
from repro_torch.core.policies import POLICIES
from repro_torch.models import rwkv6 as rw
from repro_torch.models.transformer import griffin_layout, init_params
from repro_torch.serving.realexec import (RealExecutionEngine, check_servable,
                                          resolve_device)

SEED = 0        # weights (torch.Generator) and prompts (numpy)
# (context tokens, new tokens in turn 2, decoded tokens per turn, max_len),
# at full width by arch. rwkv6-1.6b and recurrentgemma-2b feed every
# uncached token through a decode step, so their conversations are shorter;
# recurrentgemma-2b's local-attention ring is min(max_len, 2048) slots.
# h2o-danube-1.8b's ring is min(8192, window 4096) slots: turn 2 reuses the
# 3,584 context tokens, which fit it, and its prompt of 4,608 is longer than
# the window, so the window masks keys in the suffix prefill and the decode
# runs over a wrapped ring. The MoE archs have nemotron-4-15b's attention
# (48/8 heads of 128, d_model 6144) and take its conversation; qwen2-vl-2b
# takes yi-6b's.
FULL_TURNS = {"yi-6b": (2048, 504, 8, 4096),
              "llama3-8b": (2048, 504, 8, 4096),
              "minitron-8b": (2048, 504, 8, 4096),
              "nemotron-4-15b": (2048, 504, 8, 4096),
              "dbrx-132b": (2048, 504, 8, 4096),
              "grok-1-314b": (2048, 504, 8, 4096),
              "qwen2-vl-2b": (2048, 504, 8, 4096),
              "h2o-danube-1.8b": (3584, 1016, 8, 8192),
              "rwkv6-1.6b": (512, 56, 8, 4096),
              "recurrentgemma-2b": (512, 56, 8, 1024)}
REDUCED_TURNS = (24, 8, 4, 128)
CARD_BYTES = 80e9               # one H100's device memory
# layers served at full width where the published depth does not fit the
# card: the weights, plus at init the layer being drawn and one fp32 draw
# of an expert tensor, stay under CARD_BYTES
FULL_DEPTH = {"dbrx-132b": 8, "grok-1-314b": 5}


def _param_counts(cfg):
    """(elements in the model's dtype, elements kept in fp32, largest
    leaf's elements) of ``cfg``'s weights as ``init_params`` lays them out,
    for every family. The fp32 leaves are the MoE router, RWKV6's
    ``FP32_LEAVES`` (``mu``, ``decay_base``, ``u``, ``mu_k``, ``mu_r``) and
    Griffin's ``ba``, ``bx`` and ``lam``."""
    d, hd, L, V = cfg.d_model, cfg.head_dim, cfg.num_layers, cfg.padded_vocab
    attn = d * (cfg.num_heads + cfg.num_kv_heads) * hd * 2
    mlp = d * cfg.d_ff * (3 if cfg.gated_mlp else 2)
    n = 2 * V * d + d                   # embed, unembed, final_ln
    if cfg.family == "ssm":             # ln1, ln2, time-mix, channel-mix
        mixes = len(rw._MIX_NAMES)
        tmix = 2 * mixes * rw.LORA_R * d + 5 * d * d + 2 * rw.DECAY_LORA_R * d + 2 * d
        n += L * (2 * d + tmix + 2 * d * cfg.d_ff + d * d)
        fp32 = L * (mixes + 4) * d
        return n, fp32, max(V * d, L * d * max(cfg.d_ff, d))
    if cfg.family == "hybrid":          # units of (rec, rec, attn) and tail rec layers
        units, tail = griffin_layout(cfg)
        dr = cfg.rnn_width
        rec = 2 * d + 3 * d * dr + cfg.conv_width * dr + dr + 2 * dr * dr + mlp
        n += (2 * units + tail) * rec + units * (2 * d + attn + mlp)
        fp32 = (2 * units + tail) * 3 * dr
        widest = max(d * cfg.d_ff, d * dr, dr * dr, d * cfg.num_heads * hd)
        return n, fp32, max(V * d, max(units, tail) * widest)
    ffn = d * cfg.d_ff * (cfg.num_experts if cfg.family == "moe" else 1)
    mlp = ffn * (3 if cfg.gated_mlp else 2)
    fp32 = L * d * cfg.num_experts if cfg.family == "moe" else 0   # the router
    if cfg.family == "encdec":          # frames_proj, enc_ln; decoder: self + cross
        n += d * d + d + cfg.encoder_layers * (attn + mlp + 2 * d) \
            + L * (2 * attn + mlp + 3 * d)
    else:
        n += L * (attn + mlp + 2 * d)
    if cfg.family == "vlm":             # patch_proj
        n += d * d
    largest = max(V * d, max(L, cfg.encoder_layers) * ffn, L * d * cfg.num_heads * hd)
    return n, fp32, largest


def weight_bytes(cfg, dtype=torch.bfloat16) -> int:
    """Bytes of ``cfg``'s weights as ``init_params`` lays them out, the
    fp32 leaves in fp32 (``_param_counts``): a MoE layer's ``E`` experts and
    router, a VLM's ``patch_proj``, an enc-dec model's ``frames_proj``,
    encoder and decoder stacks, RWKV6's and Griffin's layers."""
    n, fp32, _ = _param_counts(cfg)
    return n * torch.finfo(dtype).bits // 8 + fp32 * 4


def train_bytes(cfg, dtype=torch.bfloat16) -> int:
    """Bytes of a training state of ``cfg`` on one card: weights and
    gradients in ``dtype`` (the fp32 leaves' in fp32), fp32 AdamW moments,
    and the update's two fp32 temporaries of the largest leaf
    (``train.optimizer.adamw_update``). The activations (one layer input
    per layer under remat, the loss chunks' fp32 logits, the recurrent
    backward's checkpoints for one layer) depend on the batch and come on
    top."""
    n, fp32, largest = _param_counts(cfg)
    return n * (2 * torch.finfo(dtype).bits // 8 + 8) + fp32 * 16 + 2 * 4 * largest


def turns(arch: str, reduced: bool):
    if reduced:
        return REDUCED_TURNS
    if arch not in FULL_TURNS:
        cfg = get_config(arch)
        raise ValueError(f"{arch} at full width holds {weight_bytes(cfg) / 1e9:.1f} GB "
                         f"of bf16 weights, more than one card's {CARD_BYTES / 1e9:.0f} "
                         "GB; serve it with --reduced")
    return FULL_TURNS[arch]


def build_engine(arch: str, *, device=None, reduced: bool = False,
                 params=None, moe_capacity_factor=None):
    """(cfg, engine) for ``arch``: full width in bf16, the depth cut to
    ``FULL_DEPTH`` where it has an entry (logged when the weights are
    drawn), or the reduced demo config in fp32; weights drawn from
    ``torch.Generator`` seed ``SEED`` unless ``params`` are given (an engine
    over the same weights). ``moe_capacity_factor`` replaces the config's."""
    dev = resolve_device(device)
    cfg = full = get_config(arch)
    check_servable(cfg)                 # before any weight is drawn
    if reduced:
        cfg = cfg.reduced(num_layers=2, d_model=128)
    elif arch in FULL_DEPTH:
        cfg = dataclasses.replace(cfg, num_layers=FULL_DEPTH[arch])
    if moe_capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=moe_capacity_factor)
    dtype = torch.float32 if reduced else torch.bfloat16
    max_len = turns(arch, reduced)[3]
    if params is None:
        if cfg.num_layers != full.num_layers and not reduced:
            print(f"{arch}: published depth {full.num_layers} layers "
                  f"({weight_bytes(full) / 1e9:.1f} GB of bf16 weights) does not fit one "
                  f"{CARD_BYTES / 1e9:.0f} GB card; serving {cfg.num_layers} layers "
                  f"({weight_bytes(cfg) / 1e9:.1f} GB) at every published width")
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = init_params(gen, cfg, dtype)
    store = KVStore(64e9, POLICIES["lcs"], max(cfg.kv_bytes_per_token, 1))
    return cfg, RealExecutionEngine(cfg, params, store, max_len=max_len,
                                    dtype=dtype, device=dev)


def conversation(cfg, reduced: bool):
    """Turn-1 context and the turn-2 extension, drawn with numpy."""
    ctx_len, new_len, num_new, _ = turns(cfg.name, reduced)
    rng = np.random.default_rng(SEED)
    ctx = [int(t) for t in rng.integers(0, cfg.vocab_size, size=ctx_len)]
    extra = [int(t) for t in rng.integers(0, cfg.vocab_size, size=new_len)]
    return ctx, extra, num_new


def two_turns(cfg, eng, reduced: bool):
    """Run the two-turn conversation; returns (turn-2 prompt, r1, r2)."""
    ctx, extra, num_new = conversation(cfg, reduced)
    r1 = eng.generate("conv-0", ctx, num_new=num_new)
    ctx2 = ctx + r1.tokens + extra
    r2 = eng.generate("conv-0", ctx2, num_new=num_new)
    return ctx2, r1, r2


def run_real(args):
    cfg, eng = build_engine(args.arch, device=args.device, reduced=args.reduced)
    ctx2, r1, r2 = two_turns(cfg, eng, args.reduced)
    for i, r in ((1, r1), (2, r2)):
        print(f"turn {i}: computed {r.prefill_tokens_computed} prefill tokens, "
              f"reused {r.reused_tokens} -> {r.tokens} "
              f"(prefill {r.prefill_time_s * 1e3:.3f} ms, "
              f"decode {r.decode_time_s * 1e3:.3f} ms on {eng.device})")
    if r2.reused_tokens == 0:
        raise SystemExit("expected a cache hit on turn 2")
    print("cache hit verified: suffix-only prefill")
    return r2


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--real", action="store_true",
                    help="real execution (the only mode of the port)")
    ap.add_argument("--arch", default="yi-6b", choices=sorted(ALL_ARCHS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="2 layers, d_model 128, fp32 (the reference's demo)")
    args = ap.parse_args(argv)
    if not args.real:
        ap.error("the port serves --real only; the simulation modes run in "
                 "the JAX package: python -m repro.launch.serve")
    run_real(args)


if __name__ == "__main__":
    main()
