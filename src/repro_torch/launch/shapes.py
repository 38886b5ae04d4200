"""The calls each served path gives the two attention kernels, computed from
the configs, the turns of ``serve.FULL_TURNS`` and the model phases' sizes
below.

``chip_smoke.py`` holds the kernels against their plain versions at these
shapes on the card and ``tests/test_torch_gpu.py`` takes the same rows, so
the list lives here once. Flash shapes are ``cases``' flash cases, decode
shapes its decode cases; an identity pair is ``(cold case, first hit row)``
as in ``cases.FLASH_IDENTITY``.
"""
from __future__ import annotations

import torch

from repro_torch.configs import get_config
from repro_torch.kernels import cases
from repro_torch.launch import serve
from repro_torch.models import transformer as tt

# the dense archs served at full width after yi-6b and the recurrent ones
DENSE = ("llama3-8b", "h2o-danube-1.8b", "minitron-8b", "nemotron-4-15b")
# the MoE archs, served at full width with the depth cut: their attention is
# nemotron-4-15b's and so are their calls
MOE = ("dbrx-132b", "grok-1-314b")
# archs whose weights do not fit the card: their heads run as kernel rows
# at the conversation of the arch named
HEADS_ONLY = {"llama3-70b": "llama3-8b"}
LONG = "llama3-8b"                        # the long-context model phase
LONG_PREFILL = 10240                      # past the long-context window of 8,192
LONG_MAX_LEN = 12288
LONG_ROWS = 1024                          # the hit's rows of the long-context flash row
VLM = "qwen2-vl-2b"                       # an engine phase and the vision model phase
VISION_TEXT = 2048                        # text tokens after the image
VISION_MAX_LEN = 4096
VISION_STEPS = 4                          # decode steps after the vision prefill
ENCDEC = "seamless-m4t-large-v2"          # the enc-dec model phase
ENCDEC_TARGET = 512                       # target tokens of its prefill
ENCDEC_MAX_LEN = 1024
ENCDEC_STEPS = 8


def ring_case(cfg, W: int, pos: int, window):
    """The decode kernel's case at the step that writes position ``pos``
    into a ring of ``W`` slots: the slots ``decode_attend`` leaves valid,
    counted from the slot of the oldest position they hold."""
    kpos = tt.ring_kpos(W, pos)
    valid = (kpos >= 0) & (kpos <= pos)
    if window is not None:
        valid &= kpos > pos - window
    nvalid, start = int(valid.sum()), int(kpos[valid].min()) % W
    if not (cases.decode_valid(W, nvalid, start) == valid.int().numpy()).all():
        raise AssertionError(f"{cfg.name}: the valid slots at {pos} are not one run")
    return (1, cfg.num_heads, cfg.num_kv_heads, W, cfg.head_dim, nvalid, start)


def main_path_shapes(cfg, conversation=None):
    """Every shape a dense arch's two-turn conversation (and the cold
    engine) gives each kernel, at the turns of ``conversation`` (default:
    its own). Flash: turn 1's cold prefill, turn 2's suffix prefill, the
    cold engine's prefill of the turn-2 prompt. Decode: the last step of
    turn 2, over the ring."""
    ctx, new, num_new, max_len = serve.FULL_TURNS[conversation or cfg.name]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    win = tt.attn_window(cfg)
    n2 = ctx + num_new + new
    flash = {"turn 1": (1, H, KV, ctx, ctx, hd, 0, win, True),
             "turn 2": (1, H, KV, n2 - ctx, n2, hd, ctx, win, True),
             "cold": (1, H, KV, n2, n2, hd, 0, win, True)}
    decode = {"turn 2": ring_case(cfg, tt.cache_width(cfg, max_len),
                                  n2 + num_new - 1, win)}
    return flash, decode


def griffin_decode_shape(cfg):
    """The decode kernel's shape at the last step of recurrentgemma-2b's
    turn 2: the local-attention ring of min(max_len, window) slots."""
    ctx, new, num_new, max_len = serve.FULL_TURNS[cfg.name]
    return ring_case(cfg, min(max_len, cfg.local_window), ctx + 2 * num_new + new - 1,
                     cfg.local_window)


def long_context_shapes(cfg):
    """The long-context model phase's calls. Flash: the prefill of
    ``LONG_PREFILL`` tokens, ``forward`` of one more, and the prefill's last
    ``LONG_ROWS`` rows as a hit's call on the same keys. Decode: the step
    after the prefill, over the wrapped ring."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    win = tt.attn_window(cfg, long_context=True)
    W = tt.cache_width(cfg, LONG_MAX_LEN, long_context=True)
    S, first = LONG_PREFILL, LONG_PREFILL - LONG_ROWS
    flash = {"prefill": (1, H, KV, S, S, hd, 0, win, True),
             "forward": (1, H, KV, S + 1, S + 1, hd, 0, win, True),
             f"rows {first}-": (1, H, KV, LONG_ROWS, S, hd, first, win, True)}
    return flash, {"step": ring_case(cfg, W, S, win)}


def dense_shapes():
    """The calls of every dense and MoE arch after yi-6b (llama3-70b's heads
    at llama3-8b's turns) and of the long-context phase: ``(flash, decode,
    identity)``, flash and decode ``{label: case}`` with each shape once and
    its label naming every call that gives it (the MoE archs' are
    nemotron-4-15b's), identity the pairs of each arch's cold prefill with
    its turn-2 hit and of the long-context prefill with its last
    ``LONG_ROWS`` rows."""
    flash, decode, identity = {}, {}, []
    for arch in DENSE + MOE + tuple(HEADS_ONLY):
        conversation = HEADS_ONLY.get(arch)
        f, d = main_path_shapes(get_config(arch), conversation)
        for label, case in f.items():
            flash.setdefault(case, []).append(f"{arch} {label}")
        decode.setdefault(d["turn 2"], []).append(f"{arch} turn 2")
        pair = (f["cold"], serve.FULL_TURNS[conversation or arch][0])
        if pair not in identity:
            identity.append(pair)
    f, d = long_context_shapes(get_config(LONG))
    for label, case in f.items():
        flash.setdefault(case, []).append(f"{LONG} long context {label}")
    decode.setdefault(d["step"], []).append(f"{LONG} long context step")
    identity.append((f["prefill"], LONG_PREFILL - LONG_ROWS))
    return ({", ".join(v): k for k, v in flash.items()},
            {", ".join(v): k for k, v in decode.items()}, identity)


def vision_positions(grid_h: int, grid_w: int, text: int, device=None):
    """M-RoPE ids (1, grid_h·grid_w + text, 3) int64 in Qwen2-VL's layout for
    one image of ``grid_h`` x ``grid_w`` patches, then ``text`` tokens: patch
    ``i`` at (0, i // grid_w, i % grid_w), text token ``j`` at
    max(grid_h, grid_w) + j in all three ids (one past the largest id of
    the image)."""
    i = torch.arange(grid_h * grid_w, device=device)
    vis = torch.stack([torch.zeros_like(i), i // grid_w, i % grid_w], dim=-1)
    txt = (max(grid_h, grid_w) + torch.arange(text, device=device))[:, None]
    return torch.cat([vis, txt.expand(text, 3)])[None]


def vision_shapes(cfg):
    """The vision model phase's calls: flash for the prefill of
    ``cfg.vision_tokens`` patches and ``VISION_TEXT`` tokens and for
    ``forward`` of ``VISION_STEPS`` tokens more; decode at each step, over
    a ring of ``VISION_MAX_LEN`` slots."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    win, W = tt.attn_window(cfg), tt.cache_width(cfg, VISION_MAX_LEN)
    S, n = cfg.vision_tokens + VISION_TEXT, VISION_STEPS
    flash = {"prefill": (1, H, KV, S, S, hd, 0, win, True),
             "forward": (1, H, KV, S + n, S + n, hd, 0, win, True)}
    return flash, {f"step {i + 1}": ring_case(cfg, W, S + i, win) for i in range(n)}


def encdec_shapes(cfg):
    """The enc-dec model phase's calls. Flash: the encoder over the
    ``source_len`` frames (bidirectional, in the prefill and in
    ``forward``); the decoder's self-attention and cross-attention over the
    ``ENCDEC_TARGET`` tokens of the prefill and the ``ENCDEC_STEPS`` more of
    ``forward``. Decode: the last step's self-attention over its ring of
    ``ENCDEC_MAX_LEN`` slots and its cross-attention over every frame."""
    H, KV, hd, src = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.source_len
    win, W = tt.attn_window(cfg), tt.cache_width(cfg, ENCDEC_MAX_LEN)
    T, n = ENCDEC_TARGET, ENCDEC_STEPS
    flash = {"encoder": (1, H, KV, src, src, hd, 0, None, False),
             "self": (1, H, KV, T, T, hd, 0, win, True),
             "cross": (1, H, KV, T, src, hd, 0, None, False),
             "forward self": (1, H, KV, T + n, T + n, hd, 0, win, True),
             "forward cross": (1, H, KV, T + n, src, hd, 0, None, False)}
    decode = {"self": ring_case(cfg, W, T + n - 1, win),
              "cross": (1, H, KV, src, hd, src, 0)}
    return flash, decode


def family_shapes():
    """The calls of the vlm and encdec paths: qwen2-vl-2b's conversation
    (turn 1, turn 2, the cold prefill, the last decode step), the vision
    model phase's and the enc-dec model phase's, as ``(flash, decode,
    identity)`` in ``dense_shapes``'s form; identity pairs qwen2-vl-2b's
    cold prefill with its turn-2 hit."""
    vlm, encdec = get_config(VLM), get_config(ENCDEC)
    f, d = main_path_shapes(vlm)
    vf, vd = vision_shapes(vlm)
    ef, ed = encdec_shapes(encdec)
    flash = {**{f"{VLM} {k}": v for k, v in f.items()},
             **{f"{VLM} vision {k}": v for k, v in vf.items()},
             **{f"{ENCDEC} {k}": v for k, v in ef.items()}}
    decode = {**{f"{VLM} {k}": v for k, v in d.items()},
              **{f"{VLM} vision {k}": v for k, v in vd.items()},
              **{f"{ENCDEC} {k}": v for k, v in ed.items()}}
    return flash, decode, [(f["cold"], serve.FULL_TURNS[VLM][0])]
