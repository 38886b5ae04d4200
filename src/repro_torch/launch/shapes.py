"""The calls each served path gives the two attention kernels, computed from
the configs and the turns of ``serve.FULL_TURNS``.

``chip_smoke.py`` holds the kernels against their plain versions at these
shapes on the card and ``tests/test_torch_gpu.py`` takes the same rows, so
the list lives here once. Flash shapes are ``cases``' flash cases, decode
shapes its decode cases; an identity pair is ``(cold case, first hit row)``
as in ``cases.FLASH_IDENTITY``.
"""
from __future__ import annotations

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
