"""Real-execution serving: a PyTorch model behind the GreenCache store.

Port of ``repro/serving/realexec.py``. The paper's mechanism for a
transformer (dense, MoE or Qwen2-VL, as the reference routes only ``ssm``
and ``hybrid`` to the state snapshot), run for real on the card:

1. look the context up in the KV store;
2. restore the stored prefix K/V;
3. prefill only the uncached suffix, with flash-attention queries at
   ``q_offset = prefix_len`` against the restored keys/values;
4. store the prompt's cache back, so the next turn reuses it;
5. greedy-decode against the ring cache, one decode-attention launch per
   layer and token.

One difference from the reference is forced by PyTorch: the reference
stores the whole cache object as the payload and slices ``[:prefix_len]`` of
it on a hit, which is safe because JAX arrays are immutable. Here decode
writes the cache in place, so the payload is a clone of the prompt's first
``min(n, W)`` slots: exactly the bytes the store accounts for while the
prompt fits the ring. That slice holds the prefix in order only while the
ring has not wrapped (the reference assumes the same and would read
scrambled positions), so a hit whose stored prefix is longer than the cache
width ``W`` raises.

A Qwen2-VL model is served on its token path only, as the reference serves
it: the engine passes ``{"tokens": ...}`` and nothing else, so there are no
vision tokens and every layer takes ``apply_rope`` in the prefill, and
``decode_step``'s default M-RoPE ids (``pos`` in all three), which give the
same rotation.

An enc-dec model is refused at construction: the reference's engine passes
no ``frames``, and its ``prefill`` fails on it with ``KeyError: 'frames'``.
Enc-dec runs through the model functions (``init_cache``, ``prefill``,
``decode_step``, ``forward``) only.

A recurrent model (RWKV6, Griffin) caches a snapshot of its state
instead, as the reference does (``realexec.py:87-122``): on a hit the state
after the stored prefix is restored, and every uncached prompt token (all of
them on a miss) is fed through ``decode_step`` (per layer and token one
wkv6 launch for RWKV6; for Griffin one fused rglru step per recurrent layer and
one decode-attention launch per unit); then ``num_new`` decode steps. A
Griffin state is nested (``units``, ``tail``) and holds the local-attention
rings beside the recurrent states. The reference stores the cache object
itself and relies on JAX's immutability; ``decode_step`` here updates the
state in place, so the payload is a clone of the whole state after the
prompt and a hit resumes from a clone of the payload. A hit whose stored prefix is
the whole prompt leaves no token to feed and so no logits: the reference
fails there at ``argmax`` of ``None``, the port raises ``ValueError``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.kvstore import KVStore
from repro_torch.models.transformer import (cache_width, decode_step,
                                            init_cache, prefill)


def _clone(tree):
    """A copy of a (nested) dict of tensors."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; never falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for and no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def check_servable(cfg: ModelConfig):
    """Raises ``ValueError`` for a family the engine does not serve (enc-dec)."""
    if cfg.family == "encdec":
        raise ValueError(
            f"{cfg.name}: the engine serves no enc-dec model; the reference's "
            "fails on one (KeyError: 'frames', as it passes no frames to "
            "prefill). Run enc-dec through the model functions init_cache, "
            "prefill, decode_step and forward")


@dataclass
class GenerationResult:
    tokens: List[int]
    prefill_tokens_computed: int      # uncached tokens actually prefilled
    reused_tokens: int
    prefill_time_s: float
    decode_time_s: float
    last_logits: Optional[torch.Tensor] = None   # last prompt position, fp32


class RealExecutionEngine:
    def __init__(self, cfg: ModelConfig, params, store: KVStore, *,
                 max_len: int = 512, dtype=torch.float32, device=None):
        check_servable(cfg)
        self.device = resolve_device(device)
        embed = params["embed"]
        if embed.device.type != self.device.type or embed.dtype != dtype:
            raise ValueError(f"params are {embed.dtype} on {embed.device}; the "
                             f"engine runs {dtype} on {self.device}")
        self.cfg = cfg
        self.params = params
        self.store = store
        self.max_len = max_len
        self.dtype = dtype
        self.width = cache_width(cfg, max_len)
        self.recurrent = cfg.family in ("ssm", "hybrid")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _token_ids(self, tokens: List[int]):
        return torch.tensor(tokens, dtype=torch.long, device=self.device)[None]

    def _argmax(self, logits) -> int:
        return int(torch.argmax(logits[0, -1, :self.cfg.vocab_size]))

    def _feed(self, prompt_tokens: List[int], prefix_len: int, prefix_cache):
        """State-snapshot route: resume from a clone of the stored state (or
        the empty state) and feed the uncached tokens one at a time."""
        if prefix_cache is not None:
            cache = _clone(prefix_cache)
        else:
            cache = init_cache(self.cfg, 1, self.max_len, self.dtype, self.device)
        for pos in range(prefix_len, len(prompt_tokens)):
            logits, cache = decode_step(self.params, self.cfg, cache,
                                        self._token_ids([prompt_tokens[pos]]), pos)
        return logits, cache

    # ------------------------------------------------------------------ #
    @torch.inference_mode()
    def generate(self, context_key: str, prompt_tokens: List[int],
                 num_new: int = 8, now: Optional[float] = None
                 ) -> GenerationResult:
        """Serve one request: reuse the cached prefix KV (or recurrent state)
        for ``context_key`` if present, compute the suffix, then
        greedy-decode ``num_new``."""
        n = len(prompt_tokens)
        now = time.time() if now is None else now
        entry = self.store.lookup(context_key, n, now)
        prefix_len = 0
        prefix_cache = None
        if entry is not None and entry.payload is not None:
            plen, pcache = entry.payload
            if plen <= n:
                if plen > self.width and not self.recurrent:
                    raise ValueError(
                        f"stored prefix of {plen} tokens exceeds the cache width "
                        f"{self.width}: its ring has wrapped and no longer holds "
                        "the prefix in order")
                prefix_len, prefix_cache = plen, pcache

        if self.recurrent and prefix_len == n:
            raise ValueError(
                f"{context_key!r}: the stored state covers all {n} prompt tokens, "
                "so no token is left to feed and there are no logits to decode "
                "from (the reference fails here too)")

        self._sync()
        t0 = time.perf_counter()
        if self.recurrent:
            logits, cache = self._feed(prompt_tokens, prefix_len, prefix_cache)
        else:
            logits, cache = prefill(
                self.params, self.cfg,
                {"tokens": self._token_ids(prompt_tokens[prefix_len:])},
                self.max_len, prefix_cache=prefix_cache, prefix_len=prefix_len)
        tok = self._argmax(logits)
        self._sync()
        t_prefill = time.perf_counter() - t0
        last_logits = logits[0, -1, :self.cfg.vocab_size].float()

        # store the prompt's cache back (extends the prefix entry): a clone,
        # because decode below writes ``cache`` in place
        if self.recurrent:
            snapshot = _clone(cache)
        else:
            snapshot = {k: t[:, :, :min(n, self.width)].clone()
                        for k, t in cache.items()}
        self.store.insert(context_key, n, now, payload=(n, snapshot))

        # greedy decode
        t1 = time.perf_counter()
        out = []
        pos = n
        for _ in range(num_new):
            out.append(tok)
            logits, cache = decode_step(self.params, self.cfg, cache,
                                        self._token_ids([tok]), pos)
            pos += 1
            tok = self._argmax(logits)
        self._sync()
        return GenerationResult(
            tokens=out,
            prefill_tokens_computed=n - prefix_len,
            reused_tokens=prefix_len,
            prefill_time_s=t_prefill,
            decode_time_s=time.perf_counter() - t1,
            last_logits=last_logits)
