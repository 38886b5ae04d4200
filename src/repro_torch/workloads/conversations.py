"""ShareGPT-style multi-turn conversation workload.

Matched statistics (paper Fig 4a): context length varies by turn; 77.2 % of
prompts carry > 1000 context tokens; conversations average ~9 turns; the
8k-token context window truncates long histories (paper §6.1).

With ``prefix=True`` every request additionally carries structured prefix
segments (``Request.prefix_blocks``): a *system prompt* block drawn from a
small shared pool (the cross-conversation sharing a whole-context key can
never express) followed by one content-addressed block per retained history
turn. Window truncation drops the oldest turns, which moves the blocks'
tree position — a realistic prefix break that radix caching pays for and
whole-context keying hides. The default (``prefix=False``) stream is
byte-identical to the legacy workload, draw for draw.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.workloads.request import Request

CONTEXT_WINDOW = 8192


@dataclass
class _Conv:
    cid: int
    total_turns: int
    turn: int = 0
    context: int = 0            # accumulated history tokens
    # prefix mode: shared system prompt id, absolute index of the first
    # retained history turn, and tokens per retained turn (oldest first)
    sys_id: int = 0
    start: int = 1
    hist: List[int] = field(default_factory=list)
    hist_tokens: int = 0


class ConversationWorkload:
    """Stateful generator: each sample picks an active conversation and emits
    its next turn (the context is the whole prior history — the cacheable
    prefix)."""

    def __init__(self, seed: int = 0, active_pool: int = 12000,
                 mean_turns: float = 16.0, mean_user_tokens: float = 150.0,
                 mean_reply_tokens: float = 500.0, load_scale: float = 1.0,
                 prefix: bool = False, num_sys_prompts: int = 6,
                 mean_sys_tokens: float = 1100.0):
        """``load_scale`` widens the active-conversation pool for cluster
        scenarios: N replicas serving N× the request rate should draw from
        N× the concurrent users, keeping per-context reuse statistics (and
        thus achievable hit rates) comparable to the single-server case.

        ``prefix=True`` emits structured prefix segments: a system-prompt
        block shared across the whole pool (``num_sys_prompts`` prompts,
        lognormal around ``mean_sys_tokens``) plus one block per retained
        history turn."""
        self.rng = np.random.default_rng(seed)
        self.active_pool = max(int(active_pool * load_scale), 1)
        self.mean_turns = mean_turns
        self.mean_user = mean_user_tokens
        self.mean_reply = mean_reply_tokens
        self.prefix = bool(prefix)
        self.num_sys = int(num_sys_prompts)
        if self.prefix:
            sigma = 0.3
            mu = np.log(mean_sys_tokens) - sigma ** 2 / 2
            self.sys_tokens = np.maximum(
                self.rng.lognormal(mu, sigma, size=self.num_sys).astype(int),
                64)
        self._convs: List[_Conv] = []
        self._next_cid = 0
        self._rid = 0

    def _new_conv(self, midlife: bool = False) -> _Conv:
        turns = 1 + self.rng.geometric(1.0 / self.mean_turns)
        c = _Conv(cid=self._next_cid, total_turns=int(turns))
        self._next_cid += 1
        if midlife:
            # stationary bootstrap: the pool starts with conversations
            # already in progress (uniform position within their lifetime)
            c.turn = int(self.rng.integers(0, max(int(turns), 1)))
            per_turn = self.mean_user + self.mean_reply
            ctx = c.turn * per_turn * float(self.rng.uniform(0.6, 1.4))
            c.context = int(min(ctx, CONTEXT_WINDOW))
        if self.prefix:
            c.sys_id = int(self.rng.integers(self.num_sys))
            if midlife and c.turn > 0:
                per = max(int(c.context / c.turn), 1)
                c.hist = [per] * c.turn
                c.hist_tokens = per * c.turn
                self._truncate(c, 0)
        return c

    def _truncate(self, c: _Conv, user: int):
        """Window truncation, block-granular: drop the oldest history
        turns until system prompt + history + the new user message fit."""
        sys = int(self.sys_tokens[c.sys_id])
        while c.hist and sys + c.hist_tokens > CONTEXT_WINDOW - user:
            c.hist_tokens -= c.hist.pop(0)
            c.start += 1

    def _emit_prefix(self, c: _Conv, arrival: float, user: int,
                     out: int) -> Request:
        """One structured-prefix turn: [system prompt][retained history
        turns] is the cacheable context; the user message is the unique
        tail (cached only once the turn enters the history)."""
        self._truncate(c, user)
        sys = int(self.sys_tokens[c.sys_id])
        blocks: Tuple[str, ...] = (f"sys-{c.sys_id}",) + tuple(
            f"conv-{c.cid}:t{j}"
            for j in range(c.start, c.start + len(c.hist)))
        toks = (sys,) + tuple(c.hist)
        req = Request(rid=self._rid, arrival=float(arrival),
                      context_key=f"conv-{c.cid}",
                      context_tokens=int(sys + c.hist_tokens),
                      new_tokens=int(user), output_tokens=int(out),
                      turn=c.turn, prefix_blocks=blocks, block_tokens=toks)
        self._rid += 1
        # this turn's history block (user message + reply) becomes part of
        # the next turn's cacheable prefix
        c.hist.append(int(user + out))
        c.hist_tokens += int(user + out)
        c.context = min(c.context + user + out, CONTEXT_WINDOW)
        return req

    def _lognormal(self, mean: float, sigma: float = 0.6) -> int:
        mu = np.log(mean) - sigma ** 2 / 2
        return max(4, int(self.rng.lognormal(mu, sigma)))

    def sample(self, arrival: float) -> Request:
        while len(self._convs) < self.active_pool:
            self._convs.append(self._new_conv(midlife=True))
        i = int(self.rng.integers(len(self._convs)))
        c = self._convs[i]
        c.turn += 1

        user = self._lognormal(self.mean_user)
        out = self._lognormal(self.mean_reply)
        if self.prefix:
            req = self._emit_prefix(c, arrival, user, out)
        else:
            context = min(c.context, CONTEXT_WINDOW - user)
            req = Request(rid=self._rid, arrival=arrival,
                          context_key=f"conv-{c.cid}",
                          context_tokens=int(context), new_tokens=int(user),
                          output_tokens=int(out), turn=c.turn)
            self._rid += 1
            c.context = min(c.context + user + out, CONTEXT_WINDOW)
        if c.turn >= c.total_turns:
            self._convs[i] = self._new_conv()
        return req

    def sample_batch(self, arrivals: Sequence[float]) -> List[Request]:
        """Vectorized ``sample``: the per-request random draws (pool pick,
        user/reply lengths) come from three batched generator calls
        instead of 3·n scalar calls — the generator-dispatch overhead was
        the ``run_day`` wall-clock bottleneck (~44 µs/request). The
        conversation state machine itself stays sequential (a retired
        conversation's slot must be replaced before a later pick can land
        on it), so the stream is statistically identical to — but not
        draw-for-draw the same as — repeated ``sample`` calls. Prefix
        mode adds no per-request draws (the system-prompt pool is drawn
        at construction, block bookkeeping is deterministic)."""
        n = len(arrivals)
        if n == 0:
            return []
        while len(self._convs) < self.active_pool:
            self._convs.append(self._new_conv(midlife=True))
        picks = self.rng.integers(len(self._convs), size=n)
        users = self._lognormal_batch(self.mean_user, n)
        outs = self._lognormal_batch(self.mean_reply, n)
        reqs: List[Request] = []
        convs = self._convs
        prefix = self.prefix
        for arrival, i, user, out in zip(arrivals, picks.tolist(),
                                         users.tolist(), outs.tolist()):
            c = convs[i]
            c.turn += 1
            if prefix:
                reqs.append(self._emit_prefix(c, arrival, user, out))
            else:
                context = min(c.context, CONTEXT_WINDOW - user)
                reqs.append(Request(rid=self._rid, arrival=float(arrival),
                                    context_key=f"conv-{c.cid}",
                                    context_tokens=int(context),
                                    new_tokens=user, output_tokens=out,
                                    turn=c.turn))
                self._rid += 1
                c.context = min(c.context + user + out, CONTEXT_WINDOW)
            if c.turn >= c.total_turns:
                convs[i] = self._new_conv()
        return reqs

    def _lognormal_batch(self, mean: float, n: int,
                         sigma: float = 0.6) -> np.ndarray:
        mu = np.log(mean) - sigma ** 2 / 2
        return np.maximum(self.rng.lognormal(mu, sigma, size=n).astype(int),
                          4)
