from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class Request:
    rid: int
    arrival: float              # seconds
    context_key: str            # conversation/document id (cache key)
    context_tokens: int         # reusable prefix length (history / document)
    new_tokens: int             # tokens unique to this request
    output_tokens: int
    turn: int = 1               # conversation turn / question index

    # structured prefix segments (content-addressed block keys, outermost
    # first — system prompt x document x turn history) covering the
    # reusable context; ``block_tokens`` is the parallel token count per
    # block (sums to ``context_tokens``). Empty = whole-context keying
    # only. When ``context_key`` is given empty, it is derived from the
    # blocks (the legacy whole-context key of the full path).
    prefix_blocks: Tuple[str, ...] = ()
    block_tokens: Tuple[int, ...] = ()

    # multi-tenant identity ("" = anonymous single-tenant traffic) and
    # SLO tier — one of repro_torch.workloads.tenants.TIERS. The default
    # "standard" keeps un-stamped streams on the legacy single-tier
    # engine/solver paths.
    tenant: str = ""
    tier: str = "standard"

    # filled by the engine
    reused_tokens: int = 0
    ttft: float = 0.0
    tpot: float = 0.0
    energy_kwh: float = 0.0

    def __post_init__(self):
        if self.prefix_blocks:
            if len(self.prefix_blocks) != len(self.block_tokens):
                raise ValueError("prefix_blocks and block_tokens must be "
                                 "parallel sequences")
            if not self.context_key:
                self.context_key = "/".join(self.prefix_blocks)

    @property
    def prompt_tokens(self) -> int:
        return self.context_tokens + self.new_tokens

    @property
    def prefix_segments(self) -> Optional[Tuple[Tuple[str, int], ...]]:
        """``((block_key, num_tokens), ...)`` for prefix-aware stores
        (``CacheStore.account(..., blocks=...)``); None when the request
        carries no structured prefix."""
        if not self.prefix_blocks:
            return None
        return tuple(zip(self.prefix_blocks, self.block_tokens))

    @property
    def route_key(self) -> str:
        """Cache-affinity routing identity: the prefix *root* block when
        structured (shared system prompts land on one replica, so the
        whole tree stays on the partition that owns its root), else the
        whole-context key."""
        return self.prefix_blocks[0] if self.prefix_blocks \
            else self.context_key
