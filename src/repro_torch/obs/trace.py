"""Columnar per-request tracing — the flight recorder's span store.

``TraceRecorder`` keeps one preallocated NumPy column per span field
and records a whole simulation window in a handful of vectorized array
copies (the columnar idiom of the simulator): no per-request Python
objects are created on the hot path, which keeps the tracing overhead
small (the reference's ``benchmarks/tracing_overhead.py`` gates it).

Each request contributes one row decomposed into spans:

* ``queue_s`` — arrival → prefill start (includes preempt-resume gaps)
* ``prefill_s`` — GPU compute for the uncached suffix
* ``kv_load_s`` — SSD/DRAM KV fetch for the matched prefix
* ``decode_s`` — output_tokens × TPOT
* ``ttft_s`` / ``tpot_s`` — the reported latency metrics
* ``hit_kind``/``hit_tier``/``matched_tokens`` — what the cache did
* ``energy_j`` / ``carbon_g`` — attributed per-request energy and
  operational gCO₂e (window energy split evenly, priced at the window
  CI — the same attribution the ILP uses)

Rare control-plane happenings (plan transitions, replica failures,
preempt-resume, WAN KV migration) land in a small side event table.

Export: ``write_jsonl`` (one JSON object per row — requests then
events) and ``write_chrome`` (Chrome ``trace_event`` JSON: open it in
``chrome://tracing`` / Perfetto; pid = region, tid = replica).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["TraceRecorder", "SPAN_FIELDS", "HIT_KIND_CODES",
           "HIT_KIND_NAMES"]

# int8 codes for the recorded HitKind (UNKNOWN covers paths that cannot
# reconstruct the account result, e.g. the least_loaded router)
HIT_KIND_CODES = {"hit": 0, "partial": 1, "miss": 2, "too_large": 3,
                  "rejected": 4, "unknown": -1}
HIT_KIND_NAMES = {v: k for k, v in HIT_KIND_CODES.items()}

# (name, dtype) of every request-row column, in export order
SPAN_FIELDS = (
    ("rid", np.int64),
    ("arrival_s", np.float64),
    ("region", np.int16),          # interned label index
    ("replica", np.int32),
    ("tier", np.int16),            # interned label index
    ("tenant", np.int32),          # interned label index
    ("hit_kind", np.int8),
    ("hit_tier", np.int8),         # -1 flat/unknown, 0 hot, 1 cold
    ("matched_tokens", np.int32),
    ("prompt_tokens", np.int32),
    ("output_tokens", np.int32),
    ("queue_s", np.float64),
    ("prefill_s", np.float64),
    ("kv_load_s", np.float64),
    ("decode_s", np.float64),
    ("ttft_s", np.float64),
    ("tpot_s", np.float64),
    ("energy_j", np.float64),
    ("carbon_g", np.float64),
)


class _Interner:
    """Label string <-> small int, stable in first-seen order."""

    def __init__(self):
        self.index: Dict[str, int] = {}
        self.labels: List[str] = []

    def __call__(self, label: str) -> int:
        i = self.index.get(label)
        if i is None:
            i = self.index[label] = len(self.labels)
            self.labels.append(label)
        return i

    def many(self, labels: Sequence[str]) -> np.ndarray:
        return np.fromiter((self(x) for x in labels), np.int32,
                           count=len(labels))


class TraceRecorder:
    """Opt-in columnar span recorder.

    Attach to engines via ``GreenCacheController(trace=...)`` or
    ``engine.recorder = TraceRecorder()``; detached (``None``) engines
    skip every recording branch, which is the bit-identity contract.
    """

    def __init__(self, capacity: int = 8192):
        self.capacity = max(int(capacity), 16)
        self.n = 0
        self._cols = {name: np.zeros(self.capacity, dtype=dt)
                      for name, dt in SPAN_FIELDS}
        self.regions = _Interner()
        self.tiers = _Interner()
        self.tenants = _Interner()
        # rare control-plane events: list of small dicts (transitions,
        # failures, preemptions, WAN migrations — O(events), not O(reqs))
        self.events: List[Dict] = []

    # ------------------------------------------------------------------ #
    def _grow(self, need: int):
        cap = self.capacity
        while cap < self.n + need:
            cap *= 2
        if cap != self.capacity:
            for name, col in self._cols.items():
                ext = np.zeros(cap, dtype=col.dtype)
                ext[:self.n] = col[:self.n]
                self._cols[name] = ext
            self.capacity = cap

    def record_window(self, *, rids, arrival, ttft, tpot,
                      prefill_s, kv_load_s, queue_s,
                      prompt_tokens, output_tokens, matched_tokens,
                      hit_kind, hit_tier=None, replica=None,
                      energy_j_per_req: float = 0.0,
                      ci_g_per_kwh: float = 0.0,
                      region: str = "",
                      tiers: Optional[Sequence[str]] = None,
                      tenants: Optional[Sequence[str]] = None):
        """Record one simulated window's request stream from the
        engine's existing arrays — a handful of vectorized column
        copies, no per-request Python objects."""
        k = len(arrival)
        if k == 0:
            return
        self._grow(k)
        s = slice(self.n, self.n + k)
        c = self._cols
        c["rid"][s] = rids
        c["arrival_s"][s] = arrival
        c["region"][s] = self.regions(region)
        c["replica"][s] = 0 if replica is None else replica
        c["tier"][s] = 0 if tiers is None else self.tiers.many(tiers)
        if tiers is None:
            self.tiers("")          # keep index 0 = the untier label
        c["tenant"][s] = 0 if tenants is None \
            else self.tenants.many(tenants)
        if tenants is None:
            self.tenants("")
        c["hit_kind"][s] = hit_kind
        c["hit_tier"][s] = -1 if hit_tier is None else hit_tier
        c["matched_tokens"][s] = matched_tokens
        c["prompt_tokens"][s] = prompt_tokens
        c["output_tokens"][s] = output_tokens
        c["queue_s"][s] = queue_s
        c["prefill_s"][s] = prefill_s
        c["kv_load_s"][s] = kv_load_s
        c["decode_s"][s] = np.asarray(output_tokens) * np.asarray(tpot)
        c["ttft_s"][s] = ttft
        c["tpot_s"][s] = tpot
        c["energy_j"][s] = energy_j_per_req
        c["carbon_g"][s] = (energy_j_per_req / 3.6e6) * ci_g_per_kwh
        self.n += k

    def record_event(self, kind: str, ts: float, *, region: str = "",
                     **attrs):
        """Control-plane event (transition, failure, preempt, WAN
        migration) — rare, so a plain dict row is fine."""
        ev = {"kind": str(kind), "ts": float(ts), "region": str(region)}
        ev.update(attrs)
        self.events.append(ev)

    # ------------------------------------------------------------------ #
    def column(self, name: str) -> np.ndarray:
        """Live view of one column's recorded prefix."""
        return self._cols[name][:self.n]

    def percentile(self, name: str, q) -> float:
        col = self.column(name)
        if not len(col):
            return 0.0
        return float(np.percentile(col, q))

    def percentiles(self, name: str,
                    qs: Sequence[float] = (50, 95, 99)) -> Dict[str, float]:
        return {f"p{int(q)}": self.percentile(name, q) for q in qs}

    # ------------------------------------------------------------------ #
    def rows(self):
        """Iterate request rows as plain dicts (export path only)."""
        c = self._cols
        for i in range(self.n):
            row = {}
            for name, _ in SPAN_FIELDS:
                v = c[name][i]
                row[name] = v.item()
            row["region"] = self.regions.labels[int(c["region"][i])] \
                if self.regions.labels else ""
            row["tier"] = self.tiers.labels[int(c["tier"][i])] \
                if self.tiers.labels else ""
            row["tenant"] = self.tenants.labels[int(c["tenant"][i])] \
                if self.tenants.labels else ""
            row["hit_kind"] = HIT_KIND_NAMES.get(int(c["hit_kind"][i]),
                                                 "unknown")
            yield row

    def write_jsonl(self, path: str):
        """One JSON object per line: request span rows (``type:
        "request"``), then control-plane events (``type: "event"``)."""
        with open(path, "w") as f:
            for row in self.rows():
                row["type"] = "request"
                f.write(json.dumps(row) + "\n")
            for ev in self.events:
                out = dict(ev)
                out["type"] = "event"
                f.write(json.dumps(out) + "\n")

    def write_chrome(self, path: str):
        """Chrome ``trace_event`` export: complete ("X") events per
        span, pid = region, tid = replica; timestamps in µs.  Per-span
        energy splits the request's attributed energy proportionally to
        span duration."""
        events = []
        for row in self.rows():
            pid = row["region"] or "site"
            tid = int(row["replica"])
            t = row["arrival_s"]
            spans = [("queue", row["queue_s"]),
                     ("kv_load", row["kv_load_s"]),
                     ("prefill", row["prefill_s"]),
                     ("decode", row["decode_s"])]
            total = sum(d for _, d in spans) or 1.0
            for name, dur in spans:
                if dur <= 0.0:
                    continue
                events.append({
                    "name": name, "ph": "X", "pid": pid, "tid": tid,
                    "ts": t * 1e6, "dur": dur * 1e6,
                    "args": {"rid": row["rid"],
                             "hit": row["hit_kind"],
                             "tier": row["tier"],
                             "matched_tokens": row["matched_tokens"],
                             "energy_j": row["energy_j"] * dur / total,
                             "carbon_g": row["carbon_g"] * dur / total},
                })
                t += dur
        for ev in self.events:
            events.append({"name": ev["kind"], "ph": "i",
                           "pid": ev.get("region") or "site", "tid": 0,
                           "ts": ev["ts"] * 1e6, "s": "g",
                           "args": {k: v for k, v in ev.items()
                                    if k not in ("kind", "ts")}})
        with open(path, "w") as f:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, f)

    # ------------------------------------------------------------------ #
    def summary(self) -> Dict:
        """Aggregate view (what ``tools/trace_report.py`` renders)."""
        n = self.n
        out: Dict = {"requests": n, "events": len(self.events)}
        if not n:
            return out
        hk = self.column("hit_kind")
        out["hits"] = {name: int((hk == code).sum())
                       for name, code in HIT_KIND_CODES.items()
                       if int((hk == code).sum())}
        out["matched_tokens"] = int(self.column("matched_tokens").sum())
        out["prompt_tokens"] = int(self.column("prompt_tokens").sum())
        out["energy_kwh"] = float(self.column("energy_j").sum()) / 3.6e6
        out["carbon_g"] = float(self.column("carbon_g").sum())
        out["ttft"] = self.percentiles("ttft_s")
        out["tpot"] = self.percentiles("tpot_s")
        for k in ("queue_s", "prefill_s", "kv_load_s", "decode_s"):
            out[k] = float(self.column(k).sum())
        ev_kinds: Dict[str, int] = {}
        for ev in self.events:
            ev_kinds[ev["kind"]] = ev_kinds.get(ev["kind"], 0) + 1
        if ev_kinds:
            out["event_kinds"] = ev_kinds
        return out
