"""TriviaQA-style document-comprehension workload.

Documents average 5880 context tokens (paper Fig 4b); access skew follows a
Zipf distribution (paper §6.1): α=0.4 → 10 % of documents receive ~25 % of
prompts; α=0.7 → ~50 %. The 8k window truncates longer documents.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from repro_torch.workloads.request import Request

CONTEXT_WINDOW = 8192


class DocumentWorkload:
    def __init__(self, seed: int = 0, num_docs: int = 20000,
                 zipf_alpha: float = 0.4, mean_doc_tokens: float = 5880.0,
                 mean_question_tokens: float = 35.0,
                 mean_answer_tokens: float = 60.0, load_scale: float = 1.0,
                 prefix: bool = False, num_sys_prompts: int = 4,
                 mean_sys_tokens: float = 600.0):
        """``load_scale`` widens the document corpus for cluster scenarios
        (N replicas at N× rate query N× the documents, preserving the Zipf
        reuse skew per unit of traffic).

        ``prefix=True`` emits structured prefix segments — RAG-style
        [system prompt][document]: the system-prompt block comes from a
        small shared pool (assigned per document, deterministically), so
        a radix store shares one copy across the whole corpus slice. The
        default stream is byte-identical to the legacy workload."""
        self.rng = np.random.default_rng(seed)
        self.alpha = zipf_alpha
        self.num_docs = num_docs = max(int(num_docs * load_scale), 1)
        sigma = 0.55
        mu = np.log(mean_doc_tokens) - sigma ** 2 / 2
        self.doc_len = np.clip(
            self.rng.lognormal(mu, sigma, size=num_docs).astype(int),
            400, CONTEXT_WINDOW - 128)
        w = 1.0 / np.arange(1, num_docs + 1) ** zipf_alpha
        self.probs = w / w.sum()
        # shuffle so popularity is not correlated with length
        self.order = self.rng.permutation(num_docs)
        self.mean_q = mean_question_tokens
        self.mean_a = mean_answer_tokens
        self.prefix = bool(prefix)
        self.num_sys = int(num_sys_prompts)
        if self.prefix:
            s2 = 0.3
            mu2 = np.log(mean_sys_tokens) - s2 ** 2 / 2
            self.sys_tokens = np.maximum(
                self.rng.lognormal(mu2, s2, size=self.num_sys).astype(int),
                64)
        self._rid = 0
        self._visits = np.zeros(num_docs, dtype=int)

    def _prefix_fields(self, doc: int, dl: int) -> dict:
        """Structured [system prompt][document] segments for ``doc``; the
        question is the unique per-request tail (never a cached block)."""
        if not self.prefix:
            return {}
        sid = doc % self.num_sys
        sys = int(self.sys_tokens[sid])
        return {"prefix_blocks": (f"dsys-{sid}", f"doc-{doc}"),
                "block_tokens": (sys, int(dl))}

    def _lognormal(self, mean: float, sigma: float = 0.5) -> int:
        mu = np.log(mean) - sigma ** 2 / 2
        return max(4, int(self.rng.lognormal(mu, sigma)))

    def sample(self, arrival: float) -> Request:
        rank = self.rng.choice(self.num_docs, p=self.probs)
        doc = int(self.order[rank])
        self._visits[doc] += 1
        q = self._lognormal(self.mean_q)
        a = self._lognormal(self.mean_a)
        extra = self._prefix_fields(doc, int(self.doc_len[doc]))
        ctx = sum(extra["block_tokens"]) if extra else int(self.doc_len[doc])
        req = Request(rid=self._rid, arrival=arrival,
                      context_key=f"doc-{doc}",
                      context_tokens=int(ctx),
                      new_tokens=int(q), output_tokens=int(a),
                      turn=int(self._visits[doc]), **extra)
        self._rid += 1
        return req

    def sample_batch(self, arrivals: Sequence[float]) -> List[Request]:
        """Vectorized ``sample``: one Zipf draw over the corpus per batch
        instead of per request — ``Generator.choice`` with a probability
        vector is O(num_docs) per call, which made scalar sampling the
        document-workload bottleneck. Statistically identical stream
        (same marginals, same Zipf skew), not draw-for-draw equal."""
        n = len(arrivals)
        if n == 0:
            return []
        ranks = self.rng.choice(self.num_docs, size=n, p=self.probs)
        docs = self.order[ranks]
        qs = self._lognormal_batch(self.mean_q, n)
        as_ = self._lognormal_batch(self.mean_a, n)
        doc_lens = self.doc_len[docs]
        reqs: List[Request] = []
        for arrival, doc, dl, q, a in zip(arrivals, docs.tolist(),
                                          doc_lens.tolist(), qs.tolist(),
                                          as_.tolist()):
            self._visits[doc] += 1
            extra = self._prefix_fields(doc, int(dl))
            ctx = sum(extra["block_tokens"]) if extra else int(dl)
            reqs.append(Request(rid=self._rid, arrival=float(arrival),
                                context_key=f"doc-{doc}",
                                context_tokens=int(ctx), new_tokens=q,
                                output_tokens=a,
                                turn=int(self._visits[doc]), **extra))
            self._rid += 1
        return reqs

    def _lognormal_batch(self, mean: float, n: int,
                         sigma: float = 0.5) -> np.ndarray:
        mu = np.log(mean) - sigma ** 2 / 2
        return np.maximum(self.rng.lognormal(mu, sigma, size=n).astype(int),
                          4)
