"""Workload generators of the simulator: request streams, rate and carbon
intensity traces, and the multi-tenant tiers.

The reference's agent loops and event scenarios belong to the controller's
day and are not here yet.
"""
from typing import List, Sequence

from repro_torch.workloads.traces import (azure_rate_trace, ci_trace,
                                          make_poisson_arrivals)
from repro_torch.workloads.conversations import ConversationWorkload
from repro_torch.workloads.documents import DocumentWorkload
from repro_torch.workloads.request import Request
from repro_torch.workloads.tenants import (DEFAULT_TIER, TIERS,
                                           MultiTenantWorkload, TierSpec,
                                           multi_tenant, normalize_shares,
                                           tier_slo, tier_spec)


def sample_many(workload, arrivals: Sequence[float]) -> List[Request]:
    """Draw one request per arrival, using the workload's vectorized
    ``sample_batch`` fast path when it has one (both built-in generators
    do — ~3x faster day-scale simulation) and falling back to scalar
    ``sample`` calls for custom generators."""
    batch = getattr(workload, "sample_batch", None)
    if batch is not None:
        return batch(arrivals)
    return [workload.sample(float(t)) for t in arrivals]


__all__ = ["azure_rate_trace", "ci_trace", "make_poisson_arrivals",
           "ConversationWorkload", "DocumentWorkload",
           "Request", "sample_many",
           # multi-tenant tiers
           "TierSpec", "TIERS", "DEFAULT_TIER", "tier_spec", "tier_slo",
           "normalize_shares", "MultiTenantWorkload", "multi_tenant"]
