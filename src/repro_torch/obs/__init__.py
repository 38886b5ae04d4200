"""Observability of the simulator — the flight recorder's two parts that
the serving engines reach:

* ``TraceRecorder`` (``repro_torch.obs.trace``) — opt-in columnar
  per-request span recording (preallocated NumPy buffers, no per-request
  Python objects on the hot path).
* ``CarbonLedger`` (``repro_torch.obs.ledger``) — double-entry carbon
  audit: every gram accrued at its source under a (source, category,
  region, tier, tenant) key; each cut must partition the run total
  bit-exactly or ``LedgerError`` raises.

Everything here is read-only with respect to the simulation: with the
recorder detached (the default) every engine and solver path is
bit-identical to running without it. The reference's metrics registry and
streaming percentiles come with the controller's day.
"""
from repro_torch.obs.ledger import CarbonLedger, LedgerError, exact_partition
from repro_torch.obs.trace import SPAN_FIELDS, TraceRecorder

__all__ = [
    "CarbonLedger",
    "LedgerError",
    "SPAN_FIELDS",
    "TraceRecorder",
    "exact_partition",
]
