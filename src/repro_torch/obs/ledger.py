"""Double-entry carbon ledger — the audit half of the flight recorder.

Every gram of CO₂e in a ``RunResult`` is accrued here at its source
under an (hour, category, region, tier, tenant) key, and the ledger
proves — as a *runtime invariant*, not a benchmark row — that each cut
partitions the run total bit-exactly:

* per **category** (operational / embodied-compute / embodied-cache;
  transition energy is a memo inside operational, where the engine
  prices it),
* per **region** (geo runs: the global hour is the left-fold sum of the
  per-region hours, exactly as ``combine_results`` computed it),
* per **tier** and per **tenant** (the functional-unit and chargeback
  cuts).

Float addition is not associative, so "bit-exact partition" is enforced
the way the engine's own chargeback does it (``SimResult.per_tenant``):
each partition may carry an ulp-scale *reconciliation residual*, folded
into its final key until the left-fold sum lands exactly on the total.
The fold is tolerance-gated: a residual beyond ``rel_tol`` is not
rounding — it is a dropped array, a mispriced component, or a
non-converging fold — and raises ``LedgerError``
instead of being papered over.

``CarbonLedger.from_run(result)`` builds and verifies the ledger for a
finished day; the controller does this automatically at the end of
``run_day`` (``conservation_check=True``, the default).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["CarbonLedger", "LedgerError", "exact_partition"]

AXES = ("category", "region", "tier", "tenant")

# reconciliation tolerance: anything past this is corruption, not float
# dust.  1e-9 relative covers ~6 decimal orders of headroom above the
# worst re-association error of summing a few dozen doubles.
REL_TOL = 1e-9
_FOLD_ITERS = 16


class LedgerError(AssertionError):
    """A carbon partition failed to reproduce its total: some gram was
    dropped, double-counted, or mispriced between the cut and the bill."""


def _lsum(values) -> float:
    """Plain left-fold sum — the association every verifier uses, and
    the one ``sum()``/``combine_results`` produce."""
    total = 0.0
    for v in values:
        total += v
    return total


def exact_partition(total: float, parts: Dict[str, float], *,
                    rel_tol: float = REL_TOL,
                    where: str = "") -> Dict[str, float]:
    """Reconcile ``parts`` so their left-fold sum reproduces ``total``
    bit-exactly, folding the float-rounding residual into the largest
    part (moved to the end of the dict — correcting the final addend
    leaves every earlier partial sum untouched, so the fixed point
    converges in a step or two).

    Raises ``LedgerError`` when the initial residual exceeds ``rel_tol``
    (relative to the partition's scale) — that is not rounding dust but
    a genuinely broken partition — or when the fold fails to converge.
    """
    total = float(total)
    out = {k: float(v) for k, v in parts.items()}
    scale = max(abs(total), _lsum(abs(v) for v in out.values()), 1e-12)
    resid = total - _lsum(out.values())
    if abs(resid) > rel_tol * scale:
        raise LedgerError(
            f"carbon partition{' (' + where + ')' if where else ''} does "
            f"not reproduce its total: parts sum to "
            f"{_lsum(out.values()):.9g}, total is {total:.9g} "
            f"(residual {resid:.3e} > tol {rel_tol * scale:.3e})")
    if resid == 0.0 or not out:
        if not out and total != 0.0:
            raise LedgerError(
                f"empty partition{' (' + where + ')' if where else ''} "
                f"for nonzero total {total:.9g}")
        return out
    # move the largest-|value| key to the end, then fold into it
    sink = max(out, key=lambda k: abs(out[k]))
    out[sink] = out.pop(sink)
    for _ in range(_FOLD_ITERS):
        resid = total - _lsum(out.values())
        if resid == 0.0:
            return out
        out[sink] += resid
    # ``+=`` can stall one ulp away: when the largest part shares the
    # total's exponent, a round-to-even tie can make *no* value of that
    # part land the final addition exactly on ``total``.  Rebuild
    # through the smallest part instead — the rest-fold then sits in
    # [total/2, 2*total], where Sterbenz's lemma makes ``total - rest``
    # exact, so the final addition reproduces ``total`` bit-for-bit.
    small = min(out, key=lambda k: abs(out[k]))
    out[small] = out.pop(small)
    rest = _lsum(list(out.values())[:-1])
    out[small] = total - rest
    if _lsum(out.values()) == total:
        return out
    # last resort (rest outside the Sterbenz window): ulp-walk
    for _ in range(_FOLD_ITERS * 4):
        resid = total - _lsum(out.values())
        if resid == 0.0:
            return out
        out[small] = math.nextafter(out[small], math.copysign(
            math.inf, resid))
    raise LedgerError(
        f"residual fold failed to converge"
        f"{' (' + where + ')' if where else ''}: total {total:.9g}, "
        f"remaining residual {total - _lsum(out.values()):.3e}")


@dataclass
class HourCell:
    """One hour's audited carbon: the hour total plus one reconciled
    partition per axis. Every dict's left-fold sum equals ``total_g``
    bit-exactly (enforced at construction)."""
    hour: int
    total_g: float
    category: Dict[str, float] = field(default_factory=dict)
    region: Dict[str, float] = field(default_factory=dict)
    tier: Dict[str, float] = field(default_factory=dict)
    tenant: Dict[str, float] = field(default_factory=dict)

    def cut(self, axis: str) -> Dict[str, float]:
        if axis not in AXES:
            raise ValueError(f"axis must be one of {AXES}, got {axis!r}")
        return getattr(self, axis)


class CarbonLedger:
    """Per-hour double-entry carbon records with bit-exact partitions.

    ``add_hour`` reconciles (and therefore audits) each axis at accrual
    time; ``verify`` re-proves every invariant afterwards — useful in
    tests that deliberately corrupt a cell to show the error class
    raises.  ``by(axis)`` returns the day-level cut, itself reconciled
    against ``total_g``.
    """

    def __init__(self, *, rel_tol: float = REL_TOL):
        self.rel_tol = float(rel_tol)
        self.hours: List[HourCell] = []

    # ------------------------------------------------------------------ #
    @property
    def total_g(self) -> float:
        return _lsum(c.total_g for c in self.hours)

    def add_hour(self, hour: int, total_g: float, *,
                 category: Optional[Dict[str, float]] = None,
                 region: Optional[Dict[str, float]] = None,
                 tier: Optional[Dict[str, float]] = None,
                 tenant: Optional[Dict[str, float]] = None) -> HourCell:
        """Accrue one hour.  Omitted axes default to a single-key
        partition (the whole hour under one label) — trivially exact.
        Provided axes are reconciled via ``exact_partition`` and raise
        ``LedgerError`` on corruption."""
        total_g = float(total_g)
        cell = HourCell(hour=int(hour), total_g=total_g)
        defaults = {"category": {"operational": total_g},
                    "region": {"site": total_g},
                    "tier": {"all": total_g},
                    "tenant": {"all": total_g}}
        given = {"category": category, "region": region,
                 "tier": tier, "tenant": tenant}
        for axis in AXES:
            parts = given[axis]
            if parts is None:
                parts = defaults[axis]
            setattr(cell, axis, exact_partition(
                total_g, parts, rel_tol=self.rel_tol,
                where=f"hour {hour} {axis}"))
        self.hours.append(cell)
        return cell

    # ------------------------------------------------------------------ #
    @classmethod
    def from_run(cls, result, *, rel_tol: float = REL_TOL,
                 verify: bool = True) -> "CarbonLedger":
        """Build (and audit) the ledger for a finished ``RunResult``.

        Categories come from the hour's component fields (the engine
        computes ``carbon_g = op + emb_cache + emb_comp`` in exactly
        that order); regions from the per-region day results of a geo
        run (the global hour is their left-fold sum); tiers/tenants
        from the hour's functional-unit/chargeback dicts.  Single-site
        and single-tier hours collapse to one-key partitions."""
        led = cls(rel_tol=rel_tol)
        region_hours = None
        region_names = None
        if getattr(result, "regions", None):
            region_names = list(result.regions)
            region_hours = [result.regions[nm].hours
                            for nm in region_names]
        for i, h in enumerate(result.hours):
            category = {"operational": h.operational_g,
                        "embodied_cache": h.embodied_cache_g,
                        "embodied_compute": h.embodied_compute_g}
            region = None
            if region_hours is not None:
                region = {nm: rh[i].carbon_g
                          for nm, rh in zip(region_names, region_hours)}
            tier = {t: d["carbon_g"] for t, d in h.tiers.items()} \
                if h.tiers else None
            tenant = {t: d["carbon_g"] for t, d in h.tenants.items()} \
                if h.tenants else None
            led.add_hour(h.hour, h.carbon_g, category=category,
                         region=region, tier=tier, tenant=tenant)
        if verify:
            led.verify(expected_total=result.total_carbon_g)
        return led

    # ------------------------------------------------------------------ #
    def by(self, axis: str) -> Dict[str, float]:
        """Day-level cut: per-key sums across hours, reconciled so the
        cut partitions ``total_g`` bit-exactly."""
        agg: Dict[str, float] = {}
        for c in self.hours:
            for k, v in c.cut(axis).items():
                agg[k] = agg.get(k, 0.0) + v
        return exact_partition(self.total_g, agg, rel_tol=self.rel_tol,
                               where=f"day {axis}")

    def verify(self, expected_total: Optional[float] = None
               ) -> "CarbonLedger":
        """Re-prove every invariant: each hour's four partitions sum
        (left-fold) to the hour total bit-exactly; each day cut
        partitions ``total_g``; and ``total_g`` equals the caller's
        expected run total when given.  Raises ``LedgerError``."""
        for c in self.hours:
            for axis in AXES:
                parts = c.cut(axis)
                s = _lsum(parts.values())
                if s != c.total_g:
                    raise LedgerError(
                        f"hour {c.hour} {axis} partition sums to "
                        f"{s:.9g}, hour total is {c.total_g:.9g}")
        for axis in AXES:
            self.by(axis)           # raises if irreconcilable
        if expected_total is not None \
                and float(expected_total) != self.total_g:
            raise LedgerError(
                f"ledger total {self.total_g:.9g} != run total "
                f"{float(expected_total):.9g}")
        return self

    # ------------------------------------------------------------------ #
    def summary(self) -> Dict:
        """Plain-dict audit report (what ``tools/trace_report.py`` and
        the docs render)."""
        return {"hours": len(self.hours), "total_g": self.total_g,
                **{f"by_{axis}": self.by(axis) for axis in AXES}}
