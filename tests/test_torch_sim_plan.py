"""The simulator's carbon model, resource plans, workloads, traces and
serving models in the PyTorch port against the JAX package's, on the CPU,
at tolerance 0.

The same inputs go through both packages: ``CarbonModel`` over every grid
of ``GRID_CI`` and every replica type, ``ResourcePlan.parse`` of every
spelling ``repro.launch.serve`` documents and of storage specs,
``enumerate_plans``, ``TransitionConfig``, the request streams of both
workloads (``sample_batch`` and ``sample`` each) from one numpy seed, the
rate and carbon-intensity traces, and the configs' parameter counts behind
``serving_model_for_arch``. Everything is NumPy float64 in the same order,
so floats compare with ``==``.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

from repro.configs import get_config as jget_config
from repro.core import carbon as jcarbon
from repro.core import plan as jplan
from repro.core import solver as jsolver
from repro.core import storage as jstorage
from repro.serving import perfmodel as jperf
from repro.workloads import conversations as jconv
from repro.workloads import documents as jdocs
from repro.workloads import tenants as jtenants
from repro.workloads import traces as jtraces
from repro_torch.configs import ALL_ARCHS
from repro_torch.configs import get_config as tget_config
from repro_torch.core import carbon as tcarbon
from repro_torch.core import plan as tplan
from repro_torch.core import solver as tsolver
from repro_torch.core import storage as tstorage
from repro_torch.serving import perfmodel as tperf
from repro_torch.workloads import conversations as tconv
from repro_torch.workloads import documents as tdocs
from repro_torch.workloads import tenants as ttenants
from repro_torch.workloads import traces as ttraces
from sim_parity import assert_same, plain

# the plan spellings of ``repro.launch.serve``'s usage (its module
# docstring) and of its flags, a storage spec, a pinned router and eps,
# and a fleet of every replica type the simulated fleet knows
PLANS = ("cache=auto fleet=a100:2,l40:4", "cache=auto fleet=h100:2",
         "cache=auto fleet=a100:3", "cache=auto fleet=l40",
         "cache=auto prefill=h100:1 decode=a100:2",
         "cache=auto prefill=h100:2 decode=a100:3",
         "cache=4tb prefill=h100:2 decode=a100:3", "serve=l40:3",
         "cache=4tb serve=a100:2", "cache=4tb fleet=l40:2 eps=none",
         "cache=4tb fleet=l40:2 eps=0.05", "cache=2tb fleet=tpu_v5e:2,h100:1",
         "cache=dram:0.5tb+nvme_gen4:4tb fleet=l40:2",
         "cache=nvme_gen4:8tb fleet=a100:2")
BAD_PLANS = ("cache=4tb", "cache=4tb fleet=l40 bogus=1", "cache=4tb fleet=rtx4090:2")
STORAGE = ("dram:0.5tb+nvme_gen4:4tb", "nvme_gen4:8tb", "dram:0.5tb+qlc_ssd:8tb",
           "dram:1tb+nvme_gen4:2tb+hdd:8tb", "nvme_gen4:1tb+nvme_gen4:2tb")


def _both(fn):
    """``fn(module set)`` for the reference and for the port, errors by
    class name and message."""
    out = []
    for mods in ((jcarbon, jplan, jstorage, jsolver), (tcarbon, tplan, tstorage, tsolver)):
        try:
            out.append(("ok", plain(fn(*mods))))
        except Exception as e:          # noqa: BLE001 (compared across packages)
            out.append(("raises", type(e).__name__, str(e)))
    return out


# --------------------------------------------------------------------------- #
# carbon model
# --------------------------------------------------------------------------- #

def test_grids_and_replica_types_are_the_reference_ones():
    assert_same(jcarbon.GRID_CI, tcarbon.GRID_CI)
    assert_same(jcarbon.REPLICA_TYPES, tcarbon.REPLICA_TYPES)
    assert_same(jcarbon.TPU_V5E_SPEC, tcarbon.TPU_V5E_SPEC)
    assert set(tcarbon.REPLICA_TYPES) >= {"l40", "a100", "h100", "tpu_v5e"}


@pytest.mark.parametrize("grid", sorted(tcarbon.GRID_CI))
def test_carbon_total_matches(grid):
    rng = np.random.default_rng(sum(map(ord, grid)))
    ci = tcarbon.GRID_CI[grid]
    for _ in range(20):
        e, tb, s = rng.uniform(1e-5, 1e-2), rng.choice([0, 1, 4, 16]), rng.uniform(1, 7200)
        n, types = int(rng.integers(1, 5)), None
        if rng.uniform() < 0.5:
            types = list(rng.choice(sorted(tcarbon.REPLICA_TYPES), n))
        j, t = jcarbon.CarbonModel(), tcarbon.CarbonModel()
        assert t.total_g(e, ci, tb, s, n, types=types) == \
            j.total_g(e, ci, tb, s, n, types=types)
        assert t.operational_g(e, ci) == j.operational_g(e, ci)
        assert t.cache_embodied_g(tb, s) == j.cache_embodied_g(tb, s)
        assert t.compute_embodied_g(s, n, types=types) == \
            j.compute_embodied_g(s, n, types=types)
        u = rng.uniform()
        assert t.energy_kwh(u, s, tb, n, types=types) == j.energy_kwh(u, s, tb, n, types=types)


@pytest.mark.parametrize("name", sorted(tcarbon.REPLICA_TYPES))
def test_replica_type_power_and_embodied_match(name):
    j, t = jcarbon.get_replica_type(name), tcarbon.get_replica_type(name)
    assert_same(j, t)
    assert t.effective_embodied_kg == j.effective_embodied_kg
    for s in (1.0, 60.0, 3600.0, 86400.0):
        assert t.embodied_g(s) == j.embodied_g(s)
        assert t.idle_energy_kwh(s) == j.idle_energy_kwh(s)
    for u in np.linspace(0.0, 1.0, 11):
        assert t.server_power_w(u) == j.server_power_w(u)
    # the same type priced as a hardware generation of a whole carbon model
    jm, tm = jcarbon.CarbonModel(hw=j.hw), tcarbon.CarbonModel(hw=t.hw)
    assert tm.total_g(3e-4, 124.0, 4.0, 3600.0) == jm.total_g(3e-4, 124.0, 4.0, 3600.0)


def test_fleet_helpers_and_migration_energy_match():
    for spec in ("a100:2,l40:4", "h100:1", "tpu_v5e:3,a100:1", "l40"):
        assert tcarbon.parse_fleet(spec) == jcarbon.parse_fleet(spec)
        f = tcarbon.parse_fleet(spec)
        assert tcarbon.fleet_str(f) == jcarbon.fleet_str(f)
        assert tcarbon.fleet_capacity(f) == jcarbon.fleet_capacity(f)
    for b in (0.0, 1e9, 3.3e12):
        assert tcarbon.kv_migration_energy_kwh(b, 25.0) == \
            jcarbon.kv_migration_energy_kwh(b, 25.0)


# --------------------------------------------------------------------------- #
# resource plans, storage specs, transitions
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("spec", PLANS + BAD_PLANS)
def test_plan_parse_matches(spec):
    def parse(carbon, plan, storage, solver):
        p = plan.ResourcePlan.parse(spec)
        sized = p.with_cache(8.0) if p.cache_tb is None else p
        cm = carbon.CarbonModel()
        return (p, str(p), p.to_json(), plan.ResourcePlan.from_json(p.to_json()) == p,
                p.n_replicas, p.capacity, p.all_types, p.is_disaggregated,
                cm.plan_embodied_g(sized, 3600.0),
                cm.plan_energy_kwh(sized, 0.4, 3600.0),
                cm.plan_energy_kwh(sized, {q.role: 0.3 for q in sized.pools}, 3600.0,
                                   pool_power_frac={"decode": 0.8}))

    ref, port = _both(parse)
    assert ref == port
    assert (ref[0] == "ok") == (spec in PLANS)


@pytest.mark.parametrize("spec", STORAGE)
def test_storage_spec_parse_matches(spec):
    def parse(carbon, plan, storage, solver):
        s = storage.StorageSpec.parse(spec)
        cm = carbon.CarbonModel()
        return (s, s.total_tb, s.usable_tb, s.idle_w, s.to_json(), s.scaled_to(12.0),
                [s.read_gbps(t) for t in (0, 1)],
                cm.cache_embodied_g(s.total_tb, 3600.0, storage=s),
                cm.cache_embodied_g(s.total_tb, 3600.0, storage=s, write_bytes_per_s=2e8),
                cm.energy_kwh(0.4, 3600.0, storage=s))

    ref, port = _both(parse)
    assert ref == port


def test_storage_enumeration_and_devices_match():
    assert_same(jstorage.STORAGE_DEVICES, tstorage.STORAGE_DEVICES)
    args = ([0, 1, 2, 4, 8, 16],)
    for kw in ({}, {"devices": ["nvme_gen4", "qlc_ssd"]},
               {"hot_fracs": [0.0, 0.1], "devices": ["nvme_gen4"]}):
        ref, port = _both(lambda c, p, s, v: s.enumerate_storage_specs(*args, **kw))
        assert ref == port
    for name, dev in tstorage.STORAGE_DEVICES.items():
        jdev = jstorage.STORAGE_DEVICES[name]
        for tb, rate in ((1.0, 0.0), (4.0, 1e8), (16.0, 5e9)):
            assert dev.effective_lifetime_s(tb, rate) == jdev.effective_lifetime_s(tb, rate)
            assert dev.tbw_bytes(tb) == jdev.tbw_bytes(tb)
        assert dev.io_energy_j(read_bytes=1e9, write_bytes=2e9) == \
            jdev.io_energy_j(read_bytes=1e9, write_bytes=2e9)


def test_enumerate_fleets_and_plans_match():
    def enum(carbon, plan, storage, solver):
        pre = solver.enumerate_fleets(["h100"], 2)
        dec = solver.enumerate_fleets(["a100", "l40"], 3)
        return (solver.enumerate_fleets(["a100", "h100", "l40"], 4, min_replicas=2),
                plan.enumerate_plans(pre, dec),
                [str(p) for p in plan.enumerate_plans(pre, dec, router="least_loaded",
                                                      balance_eps=None)])

    ref, port = _both(enum)
    assert ref == port and ref[0] == "ok"


def test_transitions_match():
    def trans(carbon, plan, storage, solver):
        cfgs = (plan.TransitionConfig(), plan.TransitionConfig.free(),
                plan.TransitionConfig(boot_latency_s=30.0, rebalance="cold",
                                      cache_ramp_s=120.0, drain=False))
        cm = carbon.CarbonModel()
        P = plan.ResourcePlan.parse
        pairs = [(P("cache=4tb fleet=l40:2"), P("cache=8tb fleet=l40:3")),
                 (P("cache=8tb fleet=a100:2,l40:1"), P("cache=2tb fleet=h100:1")),
                 (P("cache=4tb prefill=h100:2 decode=a100:3"),
                  P("cache=2tb prefill=h100:1 decode=a100:1"))]
        out = [(c, c.is_free, [c.boot_s(t) for t in ("l40", "a100", "h100")]) for c in cfgs]
        for old, new in pairs:
            tr = plan.PlanTransition.diff(old, new)
            out.append((tr, str(tr), plan.PlanTransition.parse(str(tr)) == tr,
                        tr.cache_delta_tb, tr.moved_ring_fraction, tr.is_noop,
                        cm.transition_g(old, new, 124.0, migrate_bytes=2e11, drain_s=20.0)))
        out.append([plan.ring_moved_fraction(a, b) for a in range(1, 5) for b in range(1, 5)])
        plan.TransitionConfig(rebalance="teleport")
        return out

    ref, port = _both(trans)
    assert ref == port
    assert ref[0] == "raises" and "rebalance" in ref[2]


# --------------------------------------------------------------------------- #
# workloads and traces
# --------------------------------------------------------------------------- #

WORKLOADS = {
    "conversation": lambda m, s: m[0].ConversationWorkload(seed=s),
    "conversation prefix x2": lambda m, s: m[0].ConversationWorkload(
        seed=s, load_scale=2.0, prefix=True),
    "document": lambda m, s: m[1].DocumentWorkload(seed=s, zipf_alpha=0.4),
    "document prefix": lambda m, s: m[1].DocumentWorkload(seed=s, zipf_alpha=0.8,
                                                          prefix=True),
    "multi-tenant": lambda m, s: m[2].multi_tenant(
        lambda seed: m[0].ConversationWorkload(seed=seed),
        {"gold": 0.2, "standard": 0.5, "scavenger": 0.3})(s),
}


@pytest.mark.parametrize("batch", (True, False), ids=("sample_batch", "sample"))
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_request_streams_match(name, batch):
    arr = ttraces.make_poisson_arrivals(np.full(4, 1.3), seed=7, max_requests=3000)
    assert np.array_equal(arr, jtraces.make_poisson_arrivals(np.full(4, 1.3), seed=7,
                                                             max_requests=3000))
    streams = []
    for mods in ((jconv, jdocs, jtenants), (tconv, tdocs, ttenants)):
        wl = WORKLOADS[name](mods, 17)
        reqs = wl.sample_batch(arr) if batch else [wl.sample(float(t)) for t in arr]
        reqs += wl.sample_batch(arr[:200] + 14400.0)
        streams.append(reqs)
    assert len(streams[1]) == 3200
    assert_same(*streams)


def test_tiers_match():
    assert_same(jtenants.TIERS, ttenants.TIERS)
    for shares in ({"gold": 1, "standard": 3}, {"scavenger": 0.5, "gold": 0.5}):
        assert_same(jtenants.normalize_shares(shares), ttenants.normalize_shares(shares))
    for t in ttenants.TIERS:
        assert_same(jtenants.tier_slo(jperf.SLOS[("llama3-70b", "chat")], t),
                    ttenants.tier_slo(tperf.SLOS[("llama3-70b", "chat")], t))


@pytest.mark.parametrize("seed", (0, 3, 11))
def test_traces_match(seed):
    for peak, days in ((1.6, 1), (8.0, 2)):
        a = ttraces.azure_rate_trace(peak, days=days, seed=seed)
        assert np.array_equal(a, jtraces.azure_rate_trace(peak, days=days, seed=seed))
        assert a.dtype == np.float64 and len(a) == 24 * days
    for grid in sorted(tcarbon.GRID_CI):
        assert np.array_equal(ttraces.ci_trace(grid, seed=seed),
                              jtraces.ci_trace(grid, seed=seed))
    rates = ttraces.azure_rate_trace(1.6, seed=seed)
    assert np.array_equal(ttraces.make_poisson_arrivals(rates, seed=seed),
                          jtraces.make_poisson_arrivals(rates, seed=seed))


# --------------------------------------------------------------------------- #
# configs and serving models
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_counts_and_arch_serving_model_match(arch):
    j, t = jget_config(arch), tget_config(arch)
    assert t.tie_embeddings == j.tie_embeddings
    assert t.param_count == j.param_count > 0
    assert t.active_param_count == j.active_param_count > 0
    assert_same(jperf.serving_model_for_arch(arch, chips=4, peak_tflops=197.0, hbm_gbps=819.0),
                tperf.serving_model_for_arch(arch, chips=4, peak_tflops=197.0, hbm_gbps=819.0))
    # with no arguments: a server of four H100 SXM cards
    h100 = tperf.serving_model_for_arch(arch)
    assert_same(tperf.serving_model_for_arch(arch, chips=4, peak_tflops=989.0,
                                             hbm_gbps=3350.0), h100)
    assert h100.prefill_tok_per_s == 4 * 989.0e12 * 0.45 / (2.0 * t.active_param_count)


def test_serving_models_and_slos_match():
    assert_same(jperf.SERVING_MODELS, tperf.SERVING_MODELS)
    assert_same(jperf.SLOS, tperf.SLOS)
    for name, m in tperf.SERVING_MODELS.items():
        jm = jperf.SERVING_MODELS[name]
        assert_same(jm.scaled(1.7), m.scaled(1.7))
        for lam in (0.1, 0.8, 1.6, 12.0):
            assert m.decode_fixed_point(lam, 480.0) == jm.decode_fixed_point(lam, 480.0)
            assert m.decode_fixed_point(lam, 480.0, 1.3, 0.4) == \
                jm.decode_fixed_point(lam, 480.0, 1.3, 0.4)
        assert m.prefill_time(1200, 8000) == jm.prefill_time(1200, 8000)
