"""The simulated serving cluster, the §5.2 profiler and the §5.4 solver in
the PyTorch port against the JAX package's, on the CPU, at tolerance 0.

One seeded request stream runs through both packages' engines (one
replica, three under each router, a partitioned ring, a disaggregated
plan, a transition between two plans, a run with the flight recorder
attached): every ``SimResult`` field, the store's statistics and the
recorder's span rows must be equal. ``run_profiler`` measures a small grid
(2 rates x 3 sizes, warm-up 1,000, 200 s windows) for chat, documents,
prefix-aware chat and an a100 replica; every ``ProfileCell`` must be equal.
The solves over those profiles must choose the same hourly sizes and plans
with the same objective, feasibility, solver and ``explain()`` text; only
``solve_time_s`` (a wall clock) is left out. Inside the port the
vectorised DP, the transition DP and the transition matrices must equal
their loop twins, and the vectorised option tables their scalar twin, bit
for bit; the loop twins equal the reference's.
"""
import functools

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

from repro.core import carbon as jcarbon
from repro.core import kvstore as jkvstore
from repro.core import plan as jplan
from repro.core import policies as jpolicies
from repro.core import profiler as jprofiler
from repro.core import solver as jsolver
from repro.core import storage as jstorage
from repro.obs import ledger as jledger
from repro.obs import trace as jtrace
from repro.serving import cluster as jcluster
from repro.serving import engine as jengine
from repro.serving import perfmodel as jperf
from repro.workloads import conversations as jconv
from repro.workloads import documents as jdocs
from repro.workloads import traces as jtraces
from repro_torch.core import carbon as tcarbon
from repro_torch.core import kvstore as tkvstore
from repro_torch.core import plan as tplan
from repro_torch.core import policies as tpolicies
from repro_torch.core import profiler as tprofiler
from repro_torch.core import solver as tsolver
from repro_torch.core import storage as tstorage
from repro_torch.obs import ledger as tledger
from repro_torch.obs import trace as ttrace
from repro_torch.serving import cluster as tcluster
from repro_torch.serving import engine as tengine
from repro_torch.serving import perfmodel as tperf
from repro_torch.workloads import conversations as tconv
from repro_torch.workloads import documents as tdocs
from repro_torch.workloads import traces as ttraces
from sim_parity import assert_same, plain


class Pkg:
    def __init__(self, **mods):
        self.__dict__.update(mods)


REF = Pkg(carbon=jcarbon, kvstore=jkvstore, plan=jplan, policies=jpolicies,
          profiler=jprofiler, solver=jsolver, storage=jstorage, ledger=jledger,
          trace=jtrace, cluster=jcluster, engine=jengine, perf=jperf, conv=jconv,
          docs=jdocs, traces=jtraces)
PORT = Pkg(carbon=tcarbon, kvstore=tkvstore, plan=tplan, policies=tpolicies,
           profiler=tprofiler, solver=tsolver, storage=tstorage, ledger=tledger,
           trace=ttrace, cluster=tcluster, engine=tengine, perf=tperf, conv=tconv,
           docs=tdocs, traces=ttraces)
MODEL = "llama3-70b"
SOLVE_SKIP = ("solve_time_s", "explain_data")


def both(fn):
    """``fn(pkg)`` for the reference and for the port."""
    return fn(REF), fn(PORT)


# --------------------------------------------------------------------------- #
# engines
# --------------------------------------------------------------------------- #

def requests(p, n=4000, rate=1.4, seed=1):
    wl = p.conv.ConversationWorkload(seed=seed)
    arr = p.traces.make_poisson_arrivals(np.full(6, rate), seed=seed + 1, max_requests=n)
    return wl.sample_batch(arr)


def run_cluster(p, *, warm=2000, windows=1, ci=124.0, **kw):
    """Warm, then run the rest of the stream in ``windows`` equal windows;
    returns the results, the stores' statistics and the requests."""
    reqs = requests(p)
    m, cm = p.perf.SERVING_MODELS[MODEL], p.carbon.CarbonModel()
    apply_after = kw.pop("apply", None)
    recorder = kw.pop("recorder", False)
    eng = p.cluster.make_cluster(m, cm, policy=p.policies.POLICIES["lcs_chat"], **kw)
    if recorder:
        eng.recorder = p.trace.TraceRecorder(capacity=64)
    eng.warm(reqs[:warm])
    rest = reqs[warm:]
    step = len(rest) // windows
    results = []
    for w in range(windows):
        if w and apply_after is not None:
            eng.apply(p.plan.ResourcePlan.parse(apply_after), now=rest[w * step].arrival)
        cache = eng.current_plan().cache_tb if hasattr(eng, "current_plan") else None
        results.append(eng.run(rest[w * step:(w + 1) * step], ci_fn=lambda t: ci,
                               cache_tb=cache))
    stores = eng.stores if isinstance(eng.stores, list) else [eng.stores]
    out = {"results": results, "stats": [s.stats for s in stores],
           "used": [s.used_bytes for s in stores], "requests": rest}
    if recorder:
        out["rows"] = list(eng.recorder.rows())
        out["events"] = eng.recorder.events
    return out


ENGINES = {
    "1 replica": dict(cache_tb=4.0),
    "1 replica, no cache": dict(cache_tb=0.0),
    "3 replicas, partitioned": dict(cache_tb=6.0, n_replicas=3, router="cache_affinity",
                                    partitioned=True),
    "typed fleet": dict(plan="cache=4tb fleet=a100:2,l40:1"),
    "tiered": dict(plan="cache=dram:0.5tb+nvme_gen4:4tb fleet=l40:2"),
    "disaggregated": dict(plan="cache=4tb prefill=h100:2 decode=a100:3"),
    "transition": dict(plan="cache=8tb fleet=l40:2", windows=2,
                       apply="cache=2tb fleet=l40:3"),
    "recorder": dict(cache_tb=4.0, recorder=True, windows=2),
}
ENGINES.update({f"3 replicas, {r}": dict(cache_tb=4.0, n_replicas=3, router=r)
                for r in tcluster.ROUTERS if r != "single"})


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_engine_matches_reference(name):
    kw = dict(ENGINES[name])
    if name == "transition":
        ref, port = both(lambda p: run_cluster(
            p, transitions=p.plan.TransitionConfig(), **kw))
    else:
        ref, port = both(lambda p: run_cluster(p, **kw))
    res = port["results"][-1]
    assert res.num_requests > 0 and np.isfinite(res.carbon_g)
    if name == "recorder":
        assert len(port["rows"]) == sum(r.num_requests for r in port["results"])
    assert_same(ref, port)


@pytest.mark.parametrize("router", ("single", "bogus"))
def test_engine_refuses_a_bad_router_alike(router):
    """``single`` serves one replica only; an unknown router is refused."""
    def build(p):
        try:
            run_cluster(p, cache_tb=4.0, n_replicas=3, router=router)
        except ValueError as e:
            return str(e)
    ref, port = both(build)
    assert ref == port and port is not None


def test_combine_results_raises_ledger_error_alike():
    """Two windows merge into one conserved result; a doctored window (its
    bill one gram off its components, or a tier array short of its
    requests) raises ``LedgerError`` with the same message on both sides."""
    def merge(p, doctor):
        a, b = run_cluster(p, cache_tb=4.0, windows=2)["results"]
        if doctor == "carbon":
            a.carbon_g += 1.0
        elif doctor == "tiers":
            a.tiers = np.array(["gold"] * (a.num_requests - 1), dtype=object)
            a.work = np.ones(a.num_requests - 1)
        try:
            return ("ok", plain(p.engine.combine_results(a, b)))
        except p.ledger.LedgerError as e:
            return ("LedgerError", str(e))

    for doctor in ("none", "carbon", "tiers"):
        ref, port = both(lambda p: merge(p, doctor))
        assert ref == port
        assert port[0] == ("ok" if doctor == "none" else "LedgerError")


# --------------------------------------------------------------------------- #
# the profiler
# --------------------------------------------------------------------------- #

RATES, SIZES = [0.4, 1.2], [0, 2, 8]
PROFILES = {
    "conversation": ("conversation", lambda p: lambda s: p.conv.ConversationWorkload(seed=s),
                     {}),
    "document": ("document", lambda p: lambda s: p.docs.DocumentWorkload(seed=s, zipf_alpha=0.4),
                 {"policy": "lcs_doc"}),
    "prefix-aware": ("conversation",
                     lambda p: lambda s: p.conv.ConversationWorkload(seed=s, prefix=True),
                     {"prefix_aware": True}),
    "a100": ("conversation", lambda p: lambda s: p.conv.ConversationWorkload(seed=s),
             {"replica_type": "a100"}),
}


@functools.lru_cache(maxsize=None)
def profile(side, name):
    p = REF if side == "ref" else PORT
    task, factory, kw = PROFILES[name]
    return p.profiler.run_profiler(p.perf.SERVING_MODELS[MODEL], task, factory(p),
                                   p.carbon.CarbonModel(), rates=RATES, sizes_tb=SIZES,
                                   warmup_prompts=1000, meas_seconds=200, **kw)


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_profile_matches_reference(name):
    ref, port = profile("ref", name), profile("port", name)
    assert sorted(port.cells) == sorted((r, s) for r in RATES for s in SIZES)
    assert all(port.cells[(r, 0)].hit_rate == 0.0 for r in RATES)
    assert port.cells[(1.2, 8)].hit_rate > 0.0
    assert_same(ref, port)
    # the solver's interpolation over the profile, scalar and columnar
    q_r, q_s = np.array([0.1, 0.4, 0.7, 1.2, 2.0]), np.array([0, 2, 8, 8, 2])
    assert_same([ref.interpolate(r, s) for r, s in zip(q_r, q_s)],
                [port.interpolate(r, s) for r, s in zip(q_r, q_s)])
    assert_same(ref.interpolate_many(q_r, q_s), port.interpolate_many(q_r, q_s))


def test_type_profiles_match():
    def run(p):
        task, factory, _ = PROFILES["conversation"]
        return p.profiler.run_type_profiles(
            p.perf.SERVING_MODELS[MODEL], task, factory(p), p.carbon.CarbonModel(),
            ["h100", "l40"], rates=[0.8], sizes_tb=[0, 4], warmup_prompts=500,
            meas_seconds=100)
    assert_same(*both(run))


# --------------------------------------------------------------------------- #
# the solver
# --------------------------------------------------------------------------- #

def day(p, grid):
    return p.traces.azure_rate_trace(1.2, seed=3), p.traces.ci_trace(grid, seed=4)


def slo(p, name):
    return p.perf.SLOS[(MODEL, "doc" if name == "document" else "chat")]


def solved(side, name, grid, **kw):
    p = REF if side == "ref" else PORT
    rates, cis = day(p, grid)
    return p.solver.solve_cache_schedule(profile(side, name), list(rates), list(cis),
                                         slo(p, name), p.carbon.CarbonModel(), **kw)


@pytest.mark.parametrize("grid", ("FR", "CISO"))
@pytest.mark.parametrize("name", ("conversation", "document"))
def test_cache_schedule_matches_reference(name, grid):
    ref, port = solved("ref", name, grid), solved("port", name, grid)
    assert len(port.sizes_tb) == 24 and set(port.sizes_tb) <= set(SIZES)
    assert port.solver == "dp"              # no pulp: the exact DP, as the reference
    assert_same(ref, port, SOLVE_SKIP)
    assert ref.explain() == port.explain()
    assert ref.prune_stats() == port.prune_stats()


def random_tables(seed, T=24, S=7):
    rng = np.random.default_rng(seed)
    C = rng.uniform(0.001, 1.0, (T, S))
    F = np.sort(rng.uniform(0.2, 1.0, (T, S)), axis=1)
    n = rng.uniform(100, 5000, T)
    return C, F, n, [0, 1, 2, 4, 8, 12, 16][:S], float(rng.uniform(0.5, 0.95))


def dp_tables():
    """The day's tables of the four solves above, then seeded random ones."""
    out = []
    for name in ("conversation", "document"):
        for grid in ("FR", "CISO"):
            ed = solved("port", name, grid).explain_data
            out.append((f"{name} {grid}", ed["C"], ed["F"], ed["n"], SIZES, ed["rho"]))
    out += [(f"random {s}", *random_tables(s)) for s in range(6)]
    return out


@pytest.mark.parametrize("prune", (False, True), ids=("exhaustive", "pruned"))
@pytest.mark.parametrize("case", range(10))
def test_vectorised_dp_equals_loop_dp(case, prune):
    label, C, F, n, sizes, rho = dp_tables()[case]
    loop = tsolver._solve_dp_reference(C, F, n, sizes, rho, 0.0)
    vec = tsolver._solve_dp(C, F, n, sizes, rho, 0.0, prune=prune)
    for f in ("sizes_tb", "objective_g", "feasible", "solver"):
        assert getattr(vec, f) == getattr(loop, f), (label, f)
    jloop = jsolver._solve_dp_reference(C, F, n, sizes, rho, 0.0)
    assert_same(jloop, loop, SOLVE_SKIP)


CLUSTER = {
    "replicas": lambda p: dict(replicas=[1, 2]),
    "fleets": lambda p: dict(fleets=p.solver.enumerate_fleets(["a100", "l40"], 2),
                             type_profiles={"a100": profile(
                                 "ref" if p is REF else "port", "a100")}),
    "disaggregated": lambda p: dict(
        prefill_fleets=p.solver.enumerate_fleets(["h100"], 2),
        decode_fleets=p.solver.enumerate_fleets(["a100"], 2),
        model=p.perf.SERVING_MODELS[MODEL]),
    "transitions": lambda p: dict(replicas=[1, 2, 3], transitions=p.plan.TransitionConfig(),
                                  min_dwell_hours=2),
    "storage": lambda p: dict(storage=p.storage.enumerate_storage_specs(
        [0, 2, 8], devices=["nvme_gen4", "qlc_ssd"])),
    "tiers": lambda p: dict(replicas=[1, 2], tier_shares={"gold": 0.2, "standard": 0.5,
                                                          "scavenger": 0.3}),
    "beam": lambda p: dict(replicas=[1, 2, 3], beam_width=4),
}


def cluster_solve(p, name, **extra):
    side = "ref" if p is REF else "port"
    rates, cis = day(p, "FR")
    return p.solver.solve_cluster_schedule(
        profile(side, "conversation"), list(rates * 1.5), list(cis), slo(p, "conversation"),
        p.carbon.CarbonModel(), **CLUSTER[name](p), **extra)


@functools.lru_cache(maxsize=None)
def transitions_day():
    """The "transitions" cluster solve's option plans and its transition DP's
    arguments, caught on their way into the port's two engines."""
    seen = {}
    mats, dp = tsolver._transition_matrices, tsolver._solve_dp_transition

    def catch_mats(opt_plans, cfg, model=None):
        seen["mats"] = (list(opt_plans), cfg, model)
        return mats(opt_plans, cfg, model=model)

    def catch_dp(*args, **kw):
        seen["dp"] = (args, kw)
        return dp(*args, **kw)

    tsolver._transition_matrices, tsolver._solve_dp_transition = catch_mats, catch_dp
    try:
        cluster_solve(PORT, "transitions")
    finally:
        tsolver._transition_matrices, tsolver._solve_dp_transition = mats, dp
    return seen


def transition_plans(p, name):
    """Option plans, the transition config and the model for one case."""
    P, cfg, model = p.plan.ResourcePlan.parse, p.plan.TransitionConfig(), \
        p.perf.SERVING_MODELS[MODEL]
    if name == "typed fleets":
        return [P(f"serve={t}:{k}").with_cache(c) for t in ("l40", "a100")
                for k in (1, 2, 3) for c in (2.0, 8.0)], cfg, model
    # partitioned prefill exercises the ring-migration term
    return [P(f"cache={c}tb serve=l40:{k} partitioned") for k in (1, 2, 3)
            for c in (2, 8)], cfg, model


@pytest.mark.parametrize("name", ("transitions day", "typed fleets", "partitioned ring"))
def test_transition_matrices_equal_loop(name):
    if name == "transitions day":       # its solve is held against the reference above
        plans, cfg, model = transitions_day()["mats"]
    else:
        plans, cfg, model = transition_plans(PORT, name)
        assert_same(jsolver._transition_matrices_reference(*transition_plans(REF, name)),
                    tsolver._transition_matrices_reference(plans, cfg, model=model))
    E, S = tsolver._transition_matrices(plans, cfg, model=model)
    Er, Sr = tsolver._transition_matrices_reference(plans, cfg, model=model)
    assert E.any() and S.any()
    assert np.array_equal(E, Er) and np.array_equal(S, Sr)


def transition_dp_case(case):
    """(label, positional arguments, keyword arguments, class keys): the
    "transitions" day's DP, then seeded random tables with classes, an
    initial switch, a locked first hour and dwells of 1-3 hours."""
    if case == 0:
        args, kw = transitions_day()["dp"]
        return "transitions day", args, {"lock0": kw["lock0"]}, kw["class_keys"]
    seed = case - 1
    r = np.random.default_rng(1000 + seed)
    T, n_opt = 6, 10
    C = np.round(r.uniform(0.01, 5.0, (T, n_opt)), 4)
    F = np.round(r.uniform(0.0, 1.0, (T, n_opt)), 3)
    C[:, 1], F[:, 1], C[:, 3] = C[:, 0], F[:, 0], C[:, 2]   # ties
    n = r.uniform(100, 5000, T)
    E = np.round(r.uniform(0, 0.5, (n_opt, n_opt)), 3)
    np.fill_diagonal(E, 0.0)
    S = E > 0.1
    E[~S] = 0.0
    e_init = np.round(r.uniform(0, 0.3, n_opt), 3) if seed % 2 else None
    cis = r.uniform(20, 600, T)
    lock0 = (r.integers(0, 2, n_opt) == 1) if seed % 4 == 1 else None
    # options 0 and 1 share a switch class: identical E/S rows and columns
    E[1], E[:, 1], S[1], S[:, 1] = E[0], E[:, 0], S[0], S[:, 0]
    if e_init is not None:
        e_init[1] = e_init[0]
    if lock0 is not None:
        lock0[1] = lock0[0]
    args = (C, F, n, list(range(n_opt)), [0.3, 0.6, 0.95][seed % 3], 0.0, E, S,
            e_init, cis, [1, 2, 3][seed % 3], 0)
    return f"random {seed}", args, {"lock0": lock0, "buckets": 200}, \
        [(0 if i == 1 else i,) for i in range(n_opt)]


@pytest.mark.parametrize("prune", (False, True), ids=("exhaustive", "pruned"))
@pytest.mark.parametrize("case", range(7))
def test_transition_dp_equals_loop_dp(case, prune):
    label, args, kw, keys = transition_dp_case(case)
    loop = tsolver._solve_dp_transition_reference(*args, **kw)
    assert loop.solver == "dp+transition"
    for class_keys in (None, keys):
        vec = tsolver._solve_dp_transition(*args, **kw, prune=prune,
                                           class_keys=class_keys)
        for f in ("sizes_tb", "objective_g", "feasible", "solver", "transition_g"):
            assert getattr(vec, f) == getattr(loop, f), (label, f, class_keys)
    assert_same(jsolver._solve_dp_transition_reference(*args, **kw), loop, SOLVE_SKIP)


@pytest.mark.parametrize("name", sorted(CLUSTER))
def test_cluster_schedule_matches_reference(name):
    ref, port = both(lambda p: cluster_solve(p, name))
    assert len(port.plans) == 24
    assert_same(ref, port, SOLVE_SKIP)
    assert ref.explain() == port.explain()
    # inside the port: the vectorised option tables are their scalar twin
    assert_same(port, cluster_solve(PORT, name, vectorize=False), SOLVE_SKIP)


def test_geo_schedule_matches_reference():
    def geo(p):
        side = "ref" if p is REF else "port"
        rates, _ = day(p, "FR")
        cis = [list(p.traces.ci_trace(g, seed=4)) for g in ("FR", "CISO")]
        P = p.plan.ResourcePlan.parse
        return p.solver.solve_geo_schedule(
            profile(side, "conversation"), list(rates * 1.5), cis, slo(p, "conversation"),
            p.carbon.CarbonModel(), region_plans=[[P("serve=l40:1"), P("serve=l40:2")], []],
            sizes_tb=[0, 2, 8], quantum=0.5, model=p.perf.SERVING_MODELS[MODEL])

    ref, port = both(geo)
    assert len(port.splits) == 24 and len(port.per_region) == 2
    assert_same(ref, port, SOLVE_SKIP)
