"""The simulator's cache stores and replacement policies in the PyTorch port
against the JAX package's, on the CPU, at tolerance 0.

One seeded stream of fused ``account`` calls, ``lookup`` + ``insert``
pairs, gradual and instant resizes and ``pop_entry``/``adopt`` migrations
runs through the reference's store and through the port's: the flat
``KVStore`` with scalar eviction and with ``enable_vector_evict()``, the
prefix-tree ``RadixKVStore`` and the two-tier ``TieredKVStore``, under
every policy of ``POLICIES``. Every call's result, the victims in the order
they left, ``KVStoreStats``, the written bytes and the surviving entries
must be the same. Both packages' stores are host NumPy float64 code, so any
difference is a transcription fault. The flight recorder's and the carbon
ledger's own functions are held here too.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

from repro.core import kvstore as jkvstore
from repro.core import policies as jpolicies
from repro.core import radix as jradix
from repro.core import storage as jstorage
from repro.obs import ledger as jledger
from repro.obs import trace as jtrace
from repro_torch.core import kvstore as tkvstore
from repro_torch.core import policies as tpolicies
from repro_torch.core import radix as tradix
from repro_torch.core import storage as tstorage
from repro_torch.obs import ledger as tledger
from repro_torch.obs import trace as ttrace
from sim_parity import assert_same, plain

REF = dict(kvstore=jkvstore, policies=jpolicies, radix=jradix, storage=jstorage)
PORT = dict(kvstore=tkvstore, policies=tpolicies, radix=tradix, storage=tstorage)

BPT = 327_680.0                 # llama3-70b's KV bytes per token
CAPACITY = 4e12                 # the flat stores' bytes: the tiered spec's cold tier
TIERED = "dram:0.5tb+nvme_gen4:4tb"
STORES = ("flat", "vector", "radix", "tiered")
POLICY_NAMES = tuple(tpolicies.POLICIES)
ENTRY_SKIP = ("payload", "parent", "children")


def test_the_port_has_the_reference_policies():
    assert list(tpolicies.POLICIES) == list(jpolicies.POLICIES)
    assert [f.__name__ for f in tpolicies.VECTOR_POLICIES] == \
        [f.__name__ for f in jpolicies.VECTOR_POLICIES]


def op_stream(seed=0, n=3000, keys=1200):
    """(op, key id, context tokens, new tokens, turn, resize factor, depth,
    tier weight) per step; contexts of 0.2k-20k tokens at 327 KB a token
    overflow 4 TB several times over, so every store evicts."""
    rng = np.random.default_rng(seed)
    cols = (rng.integers(0, 12, n), rng.integers(0, keys, n),
            rng.integers(200, 20_000, n), rng.integers(10, 600, n),
            rng.integers(1, 9, n), rng.uniform(0.5, 1.3, n),
            rng.integers(1, 6, n), rng.choice([0.25, 1.0, 4.0], n))
    return list(zip(*(c.tolist() for c in cols)))


def make_store(pkg, kind, policy):
    p = pkg["policies"].POLICIES[policy] if isinstance(policy, str) else policy
    if kind == "tiered":
        st = pkg["storage"].TieredKVStore(pkg["storage"].StorageSpec.parse(TIERED),
                                          p, BPT)
    elif kind == "radix":
        st = pkg["radix"].RadixKVStore(CAPACITY, p, BPT)
    else:
        st = pkg["kvstore"].KVStore(CAPACITY, p, BPT)
        if kind == "vector":
            assert st.enable_vector_evict()
    return st


def drive(pkg, kind, policy="lcs", ops=None, weighted=False, skip=ENTRY_SKIP):
    """Run the op stream through one store; returns everything observable
    (entries without the fields in ``skip``)."""
    def entry_row(e):
        return None if e is None else plain(e, skip)

    st = make_store(pkg, kind, policy)
    victims = []
    evict = st._evict

    def logged(key):
        victims.append(key)
        evict(key)

    st._evict = logged
    donors, calls = [], []
    for i, (op, kid, ctx, new, turn, frac, depth, w) in enumerate(ops or op_stream()):
        now = 1.7 * i
        key = f"c-{kid}"
        w = w if weighted else 1.0
        if op <= 5:
            blocks = None
            if kind == "radix":
                per = max(ctx // depth, 1)
                blocks = [(f"sys-{kid % 6}", per)] + \
                    [(f"c{kid}:t{j}", per) for j in range(depth - 1)]
                ctx = per * depth
            ret = st.account(key, ctx, ctx + new, now, turn, blocks=blocks, weight=w)
            calls.append(("account", plain(ret)))
        elif op <= 7:
            calls.append(("lookup", entry_row(st.lookup(key, ctx, now))))
            calls.append(("insert", entry_row(st.insert(key, ctx + new, now, turn=turn,
                                                        weight=w))))
        elif op == 8:
            st.schedule_resize(CAPACITY * frac, now, ramp_s=600.0)
        elif op == 9:
            st.resize(CAPACITY * frac, now)
        elif op == 10 and st.entries:
            k = sorted(st.entries)[kid % len(st.entries)]
            donors.append(st.pop_entry(k))
        elif op == 11 and donors:
            calls.append(("adopt", st.adopt(donors.pop(), now)))
        calls.append(("used", st.used_bytes, st.capacity_bytes))
    out = {"calls": calls, "victims": victims, "stats": plain(st.stats),
           "entries": [entry_row(e) for e in st.entries.values()]}
    if kind == "tiered":
        out["tiers"] = (st.tier_written, st.io_energy_j, st.promotions, st.demotions,
                        st.hot_used_bytes, sorted(st._hot))
    return out


@pytest.mark.parametrize("policy", POLICY_NAMES)
@pytest.mark.parametrize("kind", STORES)
def test_store_matches_reference(kind, policy):
    ref, port = drive(REF, kind, policy), drive(PORT, kind, policy)
    assert port["victims"] and port["stats"][1]["evictions"] == len(port["victims"])
    assert port["stats"][1]["hits"] > 0
    assert_same(ref, port)


@pytest.mark.parametrize("kind", ("vector", "tiered"))
def test_tier_weighted_store_matches_reference(kind):
    """Tier weights on the entries and a ``tier_weighted`` policy."""
    jp = jpolicies.tier_weighted(jpolicies.POLICIES["lcs_chat"])
    tp = tpolicies.tier_weighted(tpolicies.POLICIES["lcs_chat"])
    assert tp is tpolicies.tier_weighted(tpolicies.POLICIES["lcs_chat"])
    assert tp in tpolicies.VECTOR_POLICIES
    ref = drive(REF, kind, jp, weighted=True)
    port = drive(PORT, kind, tp, weighted=True)
    assert port["victims"]
    assert_same(ref, port)


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_vector_eviction_picks_the_scalar_victims(policy):
    """Inside the port: the columnar index's lexsort evicts what the scalar
    path's stable ``sorted`` evicts, in the same order."""
    skip = ENTRY_SKIP + ("slot",)
    scalar = drive(PORT, "flat", policy, skip=skip)
    vector = drive(PORT, "vector", policy, skip=skip)
    assert scalar["victims"]
    assert_same(scalar, vector)


@pytest.mark.parametrize("policy", POLICY_NAMES + ("tier_weighted",))
def test_vector_policy_is_its_scalar_twin(policy):
    """Every vector policy gives the float64 values of its scalar twin, over
    the entries a driven store holds, and the reference's values."""
    def scores(pkg):
        pol = pkg["policies"]
        p = pol.tier_weighted(pol.POLICIES["lcs"]) if policy == "tier_weighted" \
            else pol.POLICIES[policy]
        st = make_store(pkg, "vector", p)
        for i, (op, kid, ctx, new, turn, _, _, w) in enumerate(op_stream(1, n=3000)):
            st.account(f"c-{kid}", ctx, ctx + new, 1.7 * i, turn, weight=w)
        now = 1.7 * 3000 + 40.0
        ix = st._ix
        idx = np.nonzero(ix.active)[0]
        fields = {f: np.frombuffer(col, dtype=np.float64, count=ix.cap)[idx]
                  for f, col in ix.cols.items()}
        vec = pol.VECTOR_POLICIES[p](fields, now)
        scal = np.array([p(ix.ents[i], now) for i in idx.tolist()], dtype=np.float64)
        return vec, scal

    jvec, jscal = scores(REF)
    tvec, tscal = scores(PORT)
    assert len(tvec) > 100 and tvec.dtype == np.float64
    assert np.array_equal(tvec, tscal)
    assert np.array_equal(tvec, jvec) and np.array_equal(tscal, jscal)


def test_gradual_resize_and_hit_kinds_match():
    """A shrink staged in steps is consumed by later ``account`` calls; the
    results carry the same ``HitKind``s and matched tokens."""
    out = []
    for pkg in (REF, PORT):
        st = pkg["kvstore"].KVStore(100 * BPT, pkg["policies"].POLICIES["lru"], BPT)
        rows = [plain(st.account(f"k{i % 7}", 10 + i % 5, 14 + i % 5, float(i)))
                for i in range(20)]
        st.schedule_resize(30 * BPT, 20.0, ramp_s=8.0, steps=4)
        rows += [(plain(st.account(f"k{i % 7}", 12, 15, float(i))), st.capacity_bytes,
                  len(st)) for i in range(20, 32)]
        rows.append(plain(st.account("huge", 0, 500, 40.0)))
        out.append((rows, plain(st.stats)))
    assert_same(*out)
    assert out[1][0][-1][1]["kind"] == ("HitKind", "TOO_LARGE")


def test_write_aware_admission_matches():
    """The admission gate on a flat store, priced from the serving model and
    the carbon model of each package."""
    from repro.core.carbon import CarbonModel as JCM
    from repro.serving.perfmodel import SERVING_MODELS as JSM
    from repro_torch.core.carbon import CarbonModel as TCM
    from repro_torch.serving.perfmodel import SERVING_MODELS as TSM
    out = []
    for pkg, sm, cm in ((REF, JSM, JCM), (PORT, TSM, TCM)):
        gate = pkg["storage"].write_aware_admission(sm["llama3-70b"], cm(), "qlc_ssd")
        st = make_store(pkg, "flat", "lcs_chat")
        st.admission = gate
        for i, (_, kid, ctx, new, turn, *_rest) in enumerate(op_stream(2, n=3000)):
            st.account(f"c-{kid % 400}", ctx, ctx + new, 1.7 * i, turn)
        out.append((plain(gate), plain(st.stats), sorted(st.entries)))
    assert_same(*out)


# --------------------------------------------------------------------------- #
# the flight recorder and the carbon ledger
# --------------------------------------------------------------------------- #

def test_exact_partition_matches():
    rng = np.random.default_rng(3)
    for _ in range(50):
        parts = {f"p{i}": float(v) for i, v in enumerate(rng.exponential(10.0, 7))}
        total = float(sum(parts.values()) * (1 + rng.uniform(-1e-12, 1e-12)))
        assert_same(jledger.exact_partition(total, parts),
                    tledger.exact_partition(total, parts))


def test_ledger_from_hours_matches_and_raises_alike():
    def ledger(mod):
        lg = mod.CarbonLedger()
        rng = np.random.default_rng(4)
        for h in range(24):
            comps = rng.uniform(1.0, 50.0, 3)
            lg.add_hour(h, float(comps.sum()),
                        category={"operational": float(comps[0]),
                                  "embodied_cache": float(comps[1]),
                                  "embodied_compute": float(comps[2])},
                        region={"FR": float(comps[0] + comps[1]),
                                "CISO": float(comps[2])})
        return lg

    j, t = ledger(jledger), ledger(tledger)
    assert_same(j.summary(), t.summary())
    assert_same(j.by("category"), t.by("category"))
    j.verify(j.total_g)
    t.verify(t.total_g)
    with pytest.raises(jledger.LedgerError) as je:
        j.verify(j.total_g + 1.0)
    with pytest.raises(tledger.LedgerError) as te:
        t.verify(t.total_g + 1.0)
    assert str(je.value) == str(te.value)


def test_trace_recorder_rows_match():
    def rec(mod):
        r = mod.TraceRecorder(capacity=16)
        rng = np.random.default_rng(5)
        for w in range(4):
            n = 12
            r.record_window(
                rids=np.arange(w * n, (w + 1) * n), arrival=rng.uniform(0, 3600, n),
                ttft=rng.uniform(0.1, 3.0, n), tpot=rng.uniform(0.05, 0.3, n),
                prefill_s=rng.uniform(0.1, 1.0, n), kv_load_s=rng.uniform(0, 0.1, n),
                queue_s=rng.uniform(0, 1.0, n), prompt_tokens=rng.integers(100, 9000, n),
                output_tokens=rng.integers(10, 900, n),
                matched_tokens=rng.integers(0, 100, n),
                hit_kind=rng.integers(0, 4, n), replica=rng.integers(0, 3, n),
                hit_tier=rng.integers(-1, 2, n), energy_j_per_req=1500.0 + w,
                ci_g_per_kwh=33.0, region="FR", tiers=["gold", "standard"] * (n // 2),
                tenants=[f"t{i % 3}" for i in range(n)])
        r.record_event("resize", 10.0, region="FR", cache_tb=4.0)
        return r

    j, t = rec(jtrace), rec(ttrace)
    assert t.n == 48
    assert_same(list(j.rows()), list(t.rows()))
    assert_same(j.summary(), t.summary())
    assert_same(j.events, t.events)
    assert j.percentiles("ttft_s") == t.percentiles("ttft_s")
