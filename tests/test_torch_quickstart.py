"""The port's quickstart (``repro_torch.launch.quickstart``) against the
reference's ``examples/quickstart.py``, on the CPU, and the rules of the
simulator's modules.

Part 1 serves the reduced yi-6b two turns through the port's real engine:
on the reference's weights (converted through numpy) it generates the
reference's tokens and reuses as many. Parts 2 and 3 are the simulator:
the carbon tradeoff's verdicts and the profiled llama3-70b's hourly sizes
must be the reference's, computed here by the reference's functions on the
same inputs, exactly. ``chip_smoke.py``'s GreenCache step runs on a small
grid and must agree with the reference's profile and solve.
"""
import ast
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

from repro.configs import get_config as jget_config
from repro.core.carbon import GRID_CI as JGRID_CI
from repro.core.carbon import CarbonModel as JCarbonModel
from repro.core.kvstore import KVStore as JKVStore
from repro.core.policies import POLICIES as JPOLICIES
from repro.core.profiler import run_profiler as jrun_profiler
from repro.core.solver import solve_cache_schedule as jsolve
from repro.models.transformer import init_params as jinit_params
from repro.serving.perfmodel import SERVING_MODELS as JSERVING_MODELS
from repro.serving.perfmodel import SLOS as JSLOS
from repro.serving.realexec import RealExecutionEngine as JEngine
from repro.workloads import ConversationWorkload as JConversationWorkload
from repro.workloads import DocumentWorkload as JDocumentWorkload
from repro.workloads import azure_rate_trace as jazure_rate_trace
from repro.workloads import ci_trace as jci_trace
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.carbon import CarbonModel
from repro_torch.launch import quickstart
from sim_parity import assert_same

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
# the simulator's modules: host NumPy code that imports no torch
SIMULATOR = ("core/carbon.py", "core/kvstore.py", "core/policies.py", "core/radix.py",
             "core/storage.py", "core/plan.py", "core/profiler.py", "core/solver.py",
             "core/__init__.py", "obs/__init__.py", "obs/ledger.py", "obs/trace.py",
             "serving/perfmodel.py", "serving/engine.py", "serving/cluster.py",
             "serving/__init__.py", "workloads/__init__.py", "workloads/request.py",
             "workloads/tenants.py", "workloads/traces.py", "workloads/conversations.py",
             "workloads/documents.py")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("module", SIMULATOR)
def test_simulator_module_imports_no_torch(module):
    tops = {m.split(".")[0] for m in _imports(PORT / module)}
    assert not tops & {"torch", "jax", "jaxlib", "repro", "msgpack", "triton"}, tops
    assert tops <= {"repro_torch", "numpy", "__future__", "dataclasses", "typing", "enum",
                    "warnings", "math", "time", "itertools", "collections", "functools",
                    "heapq", "zlib", "json", "hashlib", "bisect", "array", "copy"}, tops


def test_quickstart_is_the_one_simulator_entry_on_torch():
    assert "torch" in {m.split(".")[0] for m in _imports(PORT / "launch/quickstart.py")}


# --------------------------------------------------------------------------- #
# part 1: real KV-prefix caching
# --------------------------------------------------------------------------- #

def reference_part1():
    """``examples/quickstart.py``'s part 1, on the JAX package."""
    cfg = jget_config("yi-6b").reduced(num_layers=2, d_model=128)
    params = jinit_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    store = JKVStore(64e6, JPOLICIES["lcs_chat"], cfg.kv_bytes_per_token)
    eng = JEngine(cfg, params, store, max_len=128)
    rng = np.random.default_rng(0)
    turn1 = [int(t) for t in rng.integers(0, cfg.vocab_size, 24)]
    r1 = eng.generate("conv-demo", turn1, num_new=4)
    turn2 = turn1 + r1.tokens + [int(t) for t in rng.integers(0, cfg.vocab_size, 8)]
    r2 = eng.generate("conv-demo", turn2, num_new=4)
    return params, r1, r2


def _counts(r):
    return r.prefill_tokens_computed, r.reused_tokens


def test_part1_generates_and_reuses_the_reference_tokens(capsys):
    jp, j1, j2 = reference_part1()
    cfg = get_config("yi-6b").reduced(num_layers=2, d_model=128)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu", torch.float32)
    t1, t2 = quickstart.part1("cpu", tp)
    assert t1.tokens == j1.tokens and t2.tokens == j2.tokens
    assert _counts(t1) == _counts(j1) == (24, 0)
    assert _counts(t2) == _counts(j2) == (12, 24)
    assert "REUSED 24 cached tokens" in capsys.readouterr().out


def test_part1_on_its_own_weights_reuses_as_the_reference():
    _, j1, j2 = reference_part1()
    t1, t2 = quickstart.part1("cpu")
    assert _counts(t1) == _counts(j1) and _counts(t2) == _counts(j2)
    assert len(t1.tokens) == len(t2.tokens) == 4


def test_part1_runs_on_the_card_or_raises_without_one():
    if torch.cuda.is_available():
        _, r2 = quickstart.part1("cuda")
        assert r2.reused_tokens == 24
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            quickstart.part1()


# --------------------------------------------------------------------------- #
# parts 2 and 3: the simulator
# --------------------------------------------------------------------------- #

def test_part2_verdicts_match_the_reference(capsys):
    rows = quickstart.part2(CarbonModel())
    out = capsys.readouterr().out
    cm = JCarbonModel()
    for (grid, nc, c, verdict) in rows:
        ci = JGRID_CI[grid]
        jnc, jc = cm.total_g(3.1e-4, ci, 0.0, 0.67), cm.total_g(2.8e-4, ci, 16.0, 0.67)
        assert (nc, c) == (jnc, jc)
        jverdict = "cache is GREEN" if jc < jnc else "cache EMITS MORE"
        assert verdict == jverdict
        assert (f"  {grid:5s} (CI={ci:3.0f}): no-cache {jnc:.4f} g, "
                f"16TB-cache {jc:.4f} g -> {jverdict}") in out
    assert [r[0] for r in rows] == ["FR", "ES", "MISO"]
    assert {r[3] for r in rows} == {"cache is GREEN", "cache EMITS MORE"}


def test_part3_profile_and_sizes_match_the_reference(capsys):
    cm = CarbonModel()
    prof = quickstart.profile_chat(cm)
    jcm = JCarbonModel()
    jprof = jrun_profiler(JSERVING_MODELS["llama3-70b"], "conversation",
                          lambda s: JConversationWorkload(seed=s), jcm,
                          rates=[0.4, 1.0, 1.6], sizes_tb=[0, 2, 8, 16],
                          warmup_prompts=6000, meas_seconds=500)
    assert_same(jprof, prof)
    capsys.readouterr()
    solves = quickstart.part3(cm, prof)
    out = capsys.readouterr().out
    rates = [0.3, 0.4, 0.9, 1.5, 1.6, 1.2]
    for grid, res in solves:
        jres = jsolve(jprof, rates, [JGRID_CI[grid]] * 6, JSLOS[("llama3-70b", "chat")], jcm)
        assert_same(jres, res, ("solve_time_s", "explain_data"))
        assert f"  {grid:5s}: hourly cache sizes {jres.sizes_tb} TB (solver={jres.solver}, " \
            in out
    assert [g for g, _ in solves] == ["FR", "CISO"]


def test_main_runs_all_three_parts_on_the_cpu(capsys):
    cm = CarbonModel()
    prof = quickstart.run_profiler(quickstart.SERVING_MODELS["llama3-70b"], "conversation",
                                   lambda s: quickstart.ConversationWorkload(seed=s), cm,
                                   rates=[0.4, 1.6], sizes_tb=[0, 8], warmup_prompts=500,
                                   meas_seconds=100)
    (r1, r2), rows, solves = quickstart.main("cpu", prof=prof)
    out = capsys.readouterr().out
    assert r2.reused_tokens == 24 and len(rows) == 3 and len(solves) == 2
    for title in ("1) Real KV-prefix caching (reduced yi-6b, cpu)", "2) The carbon tradeoff",
                  "3) One carbon-aware sizing decision"):
        assert title in out


# --------------------------------------------------------------------------- #
# chip_smoke.py's GreenCache step, on a small grid
# --------------------------------------------------------------------------- #

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_greencache_step_matches_the_reference(capsys):
    """The step's checks hold on a small grid, and its schedules are the
    reference's profile-and-solve on the same inputs."""
    cs = _chip_smoke()
    assert (cs.GC_RATES, cs.GC_SIZES_TB, cs.GC_WARMUP) == (
        (0.2, 0.6, 1.0, 1.3, 1.6), (0, 1, 2, 4, 8, 12, 16), 12000)
    rates, sizes = (0.4, 1.0), (0, 4, 8)
    out = cs.greencache_phase("cpu", rates=rates, sizes_tb=sizes, warmup=1000)
    log = capsys.readouterr().out
    assert "_solve_dp == _solve_dp_reference, exhaustive and pruned" in log
    jcm = JCarbonModel()
    factories = {"conversation": ("chat", lambda s: JConversationWorkload(seed=s)),
                 "document": ("doc", lambda s: JDocumentWorkload(seed=s, zipf_alpha=0.4))}
    for task, (kind, factory) in factories.items():
        jprof = jrun_profiler(JSERVING_MODELS["llama3-70b"], task, factory, jcm,
                              rates=list(rates), sizes_tb=list(sizes), warmup_prompts=1000)
        jres = jsolve(jprof, list(jazure_rate_trace(1.0, seed=3)), list(jci_trace("FR", seed=4)),
                      JSLOS[("llama3-70b", kind)], jcm)
        got = out[task]
        assert got["sizes_tb"] == jres.sizes_tb and len(got["sizes_tb"]) == 24
        assert (got["solver"], got["objective_g"], got["feasible"]) == (
            jres.solver, jres.objective_g, jres.feasible)
        assert f"hourly sizes, TB: {jres.sizes_tb}" in log
