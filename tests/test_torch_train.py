"""The port's training substrate on the CPU: twins of ``tests/test_train.py``
and of ``tests/test_models_smoke.py::test_one_train_step``, the ``remat``
and ``inference_mode`` behaviour of ``forward``, the launchers' refusals,
and the kernels without a backward staying differentiable on the CPU.
(Parity with the JAX package: ``tests/test_torch_train_parity.py``.)"""
import collections

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.kernels import cases, ops
from repro_torch.launch import serve
from repro_torch.launch import train as launch_train
from repro_torch.launch import train_100m
from repro_torch.models import transformer as tt
from repro_torch.train import tree
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.data import SyntheticCorpus, batch_iterator, batch_to, make_batch_for
from repro_torch.train.optimizer import (AdamWConfig, adamw_init, adamw_update,
                                         global_norm, lr_schedule)
from repro_torch.train.steps import init_train_state, loss_fn, make_train_step

B, S = 2, 16


# --------------------------------------------------------------------------- #
# twins of tests/test_train.py
# --------------------------------------------------------------------------- #

def test_loss_decreases_tiny_model():
    cfg = get_config("yi-6b").reduced(num_layers=2, d_model=64)
    params, opt = init_train_state(0, cfg, torch.float32, device="cpu")
    step = make_train_step(cfg, AdamWConfig(lr=2e-3, total_steps=60, warmup_steps=5))
    it = batch_iterator(cfg, batch=4, seq=32, seed=0)
    losses = []
    for _ in range(45):
        params, opt, m = step(params, opt, batch_to(next(it), "cpu"))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.1


def test_adamw_moves_toward_minimum():
    params = {"w": torch.tensor([4.0, -3.0])}
    opt = adamw_init(params)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                      total_steps=1000, min_lr_frac=1.0)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}          # d/dw of w^2
        params, opt, _ = adamw_update(cfg, grads, opt, params)
    assert float(params["w"].abs().max()) < 0.5


def test_lr_schedule_warmup_and_decay():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(lr_schedule(cfg, s)) for s in [0, 5, 10, 50, 100]]
    assert lrs[0] < lrs[1] < lrs[2]
    assert lrs[2] >= lrs[3] >= lrs[4]
    assert lrs[4] >= cfg.lr * cfg.min_lr_frac * 0.99


def test_global_norm():
    t = {"a": torch.ones((2, 2)), "b": torch.ones((3,))}
    assert float(global_norm(t)) == np.sqrt(7.0).astype(np.float32)


def test_checkpoint_roundtrip(tmp_path):
    cfg = get_config("rwkv6-1.6b").reduced(num_layers=2, d_model=64)
    params, _ = init_train_state(1, cfg, torch.float32, device="cpu")
    save_checkpoint(str(tmp_path), params, step=42)
    restored, step = restore_checkpoint(str(tmp_path), params)
    assert step == 42
    for a, b in zip(tree.leaves(params), tree.leaves(restored)):
        assert torch.equal(a, b)


def test_synthetic_corpus_learnable_structure():
    c = SyntheticCorpus(256, seed=0)
    s = c.stream(0)
    toks = [next(s) for _ in range(5000)]
    # Markov structure: successor entropy < uniform
    pairs = collections.Counter(zip(toks[:-1], toks[1:]))
    succ = collections.defaultdict(set)
    for (a, b), _ in pairs.items():
        succ[a].add(b)
    avg_succ = np.mean([len(v) for v in succ.values()])
    assert avg_succ < 64          # far fewer than vocab=256


# --------------------------------------------------------------------------- #
# twin of tests/test_models_smoke.py::test_one_train_step
# --------------------------------------------------------------------------- #

def reduced_cfg(arch):
    nl = 4 if get_config(arch).family == "hybrid" else 2
    return get_config(arch).reduced(num_layers=nl, d_model=256)


def mk_batch(cfg):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return batch_to(make_batch_for(cfg, toks, labels), "cpu")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_one_train_step(arch):
    cfg = reduced_cfg(arch)
    params, opt = init_train_state(0, cfg, torch.float32, device="cpu")
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, total_steps=10, warmup_steps=1))
    l0 = tree.leaves(params)[0].detach().clone()
    params2, opt2, metrics = step(params, opt, mk_batch(cfg))
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    # params actually changed (in place: params2 is params)
    assert params2 is params and opt2.step == 1
    assert not torch.allclose(l0, tree.leaves(params2)[0])


# --------------------------------------------------------------------------- #
# forward's remat and inference behaviour
# --------------------------------------------------------------------------- #

REMAT_ARCHS = ["h2o-danube-1.8b", "dbrx-132b", "rwkv6-1.6b", "recurrentgemma-2b",
               "qwen2-vl-2b", "seamless-m4t-large-v2"]


def _small(arch):
    cfg = get_config(arch)
    return cfg.reduced(num_layers=4 if cfg.family == "hybrid" else 2, d_model=64)


def _loss_and_grads(params, cfg, batch, remat):
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    hidden, aux = tt.forward(params, cfg, batch, remat=remat, return_hidden=True,
                             with_aux=True)
    loss = hidden.float().square().mean() + sum(aux.values(), torch.zeros(()))
    return loss, torch.autograd.grad(loss, leaves, allow_unused=True)


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_gives_the_same_loss_and_gradients(arch, monkeypatch):
    """remat=True recomputes every layer in the backward (checkpoint is
    entered once per layer, unit or decoder layer) and changes no bit of the
    loss or the gradients."""
    cfg = _small(arch)
    params, _ = init_train_state(0, cfg, torch.float32, device="cpu")
    batch = batch_to(next(batch_iterator(cfg, 2, 72, seed=0)), "cpu")
    calls = []
    real = tt.checkpoint
    monkeypatch.setattr(tt, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    got = _loss_and_grads(params, cfg, batch, remat=True)
    U, tail = tt.griffin_layout(cfg)
    assert len(calls) == (U + tail if cfg.family == "hybrid" else cfg.num_layers)
    want = _loss_and_grads(params, cfg, batch, remat=False)
    assert len(calls) == (U + tail if cfg.family == "hybrid" else cfg.num_layers)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        assert (g is None and w is None) or torch.equal(g, w)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "dbrx-132b", "recurrentgemma-2b",
                                  "seamless-m4t-large-v2"])
def test_forward_under_inference_mode_is_unchanged(arch, monkeypatch):
    """Under inference_mode the remat flag changes nothing: no checkpoint,
    no graph, the same logits bit for bit, no kernel launch counted."""
    cfg = _small(arch)
    params = tt.init_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    batch = batch_to(next(batch_iterator(cfg, 2, 40, seed=0)), "cpu")
    before = {n: getattr(ops, n).launches for n in ops.__all__}
    monkeypatch.setattr(tt, "checkpoint", None)     # calling it would raise
    with torch.inference_mode():
        a = tt.forward(params, cfg, batch)
        b = tt.forward(params, cfg, batch, remat=False)
    assert not a.requires_grad and torch.equal(a, b)
    assert {n: getattr(ops, n).launches for n in ops.__all__} == before


def test_stacked_leaves_get_each_layers_gradient():
    """unstack_layers' views carry each layer's gradient into its slice of
    the stacked leaf."""
    w = torch.randn(3, 4, 5, requires_grad=True)
    layers = tt.unstack_layers({"a": {"w": w}})
    loss = sum((i + 1) * layers[i]["a"]["w"].sum() for i in range(3))
    (g,) = torch.autograd.grad(loss, [w])
    assert torch.equal(g, torch.arange(1.0, 4.0)[:, None, None].expand(3, 4, 5))


def test_loss_fn_counts_text_tokens_only_for_vlm():
    cfg = _small("qwen2-vl-2b")
    params, _ = init_train_state(0, cfg, torch.float32, device="cpu")
    batch = batch_to(next(batch_iterator(cfg, 2, 24, seed=0)), "cpu")
    _, m = loss_fn(params, cfg, batch)
    assert float(m["tokens"]) == 2 * 24 and m["loss"] is m["total_loss"]


# --------------------------------------------------------------------------- #
# launchers
# --------------------------------------------------------------------------- #

def test_train_launcher_on_cpu_saves_and_restores(tmp_path):
    argv = ["--device", "cpu", "--reduced", "--layers", "2", "--d-model", "32",
            "--batch", "2", "--seq", "16", "--steps", "3", "--log-every", "1",
            "--checkpoint", str(tmp_path)]
    losses = launch_train.main(argv)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert (tmp_path / "manifest.msgpack").is_file()
    # restored at step 3, one step to go
    assert len(launch_train.main(argv + ["--steps", "4", "--restore"])) == 1


def test_train_launcher_refuses_where_it_cannot_train(monkeypatch):
    yi, danube = get_config("yi-6b"), get_config("h2o-danube-1.8b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        launch_train.train_device("cuda", danube)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    # yi-6b: 6.06B parameters x 12 B of bf16 state is 72.7 GB before the
    # update's temporaries; in fp32 97 GB
    assert 72.7e9 < 12 * 6.06e9 < serve.CARD_BYTES < serve.train_bytes(yi)
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="more than one card"):
            launch_train.train_device("cuda", yi, dtype)
    assert launch_train.train_device("cuda", danube, torch.bfloat16).type == "cuda"
    # the recurrent families train on the card through their backward
    # kernels, their states counted with the fp32 leaves in fp32
    for arch in ("rwkv6-1.6b", "recurrentgemma-2b"):
        cfg = get_config(arch)
        assert serve.train_bytes(cfg) < serve.CARD_BYTES
        assert launch_train.train_device("cuda", cfg, torch.bfloat16).type == "cuda"
    assert launch_train.train_device("cpu", get_config("rwkv6-1.6b")).type == "cpu"


def test_train_bytes_of_danube():
    """1.831B parameters x 12 B (bf16 weights and gradients, fp32 moments)
    plus two fp32 copies of the (24, 2560, 6912) leaf."""
    cfg = get_config("h2o-danube-1.8b")
    n = serve.weight_bytes(cfg) // 2
    assert 1.83e9 < n < 1.832e9
    assert serve.train_bytes(cfg) == 12 * n + 2 * 4 * 24 * 2560 * 6912


def test_train_100m_twin_passes_the_examples_flags(monkeypatch):
    seen = []
    monkeypatch.setattr(train_100m, "train_main", lambda argv: seen.append(argv) or [5.0, 4.0])
    assert train_100m.main(["--device", "cpu", "--steps", "7"]) == [5.0, 4.0]
    argv = seen[0]
    flag = lambda f: argv[argv.index(f) + 1]
    assert (flag("--layers"), flag("--d-model"), flag("--batch"), flag("--seq"),
            flag("--steps"), flag("--device")) == ("12", "768", "4", "256", "7", "cpu")
    assert "--reduced" in argv and flag("--checkpoint") == str(train_100m.CHECKPOINT)
    # the kernel row of its attention (cases.FLASH_BWD_TRAIN)
    cfg = get_config("yi-6b").reduced(num_layers=12, d_model=768)
    assert cases.FLASH_BWD_TRAIN["100M twin"] == (
        4, cfg.num_heads, cfg.num_kv_heads, 256, 256, cfg.head_dim, 0, None, True)
    monkeypatch.setattr(train_100m, "train_main", lambda argv: [4.0, 4.5])
    with pytest.raises(AssertionError, match="loss should decrease"):
        train_100m.main(["--device", "cpu"])


def test_training_shapes_are_the_configs():
    d = get_config("h2o-danube-1.8b")
    assert cases.FLASH_BWD_TRAIN["h2o-danube-1.8b"] == (
        1, d.num_heads, d.num_kv_heads, 8192, 8192, d.head_dim, 0, d.window_size, True)
    e = get_config("seamless-m4t-large-v2")
    assert cases.FLASH_BWD_TRAIN["enc-dec cross"] == (
        1, e.num_heads, e.num_kv_heads, 512, e.source_len, e.head_dim, 0, None, False)


# --------------------------------------------------------------------------- #
# the kernels without a backward stay differentiable on the CPU
# --------------------------------------------------------------------------- #

def _grad_flows(fn, inputs):
    inputs = [t.requires_grad_(True) if t.is_floating_point() else t for t in inputs]
    out = fn(*inputs)
    out = out if isinstance(out, torch.Tensor) else out[0]
    grads = torch.autograd.grad(out.float().sum(), [t for t in inputs if t.requires_grad])
    return all(torch.isfinite(g).all() for g in grads)


def test_kernels_without_backward_are_differentiable_on_cpu():
    q, k, v, valid = cases.decode_inputs(cases.DECODE_SWEEP[0], torch.float32, "cpu")
    assert _grad_flows(ops.decode_attention, [q, k.detach().clone(), v.detach().clone(), valid])
    assert _grad_flows(ops.wkv6, cases.wkv6_inputs(cases.WKV6_SWEEP[0], "cpu"))
    assert _grad_flows(ops.rglru_scan, cases.rglru_inputs(cases.RGLRU_SWEEP[0], "cpu"))
    assert _grad_flows(ops.rglru_step, cases.rglru_step_inputs(cases.RGLRU_STEP[3], "cpu"))


def test_flash_attention_on_cpu_is_its_plain_versions_autograd():
    case = cases.FLASH_EMPTY_BAND[2]
    q, k, v, dout = cases.flash_bwd_inputs(case, torch.float32, "cpu")
    kw = dict(q_offset=case[6], window=case[7], causal=case[8])
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention(*leaves, **kw), leaves, dout)
    for g, w in zip(got, ops.flash_attention_bwd(q, k, v, None, dout, **kw)):
        assert torch.equal(g, w)
