"""Training of the PyTorch port against the JAX package, on the CPU.

Reduced configs in fp32; the JAX model's weights (and optimizer state)
reach the port through ``repro_torch.convert``, batches come from both
packages' ``batch_iterator`` (and must be the same arrays). Gradients and
losses are compared, not parameters after several steps: at its first
steps AdamW is nearly sign-like, so tiny gradient differences flip updates.

Tolerances:

* ``TOL`` = 3e-4, the model tolerance of ``tests/test_torch_models.py``
  (fp32; the port's attention keeps fp32 probabilities for P·V where the
  reference's jnp attention casts them to ``v.dtype``, and sums in other
  orders). Losses are held to it relatively; each gradient leaf to it
  relative to the leaf's largest entry.
* ``OPT_TOL`` = 1e-6 for one AdamW update and the learning rate: both
  sides do the same fp32 operations on the same inputs, so only a fused
  multiply-add or a transcendental's last bit may differ.
* ``FLASH_BWD_TOL`` = 2e-5, ``cases.TOL`` in fp32 (the sweep of
  ``tests/test_kernels.py``), for the flash backward's plain version
  against ``jax.vjp`` of the reference's ``flash_attention_ref``.
"""
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

from repro.configs import get_config as jget_config
from repro.kernels import ref as jref
from repro.models import transformer as jt
from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.kernels import cases, ops, ref
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train import steps as tsteps
from repro_torch.train import tree

TOL = 3e-4
OPT_TOL = 1e-6
FLASH_BWD_TOL = cases.TOL[torch.float32]

# one arch of each family; danube's reduced window (64) binds at SEQ
FAMILIES = {"dense": "h2o-danube-1.8b", "moe": "dbrx-132b", "ssm": "rwkv6-1.6b",
            "hybrid": "recurrentgemma-2b", "vlm": "qwen2-vl-2b",
            "encdec": "seamless-m4t-large-v2"}
BATCH, SEQ = 2, 72


def _configs(arch):
    layers = 4 if get_config(arch).family == "hybrid" else 2
    return (jget_config(arch).reduced(num_layers=layers, d_model=64),
            get_config(arch).reduced(num_layers=layers, d_model=64))


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _setup(arch, seed=0):
    jcfg, cfg = _configs(arch)
    jparams = jt.init_params(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    batch = next(jdata.batch_iterator(jcfg, BATCH, SEQ, seed=seed))
    return jcfg, cfg, jparams, batch


def _grads_port(params, cfg, batch):
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = tsteps.loss_fn(params, cfg, tdata.batch_to(batch, "cpu"))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, metrics, [torch.zeros_like(p) if g is None else g
                           for g, p in zip(grads, leaves)]


def _close_rel(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=what)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_reference(family):
    jcfg, cfg, jparams, batch = _setup(FAMILIES[family])
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jsteps.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jparams)
    params = params_from_jax(_np(jparams), cfg, device="cpu")
    loss, metrics, grads = _grads_port(params, cfg, batch)
    _close_rel(loss.detach(), jloss, TOL, "loss")
    assert float(metrics["tokens"]) == float(jmetrics["tokens"]) == BATCH * SEQ
    if family == "moe":
        for k in ("load_balance_loss", "router_z_loss"):
            _close_rel(metrics[k].detach(), jmetrics[k], TOL, k)
    want = tree.items(_np(jgrads))
    assert [k for k, _ in want] == [k for k, _ in tree.items(params)]
    for (key, w), g in zip(want, grads):
        _close_rel(g.numpy(), w, TOL, key)


@pytest.mark.parametrize("S", [300, 512])
def test_chunked_softmax_xent_matches_reference(S):
    """S = 300 is no multiple of LOSS_CHUNK (one chunk of S), 512 two chunks;
    a fifth of the labels are IGNORE_LABEL."""
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, S, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 200)) * 0.2).astype(np.float32)
    lab = rng.integers(0, 200, (2, S)).astype(np.int32)
    lab[rng.random((2, S)) < 0.2] = jsteps.IGNORE_LABEL

    def jloss(h, w):
        nll, cnt = jsteps.chunked_softmax_xent(h, w, jnp.asarray(lab))
        return nll / cnt, (nll, cnt)
    (_, (jn, jc)), (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(w))
    th, tw = (torch.from_numpy(x).requires_grad_(True) for x in (h, w))
    n, c = tsteps.chunked_softmax_xent(th, tw, torch.from_numpy(lab).long())
    gh, gw = torch.autograd.grad(n / c, (th, tw))
    assert tsteps.IGNORE_LABEL == jsteps.IGNORE_LABEL and tsteps.LOSS_CHUNK == jsteps.LOSS_CHUNK
    assert float(c) == float(jc) == float((lab != -1).sum())
    _close_rel(n.detach(), jn, TOL, "nll")
    _close_rel(gh, jgh, TOL, "d hidden")
    _close_rel(gw, jgw, TOL, "d w_unembed")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """One update from a state three steps in, on 2-d leaves (decayed) and
    a 1-d one (not), with clipping active."""
    rng = np.random.default_rng(4)
    shapes = {"a": {"w": (6, 5), "scale": (5,)}, "b": (3, 4, 2)}
    mk = lambda s: rng.standard_normal(s).astype(np.float32)
    params = jax.tree.map(lambda s: mk(s), shapes, is_leaf=lambda x: isinstance(x, tuple))
    grads = jax.tree.map(lambda s: 3 * mk(s), shapes, is_leaf=lambda x: isinstance(x, tuple))
    mu = jax.tree.map(lambda s: 0.1 * mk(s), shapes, is_leaf=lambda x: isinstance(x, tuple))
    nu = jax.tree.map(lambda s: np.abs(0.1 * mk(s)), shapes,
                      is_leaf=lambda x: isinstance(x, tuple))
    cfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20)
    jdt = jnp.dtype(dtype)
    jp, jg = (jax.tree.map(lambda x: jnp.asarray(x, jdt), t) for t in (params, grads))
    state = jopt.AdamWState(jnp.asarray(3, jnp.int32), jax.tree.map(jnp.asarray, mu),
                            jax.tree.map(jnp.asarray, nu))
    jnew, jstate, jm = jopt.adamw_update(cfg, jg, state, jp)

    tdt = getattr(torch, dtype)
    tp, tg = (tree.map_leaves(t, lambda x: torch.from_numpy(x).to(tdt)) for t in (params, grads))
    tstate = opt_state_from_jax(_np(state), device="cpu")
    assert tstate.step == 3
    tnew, tstate2, tm = topt.adamw_update(topt.AdamWConfig(**vars(cfg)), tg, tstate, tp)
    assert tstate2.step == 4 and tnew is tp
    _close_rel(tm["grad_norm"], jm["grad_norm"], OPT_TOL, "grad_norm")
    _close_rel(tm["lr"], jm["lr"], OPT_TOL, "lr")
    ulp = OPT_TOL if dtype == "float32" else 2.0 ** -8       # one bf16 rounding
    for (key, w), g in zip(tree.items(_np(jax.tree.map(lambda x: x.astype(jnp.float32),
                                                       jnew))), tree.leaves(tnew)):
        np.testing.assert_allclose(g.float().numpy(), w, rtol=ulp, atol=ulp * 1e-3,
                                   err_msg=key)
    for jt_, tt_ in ((jstate.mu, tstate2.mu), (jstate.nu, tstate2.nu)):
        for (key, w), g in zip(tree.items(_np(jt_)), tree.leaves(tt_)):
            _close_rel(g.numpy(), w, OPT_TOL, key)


def test_lr_schedule_matches_reference():
    cfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    tcfg = topt.AdamWConfig(**vars(cfg))
    for s in (0, 5, 10, 50, 100):
        want = float(jopt.lr_schedule(cfg, jnp.asarray(s)))
        got = topt.lr_schedule(tcfg, s)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=OPT_TOL, err_msg=str(s))


def test_three_steps_from_the_same_state_match_reference():
    """One reference step, then both packages take three more from its
    params and optimizer state; each step's loss must agree."""
    arch = "yi-6b"
    jcfg, cfg, jparams, _ = _setup(arch, seed=1)
    ocfg = jopt.AdamWConfig(lr=1e-3, total_steps=10, warmup_steps=1)
    jstep = jax.jit(jsteps.make_train_step(jcfg, ocfg))
    it = jdata.batch_iterator(jcfg, BATCH, SEQ, seed=1)
    jopt_state = jopt.adamw_init(jparams)
    jparams, jopt_state, _ = jstep(jparams, jopt_state,
                                   {k: jnp.asarray(v) for k, v in next(it).items()})
    params = params_from_jax(_np(jparams), cfg, device="cpu")
    state = opt_state_from_jax(_np(jopt_state), device="cpu")
    tstep = tsteps.make_train_step(cfg, topt.AdamWConfig(**vars(ocfg)))
    for i in range(3):
        batch = next(it)
        jparams, jopt_state, jm = jstep(jparams, jopt_state,
                                        {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, m = tstep(params, state, tdata.batch_to(batch, "cpu"))
        for k in ("loss", "grad_norm", "lr"):
            _close_rel(m[k], jm[k], TOL, f"step {i}: {k}")
    assert state.step == int(jopt_state.step) == 4


@pytest.mark.parametrize("arch", ["yi-6b", "qwen2-vl-2b", "seamless-m4t-large-v2"])
def test_batch_iterator_gives_the_reference_arrays(arch):
    jcfg, cfg = _configs(arch)
    a, b = (jdata.batch_iterator(jcfg, 3, 40, seed=5), tdata.batch_iterator(cfg, 3, 40, seed=5))
    for _ in range(3):
        want, got = next(a), next(b)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_checkpoint_moves_both_ways(tmp_path):
    """A directory the reference writes restores in the port and the other
    way round, leaf for leaf; the port's manifest is the bytes msgpack
    writes."""
    jcfg, cfg = _configs("recurrentgemma-2b")
    jparams = jt.init_params(jax.random.PRNGKey(2), jcfg, jnp.float32)
    like = params_from_jax(_np(jparams), cfg, device="cpu")
    jckpt.save_checkpoint(str(tmp_path / "from_jax"), jparams, step=7)
    got, step = tckpt.restore_checkpoint(str(tmp_path / "from_jax"), tree.map_leaves(
        like, torch.zeros_like))
    assert step == 7
    for (key, w), g in zip(tree.items(_np(jparams)), tree.leaves(got)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=key)

    tckpt.save_checkpoint(str(tmp_path / "from_torch"), like, step=9)
    raw = (tmp_path / "from_torch" / "manifest.msgpack").read_bytes()
    jraw = (tmp_path / "from_jax" / "manifest.msgpack").read_bytes()
    assert tckpt.unpackb(raw) == dict(msgpack.unpackb(jraw), step=9)
    assert raw == msgpack.packb(tckpt.unpackb(raw))
    back, step = jckpt.restore_checkpoint(str(tmp_path / "from_torch"), jparams)
    assert step == 9
    for (key, w), g in zip(tree.items(_np(back)), tree.leaves(like)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=key)


@pytest.mark.parametrize("case", cases.FLASH_BWD)
def test_flash_bwd_plain_version_matches_reference_vjp(case):
    """The plain backward, the wrapper on the CPU, and the closed form the
    backward kernels compute from the training forward's lse
    (ref.flash_attention_bwd_lse_ref fed ops.flash_attention_train's
    output and lse) against jax.vjp of the reference's flash_attention_ref
    (empty bands and non-causal rows included)."""
    q, k, v, dout = cases.flash_bwd_inputs(case, torch.float32, "cpu")
    off, win, causal = case[6:]
    kw = dict(q_offset=off, window=win, causal=causal)
    _, vjp = jax.vjp(lambda q, k, v: jref.flash_attention_ref(q, k, v, **kw),
                     *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(dout.numpy()))
    out, lse = ops.flash_attention_train(q, k, v, **kw)
    for got in (ref.flash_attention_bwd_ref(q, k, v, dout, **kw),
                ops.flash_attention_bwd(q, k, v, out, dout, **kw),
                ref.flash_attention_bwd_lse_ref(q, k, v, out, lse, dout, **kw)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=FLASH_BWD_TOL,
                                       atol=FLASH_BWD_TOL)
