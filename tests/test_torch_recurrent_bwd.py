"""The recurrent kernels' gradients in the PyTorch port, on the CPU.

The plain versions of the two backward kernels (``ref.wkv6_bwd_ref``,
``ref.rglru_scan_bwd_ref``) and of the wkv6 training entry
(``ref.wkv6_train_ref``) are held against ``jax.vjp`` of the JAX package's
``repro.kernels.ref.wkv6_ref`` and ``rglru_scan_ref`` (the reference takes
both gradients by autodiff of its scans) and against ``torch.autograd`` of
the port's forward plain versions, at every case of
``repro_torch.kernels.cases.WKV6_BWD`` and ``RGLRU_BWD``: fp32 gradients at
``WKV6_TOL`` (1e-4, tests/test_kernels.py::test_wkv6_sweep) and
``RGLRU_TOL`` (1e-5, ::test_rglru_sweep), bf16 ones at ``TOL[bf16]``.
The autograd Functions that wrap the kernels on the card are driven here
with their launches standing in as the plain versions, so that what they
save and return is checked without a card. The CUDA kernels themselves are
held against the plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py), through the same case tables.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import cases, ops, ref
from repro_torch.kernels import rglru as rglru_mod
from repro_torch.kernels import wkv6 as wkv6_mod

GRADS = ("r", "k", "v", "w", "u", "s0")


def _tol(t):
    return cases.TOL[torch.bfloat16] if t.dtype == torch.bfloat16 else cases.WKV6_TOL


def _f32(t):
    return t.detach().float().contiguous().numpy()


@pytest.mark.parametrize("case", cases.WKV6_BWD)
def test_wkv6_bwd_plain_version_matches_reference_vjp(case):
    """wkv6_bwd_ref on the plain training entry's checkpoints against
    jax.vjp of the reference's wkv6_ref (fp32 on the bf16 values), and
    against torch.autograd of the port's wkv6_ref."""
    inputs, dy, dsn = cases.wkv6_bwd_inputs(case, "cpu")
    _, _, ckpt = ref.wkv6_train_ref(*inputs, ref.WKV6_EVERY)
    got = ref.wkv6_bwd_ref(*inputs, ckpt, dy, dsn)
    for g, t in zip(got, inputs):
        assert g.shape == t.shape and g.dtype == t.dtype
    _, vjp = jax.vjp(jref.wkv6_ref, *(jnp.asarray(_f32(t)) for t in inputs))
    zero = np.zeros(inputs[5].shape, np.float32)
    want = vjp((jnp.asarray(_f32(dy)), jnp.asarray(zero if dsn is None else _f32(dsn))))
    for n, g, w in zip(GRADS, got, want):
        cases.held(f"d{n} vs jax.vjp", case, g.float(), torch.from_numpy(np.array(w)),
                   _tol(g))
    cases.check_wkv6_bwd(case, "cpu")         # and torch.autograd of ref.wkv6_ref


@pytest.mark.parametrize("case", cases.WKV6_BWD)
def test_wkv6_train_plain_version_keeps_the_output_and_checkpoints_each_state(case):
    inputs = cases.wkv6_inputs(case[:8], "cpu")
    y, sn, ckpt = ref.wkv6_train_ref(*inputs, ref.WKV6_EVERY)
    want_y, want_sn = ref.wkv6_ref(*inputs)
    assert torch.equal(y, want_y) and torch.equal(sn, want_sn)
    B, H, S, hd = case[:4]
    assert ckpt.shape == (B, H, -(-S // ref.WKV6_EVERY), hd, hd)
    r, k, v, w, u, s0 = inputs
    for c in range(ckpt.shape[2]):
        t = c * ref.WKV6_EVERY               # the state after t steps
        _, st = ref.wkv6_ref(r[:, :, :t], k[:, :, :t], v[:, :, :t], w[:, :, :t], u, s0)
        assert torch.equal(ckpt[:, :, c], st)
    assert cases.check_wkv6_train(case, "cpu") == 0.0


@pytest.mark.parametrize("case", cases.RGLRU_BWD)
def test_rglru_bwd_plain_version_matches_reference_vjp(case):
    (a, b, h0), dy, dh = cases.rglru_bwd_inputs(case, "cpu")
    y, _ = ref.rglru_scan_ref(a, b, h0)
    got = ref.rglru_scan_bwd_ref(a, h0, y, dy, dh)
    _, vjp = jax.vjp(jref.rglru_scan_ref, *(jnp.asarray(_f32(t)) for t in (a, b, h0)))
    zero = np.zeros(h0.shape, np.float32)
    want = vjp((jnp.asarray(_f32(dy)), jnp.asarray(zero if dh is None else _f32(dh))))
    for n, g, w in zip(("a", "b", "h0"), got, want):
        cases.held(f"d{n} vs jax.vjp", case, g, torch.from_numpy(np.array(w)),
                   cases.RGLRU_TOL)
    cases.check_rglru_bwd(case, "cpu")        # and torch.autograd of ref.rglru_scan_ref


def test_wkv6_bwd_never_divides_by_the_decay():
    """w = 0 at every step: the plain version recomputes the states forward
    from the checkpoints, so nothing is divided by w and every gradient is
    finite (dr_t = (S_t + u k_t v_tᵀ) dy_t with S_t = k_{t-1} v_{t-1}ᵀ)."""
    case = (1, 2, 40, 32, 0.0, 0.1, "bhsd", "fp32", "random")
    inputs, dy, dsn = cases.wkv6_bwd_inputs(case, "cpu")
    _, _, ckpt = ref.wkv6_train_ref(*inputs, ref.WKV6_EVERY)
    got = ref.wkv6_bwd_ref(*inputs, ckpt, dy, dsn)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    r, k, v, _, u, _ = inputs
    t = 21
    st = k[:, :, t - 1, :, None] * v[:, :, t - 1, None, :]
    eff = st + u[None, :, :, None] * k[:, :, t, :, None] * v[:, :, t, None, :]
    want = torch.einsum("bhij,bhj->bhi", eff, dy[:, :, t])
    torch.testing.assert_close(got[0][:, :, t], want, rtol=1e-5, atol=1e-5)


def test_backward_wrappers_take_the_plain_versions_on_cpu():
    case = cases.WKV6_BWD[1]
    inputs, dy, dsn = cases.wkv6_bwd_inputs(case, "cpu")
    (a, b, h0), gy, dh = cases.rglru_bwd_inputs(cases.RGLRU_BWD[1], "cpu")
    counts = (ops.wkv6.launches, ops.wkv6_bwd.launches, ops.rglru_scan_bwd.launches)
    y, sn, ckpt = ops.wkv6_train(*inputs)
    assert all(torch.equal(x, w) for x, w in zip((y, sn, ckpt), ref.wkv6_train_ref(
        *inputs, ref.WKV6_EVERY)))
    for x, w in zip(ops.wkv6_bwd(*inputs, ckpt, dy, dsn),
                    ref.wkv6_bwd_ref(*inputs, ckpt, dy, dsn)):
        assert torch.equal(x, w)
    ys, _ = ops.rglru_scan(a, b, h0)
    for x, w in zip(ops.rglru_scan_bwd(a, h0, ys, gy, dh),
                    ref.rglru_scan_bwd_ref(a, h0, ys, gy, dh)):
        assert torch.equal(x, w)
    assert (ops.wkv6.launches, ops.wkv6_bwd.launches, ops.rglru_scan_bwd.launches) == counts
    assert "wkv6_bwd" in ops.__all__ and "rglru_scan_bwd" in ops.__all__


def _grads(fn, leaves, outs_grads):
    with torch.enable_grad():
        outs = fn(*leaves)
        pairs = [(o, g) for o, g in zip(outs, outs_grads) if g is not None]
        return torch.autograd.grad([o for o, _ in pairs], leaves, [g for _, g in pairs])


@pytest.mark.parametrize("with_dsn", [False, True])
def test_wkv6_autograd_function_saves_and_returns_what_the_kernels_need(monkeypatch,
                                                                        with_dsn):
    """Wkv6Fn with its launches standing in as the plain versions (the
    training entry's (y, s_n, ckpt) and wkv6_bwd_ref): the gradients of
    autograd of wkv6_ref, with ds_n None where s_n does not reach the loss,
    as the model's training passes it."""
    seen = {}

    def launch(r, k, v, w, u, s0, train=False):
        assert train
        return ref.wkv6_train_ref(r, k, v, w, u, s0, ref.WKV6_EVERY)

    def launch_bwd(r, k, v, w, u, ckpt, dy, ds_n):
        seen["ds_n"] = ds_n
        return ref.wkv6_bwd_ref(r, k, v, w, u, None, ckpt, dy, ds_n)

    monkeypatch.setattr(wkv6_mod, "_launch", launch)
    monkeypatch.setattr(wkv6_mod, "_launch_bwd", launch_bwd)
    case = (2, 3, 37, 32, None, 0.1, "bshd", "bf16", "random" if with_dsn else "zero")
    inputs, dy, dsn = cases.wkv6_bwd_inputs(case, "cpu")
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    got = _grads(wkv6_mod.Wkv6Fn.apply, leaves, (dy, dsn))
    want = _grads(ref.wkv6_ref, leaves, (dy, dsn))
    assert (seen["ds_n"] is None) == (not with_dsn)
    for n, g, w in zip(GRADS, got, want):
        cases.held(f"Wkv6Fn d{n}", case, g, w, _tol(w))


@pytest.mark.parametrize("with_dh", [False, True])
def test_rglru_autograd_function_saves_and_returns_what_the_kernel_needs(monkeypatch,
                                                                          with_dh):
    """RglruScanFn with its launches standing in as the plain versions: the
    gradients of autograd of rglru_scan_ref, dh_S None where h_S does not
    reach the loss, the kernel fed the saved a, h0 and output y."""
    seen = {}

    def launch_bwd(a, h0, y, dy, dh_S):
        seen["y"], seen["dh_S"] = y, dh_S
        return ref.rglru_scan_bwd_ref(a, h0, y, dy, dh_S)

    monkeypatch.setattr(rglru_mod, "_launch", ref.rglru_scan_ref)
    monkeypatch.setattr(rglru_mod, "_launch_bwd", launch_bwd)
    case = (2, 33, 128, "wide", "random" if with_dh else "zero")
    inputs, dy, dh = cases.rglru_bwd_inputs(case, "cpu")
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    got = _grads(rglru_mod.RglruScanFn.apply, leaves, (dy, dh))
    want = _grads(ref.rglru_scan_ref, leaves, (dy, dh))
    assert (seen["dh_S"] is None) == (not with_dh)
    assert torch.equal(seen["y"], ref.rglru_scan_ref(*inputs)[0])
    for n, g, w in zip(("a", "b", "h0"), got, want):
        cases.held(f"RglruScanFn d{n}", case, g, w, cases.RGLRU_TOL)


def test_backward_case_tables_cover_the_edges_and_the_training_shapes():
    every = ref.WKV6_EVERY
    lengths = {c[2] for c in cases.WKV6_BWD}
    assert {0, 1, every, every + 1} <= lengths
    assert {1, 80} <= {c[3] for c in cases.WKV6_BWD}
    assert {(c[7], c[8]) for c in cases.WKV6_BWD} == {
        ("fp32", "zero"), ("fp32", "random"), ("bf16", "zero"), ("bf16", "random")}
    assert {"bhsd", "bshd", "off"} <= {c[6] for c in cases.WKV6_BWD}
    assert cases.WKV6_BWD_TRAIN == {
        "rwkv6-1.6b": (1, 32, 4096, 64, None, 0.1, "bshd", "bf16", "zero")}
    assert {c[:4] for c in cases.RGLRU_BWD} >= {c for c in (
        cases.RGLRU_SWEEP + cases.RGLRU_EDGE + cases.RGLRU_NO_TOKEN + cases.RGLRU_FLOOR)}
    assert cases.RGLRU_BWD_TRAIN == {"recurrentgemma-2b": (1, 8192, 2560, "bsd", "zero")}
    assert cases.FLASH_BWD_TRAIN["recurrentgemma-2b"] == (
        1, 10, 1, 8192, 8192, 256, 0, 2048, True)
