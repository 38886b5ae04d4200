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
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

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


# --------------------------------------------------------------------------- #
# The kernels' arithmetic orders, emulated in plain fp32 on the CPU (kept
# here, on no path): the two-pass RG-LRU backward with composed carries at
# the kernel's chunk length, and the wkv6 backward's row slices, each
# block's dv partial added over the blocks in order. Each is held against
# the plain version at the kernel's tolerance, at every case and at the
# training shape, so the tolerance is shown to survive the order before the
# card runs it. The layout (chunk length, rows and columns a thread) is
# read from the CUDA sources, which own it.
# --------------------------------------------------------------------------- #

CSRC = Path(wkv6_mod.__file__).resolve().parent / "csrc"


def _source_ints(name, pattern):
    """The integers ``pattern`` captures in ``csrc/<name>.cu``."""
    found = re.search(pattern, (CSRC / f"{name}.cu").read_text())
    assert found, f"csrc/{name}.cu has no {pattern!r}"
    return tuple(int(g) for g in found.groups())


(RGLRU_CHUNK,) = _source_ints("rglru_scan", r"constexpr int kBwdChunk = (\d+);")
# (at the 128-wide kernel, at the 32- and 64-wide ones)
WKV6_ROWS = _source_ints("wkv6_bwd", r"kRows = HD == 128 \? (\d+) : (\d+);")
WKV6_COLS = _source_ints("wkv6_bwd", r"kCols = HD == 128 \? (\d+) : (\d+);")


def _rglru_chunks(S):
    """The backward's chunks at length S: one up to a chunk, S = 0 included."""
    return -(-S // RGLRU_CHUNK) if S > RGLRU_CHUNK else 1


def _wkv6_layout(W):
    """(rows a block, columns a thread) of the W-wide kernel."""
    i = 0 if W == 128 else 1
    return WKV6_ROWS[i], WKV6_COLS[i]

def _fma32(a, b, c):
    """fmaf emulated: the product exact in float64, one rounding of the sum
    there and one to fp32."""
    return (a.double() * b.double() + c.double()).float()


def _rglru_two_pass(a, h0, y, dy, dh_S):
    """csrc/rglru_scan.cu's rglru_bwd_carry_kernel + rglru_bwd_kernel in
    fp32: chunks of ``RGLRU_CHUNK`` steps, (L, M) of chunks 1..K-1 from a
    zero carry, each chunk's carry folded from dh_S through the later
    chunks' pairs, last first, then the chunk's steps from that carry."""
    B, S, D = a.shape
    L, K = RGLRU_CHUNK, _rglru_chunks(S)
    pad = K * L - S                   # a = 1, dy = 0 past S: the carry passes unchanged
    yprev = torch.cat([h0[:, None], y[:, :-1]], dim=1) if S else y
    a4, dy4, yp4 = (torch.cat([t, torch.full((B, pad, D), f, dtype=t.dtype)], dim=1)
                    .reshape(B, K, L, D) for t, f in ((a, 1.0), (dy, 0.0), (yprev, 0.0)))
    carry, m = torch.zeros((B, K, D)), torch.ones((B, K, D))
    for o in range(L - 1, -1, -1):                  # pass 1 (chunk 0's pair is unused)
        carry = a4[:, :, o] * (dy4[:, :, o] + carry)
        m = m * a4[:, :, o]
    cin = torch.empty((B, K, D))
    cin[:, K - 1] = torch.zeros((B, D)) if dh_S is None else dh_S
    for kc in range(K - 2, -1, -1):                 # the fold, the same in every chunk
        cin[:, kc] = _fma32(m[:, kc + 1], cin[:, kc + 1], carry[:, kc + 1])
    da4, db4, c = torch.empty_like(a4), torch.empty_like(a4), cin
    for o in range(L - 1, -1, -1):                  # pass 2
        g = dy4[:, :, o] + c
        db4[:, :, o] = g
        da4[:, :, o] = g * yp4[:, :, o]
        c = a4[:, :, o] * g
    da, db = (t.reshape(B, K * L, D)[:, :S] for t in (da4, db4))
    return da, db, c[:, 0]


RGLRU_EMULATED = cases.RGLRU_BWD + list(cases.RGLRU_BWD_TRAIN.values())


@pytest.mark.parametrize("case", RGLRU_EMULATED)
def test_rglru_two_pass_order_holds_the_tolerance(case):
    """The two-pass order against ref.rglru_scan_bwd_ref within RGLRU_TOL;
    at one chunk (S <= RGLRU_CHUNK) the same arithmetic, bit for bit."""
    (a, b, h0), dy, dh = cases.rglru_bwd_inputs(case, "cpu")
    y, _ = ref.rglru_scan_ref(a, b, h0)
    got = _rglru_two_pass(a, h0, y, dy, dh)
    want = ref.rglru_scan_bwd_ref(a, h0, y, dy, dh)
    for n, g, w in zip(("a", "b", "h0"), got, want):
        cases.held(f"two-pass d{n}", case, g, w, cases.RGLRU_TOL)
        if _rglru_chunks(case[1]) == 1:
            assert torch.equal(g, w)


def test_rglru_two_pass_chunks_and_launches():
    """The source's chunk length cuts the training shape into whole chunks
    (64 at 8,192 steps), and the cases cross a chunk's edge either way: one
    whole chunk, one step into a second, a partial last chunk."""
    L = RGLRU_CHUNK
    assert [_rglru_chunks(S) for S in (0, 1, L, L + 1, 8192)] == [1, 1, 1, 2, 64]
    lengths = {c[1] for c in cases.RGLRU_BWD}
    assert {L, L + 1} <= lengths and any(S > 2 * L and S % L for S in lengths)


def _tree(x):
    """Σ over the last dimension (a power of two) as a butterfly of lanes adds
    it: neighbours first, then pairs of pairs."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _wkv6_row_slices(r, k, v, w, u, s0, ckpt, dy, ds_n):
    """csrc/wkv6_bwd.cu in fp32: hd padded to the kernel's width W, blocks of
    kRows rows, a row's columns in kParts lanes of kCols; per step the three
    row sums over a lane's columns in order, then over the row's lanes by a
    butterfly; dv's column sums over the rows of a warp by a butterfly, then
    over the block's warps in order after dy Σ u r k (block 0), then over
    the blocks in order; v·dy and Σ u r k summed by lane (columns d, d + 32,
    ...) and a butterfly over the 32 lanes; du Kahan-summed last step
    first."""
    B, H, S, hd = r.shape
    W = 32 if hd <= 32 else 64 if hd <= 64 else 128
    rows, cols = _wkv6_layout(W)
    parts, blocks = W // cols, W // rows
    warp_rows = 32 // parts
    every = ref.WKV6_EVERY

    def padded(t, dims):
        return torch.nn.functional.pad(t.float(), [0, W - hd] * dims)

    def lane_dot(x):                            # (B,H,W) -> (B,H): by lane, then a butterfly
        lanes = x.reshape(B, H, W // 32, 32)
        acc = lanes[:, :, 0]
        for m in range(1, W // 32):
            acc = acc + lanes[:, :, m]
        return _tree(acc)

    r, k, v, w, dy = (padded(t, 1) for t in (r, k, v, w, dy))
    u = padded(u, 1)[None, :, :]
    G = torch.zeros((B, H, W, W)) if ds_n is None else padded(ds_n, 2)
    dr, dk, dv, dw = (torch.empty((B, H, S, W)) for _ in range(4))
    du, du_c = torch.zeros((B, H, W)), torch.zeros((B, H, W))
    for c in range(ckpt.shape[2] - 1, -1, -1):
        t0, t1 = c * every, min(S, (c + 1) * every)
        states = [padded(ckpt[:, :, c], 2)]
        for t in range(t0, t1 - 1):
            kv = k[:, :, t, :, None] * v[:, :, t, None, :]
            states.append(_fma32(states[-1], w[:, :, t, :, None], kv))
        for t in range(t1 - 1, t0 - 1, -1):
            st = states[t - t0]
            rt, kt, vt, wt, gt = (x[:, :, t] for x in (r, k, v, w, dy))
            vdy, urk = lane_dot(vt * gt), lane_dot(u[0] * rt * kt)
            sums = [torch.zeros((B, H, W, parts)) for _ in range(3)]
            for cc in range(cols):                 # a lane's columns, in order
                sl = slice(cc, W, cols)
                sums[0] = _fma32(st[..., sl], gt[:, :, None, sl], sums[0])
                sums[1] = _fma32(G[..., sl], vt[:, :, None, sl], sums[1])
                sums[2] = _fma32(st[..., sl], G[..., sl], sums[2])
            row = [_tree(x) for x in sums]         # over the row's lanes
            gk = (G * kt[..., None]).reshape(B, H, blocks, rows // warp_rows, warp_rows, W)
            per_warp = _tree(gk.transpose(-1, -2))    # (B,H,blocks,warps,W)
            parts_dv = []
            for q in range(blocks):
                a = urk[..., None] * gt if q == 0 else torch.zeros((B, H, W))
                for wp in range(rows // warp_rows):
                    a = a + per_warp[:, :, q, wp]
                parts_dv.append(a)
            col = parts_dv[0]
            for q in range(1, blocks):
                col = col + parts_dv[q]
            uvd = u * vdy[..., None]
            dr[:, :, t] = _fma32(uvd, kt, row[0])
            dk[:, :, t] = _fma32(uvd, rt, row[1])
            dw[:, :, t] = row[2]
            dv[:, :, t] = col
            y_ = rt * kt * vdy[..., None] - du_c
            tot = du + y_
            du_c = (tot - du) - y_
            du = tot
            G = _fma32(G, wt[..., None], rt[..., None] * gt[:, :, None, :])
    return (dr[..., :hd], dk[..., :hd], dv[..., :hd], dw[..., :hd], du[..., :hd].sum(0),
            G[:, :, :hd, :hd])


def test_wkv6_bwd_blocks_and_launches():
    """The source's layout as the emulation takes it: at each width W the
    rows a block and columns a thread divide W, a row's lanes fill whole
    warps' rows, and the blocks a head are 2, 4 and 16 (4 at rwkv6-1.6b's
    64-wide heads: 128 blocks for 32 heads)."""
    blocks = []
    for W in (32, 64, 128):
        rows, cols = _wkv6_layout(W)
        parts = W // cols
        assert W % rows == 0 and W % cols == 0 and 32 % parts == 0
        assert (rows * parts) % 32 == 0
        blocks.append(W // rows)
    assert blocks == [2, 4, 16]


WKV6_EMULATED = cases.WKV6_BWD + list(cases.WKV6_BWD_TRAIN.values())


@pytest.mark.parametrize("case", WKV6_EMULATED)
def test_wkv6_row_slice_order_holds_the_tolerance(case):
    """The row-slice order against ref.wkv6_bwd_ref (float64) on the plain
    training entry's checkpoints: fp32 gradients within WKV6_TOL; dr, dk, dv
    of bf16 r, k, v rounded to bf16 once, within TOL[bf16]."""
    inputs, dy, dsn = cases.wkv6_bwd_inputs(case, "cpu")
    _, _, ckpt = ref.wkv6_train_ref(*inputs, ref.WKV6_EVERY)
    got = _wkv6_row_slices(*inputs, ckpt, dy, dsn)
    want = ref.wkv6_bwd_ref(*inputs, ckpt, dy, dsn)
    for n, g, wt in zip(GRADS, got, want):
        cases.held(f"row slices d{n}", case, g.to(wt.dtype), wt, _tol(wt))
