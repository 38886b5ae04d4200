"""The recurrent sequence kernels' arithmetic orders, emulated on the CPU.

``csrc/wkv6.cu``'s time loop (``wkv6_kernel``) and ``csrc/rglru_scan.cu``'s
two-pass scan (``rglru_fwd_carry_kernel``, ``rglru_fwd_kernel``) are CUDA
only, so their orders of operations are replayed here in plain fp32 and
held, at every ``WKV6_*`` / ``RGLRU_*`` case and at the training shapes,
against the float64 recurrence at the kernels' tolerances (``WKV6_TOL``,
1e-4, tests/test_kernels.py::test_wkv6_sweep; ``RGLRU_TOL``, 1e-5,
::test_rglru_sweep) and against the plain fp32 versions the card holds them
to, so the tolerance is shown to survive the order before the card runs
it. The layout (slice width, row groups, staging chunk, scan chunk) is read
from the CUDA sources, which own it. The kernels themselves are held
against the plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""
import re
from pathlib import Path

import pytest
import torch
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

from repro_torch.kernels import cases, ref
from repro_torch.kernels import wkv6 as wkv6_mod

CSRC = Path(wkv6_mod.__file__).resolve().parent / "csrc"
SMS = 132                                  # the H100's streaming multiprocessors


def _source_ints(name, pattern):
    """The integers ``pattern`` captures in ``csrc/<name>.cu``."""
    found = re.search(pattern, (CSRC / f"{name}.cu").read_text())
    assert found, f"csrc/{name}.cu has no {pattern!r}"
    return tuple(int(g) for g in found.groups())


(SLICE,) = _source_ints("wkv6", r"constexpr int kSlice = (\d+);")
(LOOP_THREADS,) = _source_ints("wkv6", r"constexpr int kLoopThreads = (\d+);")
(ROW_GROUPS,) = _source_ints("wkv6", r"constexpr int kRowGroups = (\d+);")
(PART_PAD,) = _source_ints("wkv6", r"constexpr int kPart = kRowGroups \* kSlice \+ (\d+);")
# the staging chunk (steps) of the 128-wide kernel, then of the 32- and 64-wide
WKV6_CHUNK = _source_ints("wkv6", r"kLoopChunk = HD >= 128 \? (\d+) : (\d+);")
(SCAN_CHUNK,) = _source_ints("rglru_scan", r"constexpr int kScanChunk = (\d+);")
(SCAN_THREADS,) = _source_ints("rglru_scan", r"constexpr int kScanThreads = (\d+);")


def _fma32(a, b, c):
    """fmaf emulated: the product exact in float64, one rounding of the sum
    there and one to fp32."""
    return (a.double() * b.double() + c.double()).float()


# --------------------------------------------------------------------------- #
# wkv6: the time loop
# --------------------------------------------------------------------------- #

def _width(hd):
    """The template width the kernel takes hd at."""
    return 32 if hd <= 32 else 64 if hd <= 64 else 128


def _stage_chunk(hd):
    return WKV6_CHUNK[0] if _width(hd) >= 128 else WKV6_CHUNK[1]


def _wkv6_blocks(B, H, hd):
    """The time loop's grid: one block per (batch, head, slice of columns)."""
    return B * H * -(-hd // SLICE)


BLOCK = 32                                 # steps whose states are kept at once


def _wkv6_time_loop(r, k, v, w, u, s0, every=ref.WKV6_EVERY):
    """csrc/wkv6.cu's wkv6_kernel in fp32: (y, s_n, ckpt). The rows are
    padded to the template width W and cut into ROW_GROUPS groups of W/32
    rows, a thread's; per step and state element kv = k_i·v_j (rounded),
    y's partial over a group's rows fmaf(r_i, fmaf(u_i, kv, S_ij), acc)
    from 0 in row order, the state fmaf(S_ij, w_i, kv); y_j the sum of the
    groups' partials in group order from 0. A block's 8 columns and a
    thread's 4 are the same arithmetic whatever the slice, so the columns
    run together here. The state before every ``every``-th step is the
    checkpoint. The states alone are walked step by step; y, which feeds
    nothing back, is taken BLOCK steps at a time from their saved states."""
    B, H, S, hd = r.shape
    W = _width(hd)
    rows = W // ROW_GROUPS

    def pad_rows(t, dim):
        pad = [0, 0] * (t.dim() - 1 - dim) + [0, W - hd]
        return torch.nn.functional.pad(t.float(), pad)

    r, k, w = (pad_rows(t, 3) for t in (r, k, w))          # (B,H,S,W)
    v = v.float()                                          # (B,H,S,hd)
    u = pad_rows(u, 1)[None, :, None, :, None]             # (1,H,1,W,1)
    st = pad_rows(s0, 2)                                   # (B,H,W,hd)
    y = torch.empty((B, H, S, hd))
    ckpt = torch.empty((B, H, -(-S // every), hd, hd))
    for t0 in range(0, S, BLOCK):
        n = min(BLOCK, S - t0)
        kv = k[:, :, t0:t0 + n, :, None] * v[:, :, t0:t0 + n, None, :]   # rounded
        states = torch.empty((B, H, n, W, hd))
        for c in range(n):
            if (t0 + c) % every == 0:
                ckpt[:, :, (t0 + c) // every] = st[:, :, :hd]
            states[:, :, c] = st
            st = _fma32(st, w[:, :, t0 + c, :, None], kv[:, :, c])
        inner = _fma32(u, kv, states).reshape(B, H, n, ROW_GROUPS, rows, hd)
        rg = r[:, :, t0:t0 + n].reshape(B, H, n, ROW_GROUPS, rows, 1)
        acc = torch.zeros((B, H, n, ROW_GROUPS, hd))
        for a in range(rows):
            acc = _fma32(rg[..., a, :], inner[..., a, :], acc)
        total = torch.zeros((B, H, n, hd))
        for g in range(ROW_GROUPS):
            total = total + acc[:, :, :, g]
        y[:, :, t0:t0 + n] = total
    return y, st[:, :, :hd], ckpt


def _wkv6_f64(r, k, v, w, u, s0, every=ref.WKV6_EVERY):
    """The recurrence of ``ref.wkv6_train_ref`` in float64: (y, s_n, ckpt),
    y BLOCK steps at a time from the saved states."""
    r, k, v, w, u, s = (t.double() for t in (r, k, v, w, u, s0))
    B, H, S, hd = r.shape
    y = torch.empty((B, H, S, hd), dtype=torch.float64)
    ckpt = torch.empty((B, H, -(-S // every), hd, hd), dtype=torch.float64)
    for t0 in range(0, S, BLOCK):
        n = min(BLOCK, S - t0)
        kv = k[:, :, t0:t0 + n, :, None] * v[:, :, t0:t0 + n, None, :]
        states = torch.empty((B, H, n, hd, hd), dtype=torch.float64)
        for c in range(n):
            if (t0 + c) % every == 0:
                ckpt[:, :, (t0 + c) // every] = s
            states[:, :, c] = s
            s = s * w[:, :, t0 + c, :, None] + kv[:, :, c]
        eff = states + u[None, :, None, :, None] * kv
        y[:, :, t0:t0 + n] = torch.einsum("bhtij,bhti->bhtj", eff, r[:, :, t0:t0 + n])
    return y, s, ckpt


WKV6_FWD = (cases.WKV6_SWEEP + cases.WKV6_EDGE + cases.WKV6_SLICE + cases.WKV6_NO_TOKEN
            + cases.WKV6_BF16 + [c for c in cases.WKV6_BWD if c[2] > 1]
            + [c[:8] for c in cases.WKV6_BWD_TRAIN.values()])


@pytest.mark.parametrize("case", WKV6_FWD)
def test_wkv6_time_loop_order_holds_the_tolerance(case):
    """The time loop's order against the float64 recurrence and against the
    plain fp32 version (y, s_n; the plain training entry's checkpoints)
    within WKV6_TOL, on the upcast values for bf16 r, k, v."""
    inputs = cases.wkv6_inputs(case[:8], "cpu")
    got = _wkv6_time_loop(*inputs)
    exact = _wkv6_f64(*inputs)
    plain = ref.wkv6_train_ref(*inputs, ref.WKV6_EVERY)
    for n, g, x, p in zip(("y", "s_n", "ckpt"), got, exact, plain):
        cases.held(f"time loop {n} vs float64", case, g.double(), x, cases.WKV6_TOL)
        cases.held(f"time loop {n} vs plain", case, g, p, cases.WKV6_TOL)


def test_wkv6_layout_fills_the_card_and_fits_shared_memory():
    """The source's layout: 64 threads a block, 32 row groups by 2 groups
    of 4 columns on an 8-column slice; every template width divides into
    the row groups; a block's ring of two chunks and its y partials fit the
    48 KB of static shared memory in fp32 (the larger r, k, v); and
    rwkv6-1.6b's 32 heads of 64 make 256 blocks, past the H100's 132 SMs
    (one block a head would make 32)."""
    assert LOOP_THREADS == ROW_GROUPS * (SLICE // 4) and SLICE % 4 == 0
    for W in (32, 64, 128):
        assert W % ROW_GROUPS == 0 and W % SLICE == 0
        C = _stage_chunk(W)
        assert ref.WKV6_EVERY % C == 0 and C * SLICE % LOOP_THREADS == 0
        ring = 2 * (C * W * (4 + 4 + 4) + C * SLICE * 4)
        part = C * (ROW_GROUPS * SLICE + PART_PAD) * 4
        assert ring + part <= 48 * 1024, W
    B, H, _, hd = cases.WKV6_BWD_TRAIN["rwkv6-1.6b"][:4]
    assert _wkv6_blocks(B, H, hd) == 256 >= SMS > B * H


def test_wkv6_slice_cases_cross_the_slices_and_chunks():
    """cases.WKV6_SLICE takes each staging chunk's edge either way (a step
    short, whole, a step over, two and a step; chunks of 8 at hd 128), a
    partial slice (hd 100) and six slices of a 64-wide kernel (hd 48), the
    element path, decay 0 and 1, and grids of one to three heads' slices."""
    C = _stage_chunk(64)
    lengths = {c[2] for c in cases.WKV6_SLICE if _width(c[3]) == 64}
    assert {C - 1, C, C + 1, 2 * C + 1} <= lengths
    assert any(_width(c[3]) == 128 and c[2] % _stage_chunk(128) for c in cases.WKV6_SLICE)
    hds = {c[3] for c in cases.WKV6_SLICE}
    assert {48, 100} <= hds and any(h % SLICE for h in hds)
    assert {"off", "bshd"} <= {c[6] for c in cases.WKV6_SLICE}
    assert {0.0, 1.0} <= {c[4] for c in cases.WKV6_SLICE}
    assert {"bf16", "fp32"} == {c[7] for c in cases.WKV6_SLICE}
    assert all(c[0] * c[1] <= 3 for c in cases.WKV6_SLICE)
    assert min(_wkv6_blocks(*c[:2], c[3]) for c in cases.WKV6_SLICE) == 8


# --------------------------------------------------------------------------- #
# rglru: the two-pass scan
# --------------------------------------------------------------------------- #

def _rglru_chunks(S):
    """The scan's chunks at length S: one up to a chunk, S = 0 included."""
    return -(-S // SCAN_CHUNK) if S > SCAN_CHUNK else 1


def _rglru_blocks(B, S, D):
    """(pass 1's blocks, pass 2's) of one scan call."""
    dblocks, K = -(-D // SCAN_THREADS), _rglru_chunks(S)
    return dblocks * (K - 1) * B, dblocks * K * B


def _rglru_two_pass(a, b, h0):
    """csrc/rglru_scan.cu's two passes in fp32: chunks of SCAN_CHUNK steps;
    pass 1 scans chunks 0..K-2 from a zero state (L, the last state) and
    takes M = Π a; pass 2 folds h0 through the earlier chunks' (L, M) by
    fmaf, first first, then walks each chunk's steps, a·h then + b, each
    rounded."""
    B, S, D = a.shape
    L, K = SCAN_CHUNK, _rglru_chunks(S)
    pad = K * L - S                   # a = 1, b = 0 past S: the state passes unchanged
    a4, b4 = (torch.cat([t, torch.full((B, pad, D), f, dtype=t.dtype)], dim=1)
              .reshape(B, K, L, D) for t, f in ((a, 1.0), (b, 0.0)))
    last, prod = torch.zeros((B, K, D)), torch.ones((B, K, D))
    for o in range(L):                              # pass 1 (the last chunk's pair is unused)
        last = a4[:, :, o] * last + b4[:, :, o]
        prod = prod * a4[:, :, o]
    h = torch.empty((B, K, D))
    h[:, 0] = h0
    for kc in range(1, K):                          # the fold, the same in every chunk
        h[:, kc] = _fma32(prod[:, kc - 1], h[:, kc - 1], last[:, kc - 1])
    y4 = torch.empty_like(a4)
    for o in range(L):                              # pass 2
        h = a4[:, :, o] * h + b4[:, :, o]
        y4[:, :, o] = h
    y = y4.reshape(B, K * L, D)[:, :S]
    return y, (h0.clone() if S == 0 else y[:, -1].clone())


RGLRU_FWD = (cases.RGLRU_SWEEP + cases.RGLRU_EDGE + cases.RGLRU_CHUNK + cases.RGLRU_NO_TOKEN
             + cases.RGLRU_FLOOR + [c[:4] for c in cases.RGLRU_BWD]
             + [c[:4] for c in cases.RGLRU_BWD_TRAIN.values()])


@pytest.mark.parametrize("case", RGLRU_FWD)
def test_rglru_two_pass_scan_holds_the_tolerance(case):
    """The two-pass order against the float64 scan and against the plain
    fp32 version within RGLRU_TOL; at one chunk (S <= SCAN_CHUNK) the plain
    version's bits."""
    a, b, h0 = cases.rglru_inputs(case, "cpu")
    got = _rglru_two_pass(a, b, h0)
    exact = ref.rglru_scan_ref(a.double(), b.double(), h0.double())
    plain = ref.rglru_scan_ref(a, b, h0)
    for n, g, x, p in zip(("y", "h_S"), got, exact, plain):
        cases.held(f"two-pass {n} vs float64", case, g.double(), x, cases.RGLRU_TOL)
        cases.held(f"two-pass {n} vs plain", case, g, p, cases.RGLRU_TOL)
        if _rglru_chunks(case[1]) == 1:
            assert torch.equal(g, p)


def test_rglru_scan_chunks_fill_the_card():
    """The source's chunk length cuts the training shape into 64 chunks and
    the prefill into 20; both passes' grids pass the H100's 132 SMs at
    recurrentgemma-2b's D 2,560 (one thread a channel over the whole chain
    would make 10 blocks of 256)."""
    assert [_rglru_chunks(S) for S in (0, 1, SCAN_CHUNK, SCAN_CHUNK + 1, 2560, 8192)] == [
        1, 1, 1, 2, 20, 64]
    B, S, D = cases.RGLRU_BWD_TRAIN["recurrentgemma-2b"][:3]
    assert _rglru_blocks(B, S, D) == (20 * 63, 20 * 64)
    assert min(_rglru_blocks(B, S, D)) >= SMS and min(_rglru_blocks(1, 2560, D)) >= SMS
    assert _rglru_blocks(1, SCAN_CHUNK, D) == (0, 20)        # one chunk: pass 2 alone


def test_rglru_chunk_cases_cross_the_chunks():
    """cases.RGLRU_CHUNK takes one whole chunk, one step into a second and a
    partial third, with an odd D, strided rows and three batches."""
    L = SCAN_CHUNK
    lengths = {c[1] for c in cases.RGLRU_CHUNK}
    assert {L, L + 1} <= lengths and any(S > 2 * L and S % L for S in lengths)
    assert 77 in {c[2] for c in cases.RGLRU_CHUNK}
    assert "wide" in {c[3] for c in cases.RGLRU_CHUNK}
    assert 3 in {c[0] for c in cases.RGLRU_CHUNK}
