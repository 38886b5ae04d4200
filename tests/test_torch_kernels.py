"""Attention kernels of the PyTorch port against the JAX package.

On the CPU the port's wrappers run their plain versions; they are held
against ``repro.kernels.ops`` (the Pallas kernels in interpret mode, as
tests/test_kernels.py runs them) on that file's sweeps, and against
``repro.kernels.ref`` on the ragged, hd=80 and empty-band shapes that the
Pallas kernel does not take. The CUDA kernels are held against the plain
versions on the card by tests/test_torch_gpu.py and chip_smoke.py, through
the same case tables (``repro_torch.kernels.cases``).
"""
import ast
import os
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, cases, ops, phases, ref
from repro_torch.kernels.cases import (DECODE_MAIN, DECODE_RAGGED, DECODE_SWEEP,
                                       FLASH_EMPTY_BAND, FLASH_RAGGED, FLASH_SWEEP,
                                       FLASH_TILES)
from repro_torch.kernels.decode_attention import MAX_SPLITS, TILE, split_plan
from repro_torch.kernels.flash_attention import (BWD_ROUTES, DTYPES, _bwd_args,
                                                 _entry_args, bwd_blocks, bwd_keys, bwd_route,
                                                 bwd_tf32_blocks, fwd_tf32_rows, rows16,
                                                 split_floats)

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _data(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _pair(x, dtype):
    """The same numbers on both sides (both round fp32 -> bf16 to nearest)."""
    return jnp.asarray(x).astype(JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _close(a, b, dtype):
    np.testing.assert_allclose(np.asarray(a, np.float32), b.float().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _flash_pairs(case, dtype, seed):
    B, H, KV, Sq, Sk, hd = case[:6]
    return [_pair(x, dtype) for x in
            _data(seed, (B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd))]


# --------------------------------------------------------------------------- #
# CPU: the port's plain versions against the JAX package
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_SWEEP)
def test_flash_attention_matches_pallas(dtype, case):
    (jq, tq), (jk, tk), (jv, tv) = _flash_pairs(case, dtype, seed=0)
    off, win, causal = case[6:]
    a = jops.flash_attention(jq, jk, jv, q_offset=off, window=win, causal=causal)
    b = ops.flash_attention(tq, tk, tv, q_offset=off, window=win, causal=causal)
    assert b.dtype == TDT[dtype] and b.shape == tq.shape
    _close(a, b, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_RAGGED + FLASH_EMPTY_BAND + FLASH_TILES
                         + cases.FLASH_TF32_TILES)
def test_flash_attention_ragged_and_empty_band_match_reference(dtype, case):
    (jq, tq), (jk, tk), (jv, tv) = _flash_pairs(case, dtype, seed=1)
    off, win, causal = case[6:]
    a = jref.flash_attention_ref(jq, jk, jv, q_offset=off, window=win, causal=causal)
    b = ops.flash_attention(tq, tk, tv, q_offset=off, window=win, causal=causal)
    _close(a, b, dtype)


@pytest.mark.parametrize("case", FLASH_EMPTY_BAND)
def test_flash_empty_band_rows_average_all_keys(case):
    """A row that sees no key gets the mean of V over all Sk keys (what the
    reference's -1e30 mask and the Pallas kernel's online softmax give)."""
    q, k, v = cases.flash_inputs(case, torch.float32, "cpu", seed=2)
    off, win, causal = case[6:]
    out = ops.flash_attention(q, k, v, q_offset=off, window=win, causal=causal)
    B, H, KV, Sq, Sk = case[:5]
    G = H // KV
    mean = v.mean(dim=2).repeat_interleave(G, dim=1)          # (B, H, hd)
    rows = [i for i in range(Sq) if cases.flash_visible(
        (1, 1, 1, 1, Sk, 1, off + i, win, causal))[1]]
    assert rows, "the case has no empty row"
    for i in rows:
        torch.testing.assert_close(out[:, :, i], mean, atol=2e-6, rtol=2e-6)
    assert cases.flash_visible(case)[1] == len(rows)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_SWEEP)
def test_decode_attention_matches_pallas(dtype, case):
    B, H, KV, W, hd, nvalid, start = case
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in
                                    _data(0, (B, H, hd), (B, KV, W, hd), (B, KV, W, hd)))
    valid = cases.decode_valid(W, nvalid, start)
    a = jops.decode_attention(jq, jk, jv, jnp.asarray(valid))
    b = ops.decode_attention(tq, tk, tv, torch.from_numpy(valid))
    _close(a, b, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_RAGGED + DECODE_MAIN)
def test_decode_attention_ragged_strided_matches_reference(dtype, case):
    """Caches as permuted (B,W,KV,hd) views the way the model passes them
    (at the case's storage offset), W that no tile divides, ring-wrapped and
    empty masks, the main paths' shapes."""
    B, H, KV, W, hd, nvalid, start = case[:7]
    q, kc, vc = _data(3, (B, H, hd), (B, W, KV, hd), (B, W, KV, hd))
    valid = cases.decode_valid(W, nvalid, start)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, kc, vc))
    offset = case[7] if len(case) > 7 else 0
    tk, tv = cases.at_offset(tk, offset), cases.at_offset(tv, offset)
    assert tk.storage_offset() == offset
    a = jref.decode_attention_ref(jq, jk.transpose(0, 2, 1, 3),
                                  jv.transpose(0, 2, 1, 3), jnp.asarray(valid))
    b = ops.decode_attention(tq, tk.permute(0, 2, 1, 3), tv.permute(0, 2, 1, 3),
                             torch.from_numpy(valid))
    _close(a, b, dtype)


def _split_merge(q, k, v, valid, num_sms=132):
    """The kernel's rule in plain PyTorch: the chunks of ``split_plan``,
    each reduced to (m, l, acc) over its TILE-slot tiles with the tiles that
    hold no valid slot skipped, then merged; with no valid slot anywhere,
    the mean of V over all W slots."""
    B, H, hd = q.shape
    KV, W = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd).float() * hd ** -0.5
    kf, vf, ok = k.float(), v.float(), valid > 0
    nsplit, chunk = split_plan(B, KV, W, num_sms)
    parts = []
    for c in range(nsplit):
        m = torch.full((B, KV, G), float("-inf"))
        l, acc = torch.zeros(B, KV, G), torch.zeros(B, KV, G, hd)
        for t0 in range(c * chunk, min(W, (c + 1) * chunk), TILE):
            sl = slice(t0, min(W, t0 + TILE, (c + 1) * chunk))
            if not bool(ok[sl].any()):
                continue
            s = torch.einsum("bkgd,bkwd->bkgw", qg, kf[:, :, sl])
            s = torch.where(ok[sl], s, float("-inf"))
            mn = torch.maximum(m, s.amax(-1))
            alpha, p = torch.exp(m - mn), torch.exp(s - mn[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgw,bkwd->bkgd", p, vf[:, :, sl])
            m = mn
        parts.append((m, l, acc))
    if not any(bool((l > 0).any()) for _, l, _ in parts):
        out = vf.mean(dim=2, keepdim=True).expand(B, KV, G, hd)
    else:
        M = torch.stack([torch.where(l > 0, m, float("-inf")) for m, l, _ in parts]).amax(0)
        w = [torch.where(l > 0, torch.exp(m - M), torch.zeros_like(l)) for m, l, _ in parts]
        L = sum(wc * l for wc, (_, l, _) in zip(w, parts))
        out = sum(wc[..., None] * a for wc, (_, _, a) in zip(w, parts)) / L[..., None]
    return out.reshape(B, H, hd).to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [DECODE_RAGGED[2], DECODE_RAGGED[7]] + DECODE_MAIN)
def test_decode_split_and_merge_rule_matches_reference(dtype, case):
    """Chunks, skipped empty tiles and the merge (no valid slot anywhere;
    one valid slot in the last chunk only; the main paths' shapes) give the
    reference's result."""
    q, k, v, valid = cases.decode_inputs(case, dtype, "cpu", seed=4)
    nsplit, chunk = split_plan(q.shape[0], k.shape[1], k.shape[2], 132)
    assert nsplit > 1
    if case[5] == 1:                        # the one valid slot lies in the last chunk
        assert int(valid.nonzero()[0]) >= (nsplit - 1) * chunk
    cases.held("split-merge", case, _split_merge(q, k, v, valid),
               ref.decode_attention_ref(q, k, v, valid))


def test_decode_valid_wraps_the_ring():
    np.testing.assert_array_equal(cases.decode_valid(6, 3, 4), [1, 0, 0, 0, 1, 1])
    assert cases.decode_valid(6, 0, 2).sum() == 0
    assert cases.decode_valid(6, 6, 5).sum() == 6


def test_flash_visible_counts_pairs_and_empty_rows():
    assert cases.flash_visible((1, 1, 1, 4, 4, 8, 0, None, True)) == (10, 0)
    assert cases.flash_visible((1, 1, 1, 4, 6, 8, 10, 2, True)) == (0, 4)
    assert cases.flash_visible((1, 1, 1, 3, 5, 8, 0, None, False)) == (15, 0)


# --------------------------------------------------------------------------- #
# the check that holds the kernels on the card, run here on the CPU path
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_checks_run_on_cpu(dtype):
    err, (q, _, _) = cases.check_flash(FLASH_EMPTY_BAND[2], dtype, "cpu")
    assert err == 0.0 and q.dtype == dtype
    err, (q, k, _, valid) = cases.check_decode(DECODE_RAGGED[0], dtype, "cpu")
    assert err == 0.0 and k.stride(-1) == 1 and k.stride(2) == k.shape[1] * k.shape[3]
    assert int(valid.sum()) == DECODE_RAGGED[0][5]


def test_recurrent_step_checks_run_on_cpu():
    """The checks that hold the step kernels on the card, on the plain path:
    every step case's layout reaches the wrapper as the case says."""
    for case in cases.WKV6_STEP + cases.WKV6_FLOOR:
        err, (r, *_) = cases.check_wkv6(case, "cpu")
        assert err == 0.0 and r.shape[2] == 1
        assert r.dtype == (torch.bfloat16 if case[7] == "bf16" else torch.float32)
        assert (r.storage_offset() == 1) == (case[6] == "off")
    for case in cases.RGLRU_STEP:
        err, (gx_a, _, _, _, _, x, h) = cases.check_rglru_step(case, "cpu")
        assert err == 0.0 and x.dtype == getattr(torch, {"bf16": "bfloat16",
                                                        "fp32": "float32"}[case[2]])
        assert h.stride(0) == (2 * case[1] if case[3] == "wide" else case[1])


def test_tolerance_scales_with_the_output():
    want = torch.full((4, 8), 0.1, dtype=torch.bfloat16)
    assert cases.held("x", "c", want, want) == 0.0
    # 1e-2 off: inside 2e-2 at unit scale, outside 2e-2 * (0.1 + 0.1)
    with pytest.raises(AssertionError, match="max"):
        cases.held("x", "c", want + 1e-2, want)
    assert cases.held("x", "c", want * 10 + 1e-2, want * 10) > 0
    with pytest.raises(AssertionError):
        cases.held("x", "c", torch.full_like(want, float("nan")), want)


# --------------------------------------------------------------------------- #
# wrappers and build, without a card
# --------------------------------------------------------------------------- #

def test_cpu_path_does_not_count_launches():
    q, k, v = cases.flash_inputs(FLASH_SWEEP[0], torch.float32, "cpu")
    f0, d0 = ops.flash_attention.launches, ops.decode_attention.launches
    ops.flash_attention(q, k, v)
    ops.decode_attention(q[:, :, 0], k, v, torch.ones(32, dtype=torch.int32))
    assert (ops.flash_attention.launches, ops.decode_attention.launches) == (f0, d0)


@pytest.mark.parametrize("bad", ["heads", "dtype", "valid", "device", "offset"])
def test_wrappers_reject_bad_inputs(bad):
    q = torch.zeros(1, 6, 4, 8)
    k = torch.zeros(1, 4, 4, 8)
    with pytest.raises((ValueError, TypeError)):
        if bad == "heads":                  # H % KV != 0
            ops.flash_attention(q, k, k)
        elif bad == "dtype":
            ops.flash_attention(q[:, :4].double(), k.double(), k.double())
        elif bad == "valid":                # valid must be int32 (W,)
            ops.decode_attention(q[:, :4, 0], k, k, torch.ones(4, dtype=torch.bool))
        elif bad == "device":               # only cpu (plain) or cuda (kernel)
            m = q[:, :4].to("meta")
            ops.flash_attention(m, k.to("meta"), k.to("meta"))
        else:                               # positions must fit the kernel's int32
            ops.flash_attention(q[:, :4], k, k, q_offset=2**31)


def test_split_plan_covers_the_cache():
    assert split_plan(1, 4, 4096, 132) == (16, 256)         # yi-6b decode, batch 1
    assert split_plan(1, 1, 1024, 132) == (16, 64)          # recurrentgemma-2b's ring
    assert split_plan(64, 4, 4096, 132) == (1, 4096)        # 256 blocks already
    assert split_plan(1, 1, 10, 132) == (1, TILE)
    assert split_plan(1, 1, 2**20, 132) == (MAX_SPLITS, 2**16)
    for B, KV, W in ((1, 4, 2568), (3, 2, 77), (8, 8, 32768), (1, 1, 1), (1, 1, 2**20 + 1)):
        nsplit, chunk = split_plan(B, KV, W, 132)
        # every chunk holds a slot, whole tiles, at least 4 of them unless W
        # is shorter; no more chunks than a cluster holds
        assert chunk % TILE == 0 and nsplit * chunk >= W > (nsplit - 1) * chunk
        assert chunk >= min(4 * TILE, -(-W // TILE) * TILE) and nsplit <= MAX_SPLITS


def test_kernel_sources_export_the_bound_signatures():
    """Each C entry the wrappers bind exists in its source with as many
    arguments as ctypes is told to pass (no compiler here to check it)."""
    for name, fns in build._SIGNATURES.items():
        src = (build.CSRC / f"{name}.cu").read_text()
        assert 'extern "C"' in src
        for fn, (_, argtypes) in fns.items():
            head = re.search(rf"\b{fn}\(([^)]*)\)", src).group(1)
            assert len([a for a in head.split(",") if a.strip()]) == len(argtypes), fn
    tile = re.search(r"constexpr int kBK = (\d+);", (build.CSRC / "decode_attention.cu")
                     .read_text()).group(1)
    assert int(tile) == TILE


def test_build_names_library_by_source_hash(tmp_path, monkeypatch):
    a = build.library_path("flash_attention")
    assert a.parent == build.BUILD_DIR and a.name.startswith("libflash_attention-")
    assert a != build.library_path("decode_attention")
    src = tmp_path / "flash_attention.cu"
    src.write_text((build.CSRC / "flash_attention.cu").read_text() + "\n// edit\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.library_path("flash_attention") != a


def test_phase_clock_build_is_a_library_of_its_own():
    """The clock build sits beside the shipped flash library under its own
    name, so ``build.load`` never hands it to the serving path."""
    plain = build.library_path("flash_attention")
    clocks = phases.library_path()
    assert clocks != plain and clocks.parent == plain.parent
    assert clocks.name.startswith("libflash_attention_clocks-")
    assert phases.FLAGS == build.NVCC_FLAGS + ("-DFLASH_PHASE_CLOCKS",)


def test_flash_entry_args_carry_the_views_strides():
    """The C entry gets the model's transposed (B,S,KV,hd) caches by their
    strides, in elements, and the masking as flags."""
    q = torch.zeros(1, 10, 8, 256, dtype=torch.bfloat16)
    k, v = (torch.zeros(1, 24, 1, 256, dtype=torch.bfloat16).transpose(1, 2)
            for _ in range(2))
    out = torch.empty_like(q)
    args = _entry_args(q, k, v, out, 16, True, 12, 0)
    assert len(args) == len(build._SIGNATURES["flash_attention"]
                            ["flash_attention_launch"][1])
    assert args[0] == 1 and args[1:5] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                          out.data_ptr())
    assert args[5:11] == (1, 10, 1, 8, 24, 256)
    assert args[11:23] == (q.stride()[:3] + (6144, 256, 256) + (6144, 256, 256)
                           + out.stride()[:3])
    assert args[23:29] == (16, 1, 1, 12, 0, 0)    # the bf16 route takes no rows, no scratch
    # fp32: the rows a block, and the scratch of the split copies of q, k, v
    scratch = torch.empty(split_floats(1, 10, 1, 8, 24, 256))
    assert scratch.numel() == 2 * (10 * 8 + 2 * 32) * 260     # rows of 256 + 4, 32 keys
    assert _entry_args(q.float(), k.float(), v.float(), out.float(), 0, False, None,
                       0, scratch=scratch)[23:29] == (0, 0, 0, 0, fwd_tf32_rows(1, 10, 1, 8, 256),
                                                      scratch.data_ptr())


def test_flash_train_entry_args_put_lse_after_the_output():
    """The training entry takes the lse pointer after the output's, and
    otherwise the serving entry's arguments."""
    q = torch.zeros(1, 8, 5, 80, dtype=torch.bfloat16)
    k = v = torch.zeros(1, 2, 9, 80, dtype=torch.bfloat16)
    out, lse = torch.empty_like(q), torch.empty(1, 8, 5)
    served = _entry_args(q, k, v, out, 4, True, 3, 0)
    args = _entry_args(q, k, v, out, 4, True, 3, 0, lse)
    assert len(args) == len(build._SIGNATURES["flash_attention"]
                            ["flash_attention_train_launch"][1])
    assert args[:5] + args[6:-1] == served[:-1] and args[5] == lse.data_ptr()


@pytest.mark.parametrize("case", cases.FLASH_BWD)
def test_flash_train_plain_version_matches_float64_logsumexp(case):
    """The training forward's plain version: the output of
    ref.flash_attention_ref bit for bit, and each row's lse (base 2) within
    cases.TOL of a float64 NumPy logsumexp of the masked scores, empty
    bands included (their lse is the mask value's, -1e30 log2 e)."""
    B, H, KV, Sq, Sk, hd, off, win, causal = case
    q, k, v = cases.flash_inputs(case, torch.float32, "cpu")
    kw = dict(q_offset=off, window=win, causal=causal)
    out, lse = ops.flash_attention_train(q, k, v, **kw)
    assert torch.equal(out, ref.flash_attention_ref(q, k, v, **kw))
    qg = q.numpy().astype(np.float64).reshape(B, KV, H // KV, Sq, hd)
    s = np.einsum("bkgqd,bksd->bkgqs", qg, k.numpy().astype(np.float64)) * hd ** -0.5
    s = np.where(ref.flash_mask(Sq, Sk, off, causal, win).numpy(), s, -1e30)
    m = s.max(-1, keepdims=True)
    want = (m[..., 0] + np.log(np.exp(s - m).sum(-1))) / np.log(2.0)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    cases.held("flash_attention_train lse", case, lse,
               torch.from_numpy(want.reshape(B, H, Sq).astype(np.float32)))


@pytest.mark.parametrize("hd", [64, 80, 128, 136, 256])
def test_flash_bwd_route_depends_on_dtype_and_head_dim_alone(hd):
    """Both dtypes on the tensor cores at every hd up to 256: bf16 in
    bf16, fp32 in split-TF32 products; the C entry takes the route as its
    second argument, then the dK/dV block (``bwd_keys``'s in bf16,
    ``bwd_tf32_blocks``'s in fp32) and the dQ block (0 in bf16, whose
    blocks are fixed), whatever the strides."""
    assert bwd_route(torch.bfloat16, hd) == "tensor cores"
    assert bwd_route(torch.float32, hd) == "tensor cores, split tf32"
    _, argtypes = build._SIGNATURES["flash_attention_bwd"]["flash_attention_bwd_launch"]
    for dtype in (torch.bfloat16, torch.float32):
        for B, H, KV, Sq, Sk, off, causal, win in ((1, 4, 2, 8, 8, 0, True, None),
                                                   (2, 8, 1, 3, 40, 37, False, 5)):
            q, dout, out, dq = (torch.zeros(B, H, Sq, hd, dtype=dtype) for _ in range(4))
            k, v, dk, dv = (torch.zeros(B, KV, Sk, hd, dtype=dtype) for _ in range(4))
            lse = dsum = torch.zeros(B, H, Sq)
            args = _bwd_args(q, k, v, out, dout, dq, dk, dv, lse, dsum, off, causal, win, 0)
            assert len(args) == len(argtypes)
            rows, keys = bwd_tf32_blocks(B, H, KV, Sq, Sk, hd)
            blocks = (bwd_keys(causal, win, hd), 0) if dtype == torch.bfloat16 else (keys, rows)
            assert args[:4] == (DTYPES[dtype], BWD_ROUTES[bwd_route(dtype, hd)], *blocks)
            if dtype == torch.bfloat16:
                assert _bwd_args(q, k, v, out, dout, dq, dk, dv, lse, dsum, off, causal, win, 0,
                                 keys=64)[2] == 64


@pytest.mark.parametrize("label", list(cases.FLASH_BWD_TRAIN))
def test_flash_bwd_tf32_blocks_fill_the_card(label):
    """The split-TF32 route's blocks at the training shapes: each kernel's
    grid has at least 132 blocks (the 100M twin's 16 positions and 16 keys:
    256 each), within the largest block that fits at the case's hd."""
    B, H, KV, Sq, Sk, hd = cases.FLASH_BWD_TRAIN[label][:6]
    rows, keys = bwd_tf32_blocks(B, H, KV, Sq, Sk, hd)
    assert -(-Sq // rows) * H * B >= 132 and -(-Sk // keys) * KV * B >= 132
    assert rows <= (128 if hd <= 128 else 64 if hd <= 192 else 32)
    assert keys <= (128 if hd <= 80 else 64 if hd <= 192 else 32)
    if label == "100M twin":
        assert (rows, keys) == (16, 16)


@pytest.mark.parametrize("label", list(cases.FLASH_BWD_TRAIN))
def test_flash_fwd_tf32_rows_fill_the_card(label):
    """The fp32 forward's blocks at the training shapes: rows a multiple of
    16 and at least G, the largest whose grid has at least FWD_FILL (128)
    blocks where any size gives that many (the 100M twin: 32 rows, 128
    blocks), within the largest block that fits at the case's hd."""
    B, H, KV, Sq, Sk, hd = cases.FLASH_BWD_TRAIN[label][:6]
    G = H // KV
    most = 128 if hd <= 128 else 64 if hd <= 192 else 32

    def grid(rows):
        return -(-Sq // (rows // G)) * KV * B

    rows = fwd_tf32_rows(B, H, KV, Sq, hd)
    assert rows % 16 == 0 and G <= rows <= most
    assert grid(rows) >= 128 or all(grid(r) < 128 for r in range(16, most + 1, 16) if r >= G)
    assert all(grid(r) < 128 for r in range(rows + 16, most + 1, 16))
    if label == "100M twin":
        assert (rows, grid(rows)) == (32, 128)


@pytest.mark.parametrize("causal, window, keys", [(True, None, 64), (True, 4096, 128),
                                                  (False, None, 128), (False, 7, 128)])
def test_flash_bwd_keys_follow_the_mask(causal, window, keys):
    """64-key dK/dV blocks under a causal mask without a window (the first
    keys see every row), 128 with a window or without a causal mask; a
    block of another size is refused before any launch."""
    assert bwd_keys(causal, window, 128) == keys
    with pytest.raises(ValueError, match="64 or 128"):
        ops.flash_attention_bwd(*(torch.zeros(1, 2, 4, 8) for _ in range(5)), causal=causal,
                                window=window, keys=96)


@pytest.mark.parametrize("hd", [136, 192, 256])
@pytest.mark.parametrize("causal, window", [(True, None), (True, 2048), (False, None),
                                            (False, 7)])
def test_flash_bwd_keys_are_64_past_hd_128(hd, causal, window):
    """Past hd 128 the wide kernels have one dK/dV block, 64 keys, whatever
    the mask; a block of 128 keys is refused before any launch."""
    assert bwd_keys(causal, window, hd) == 64
    assert bwd_blocks(hd) == (64,)
    with pytest.raises(ValueError, match="takes 64 keys at hd"):
        ops.flash_attention_bwd(*(torch.zeros(1, 2, 4, hd) for _ in range(5)), causal=causal,
                                window=window, keys=128)


def test_rows16_gives_16_byte_rows_and_the_same_values():
    """Tensors the TMA unit takes pass as they are; the others (an odd hd,
    a storage offset off 16 bytes) become padded copies of the same values
    whose strides are whole 16-byte chunks."""
    x = torch.randn(2, 4, 6, 64).to(torch.bfloat16)
    t = x.transpose(1, 2)                  # a view by strides, each a whole chunk
    assert rows16(x) is x and rows16(t) is t
    for t in (torch.randn(1, 2, 5, 7).to(torch.bfloat16),
              cases.at_offset(torch.randn(1, 2, 5, 16).to(torch.bfloat16), 1)):
        got = rows16(t)
        assert got.data_ptr() % 16 == 0 and got.stride(-1) == 1
        assert all(st % 8 == 0 for st in got.stride()[:3]) and torch.equal(got, t)


def test_phases_cover_the_main_paths_bf16_flash_calls():
    got = phases.shapes()
    assert got["yi-6b turn 2"] == (1, 32, 4, 512, 2560, 128, 2048, None, True)
    assert got["yi-6b cold"] == (1, 32, 4, 2560, 2560, 128, 0, None, True)
    assert got["recurrentgemma-2b prefill"] == cases.FLASH_GRIFFIN[0]
    counts = [10, 20, 30, 40, 50, 5] + [0, 0, 0, 0, 0, 0]
    assert phases.per_tile(counts) == {0: (5, [2.0, 4.0, 6.0, 8.0, 10.0]),
                                       1: (0, [0.0] * 5)}


def test_build_dir_in_checkout_and_installed(tmp_path, monkeypatch):
    assert build.BUILD_DIR == ROOT / "build" / "repro_torch_kernels"
    site = tmp_path / "lib" / "python3.12" / "site-packages"
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert build.build_dir_for(site / "repro_torch" / "kernels" / "build.py") \
        == tmp_path / "cache" / "repro_torch_kernels"


def test_nvcc_flags_target_hopper():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert {"-O3", "-shared", "-fPIC"} <= set(build.NVCC_FLAGS)


# --------------------------------------------------------------------------- #
# the port's rules
# --------------------------------------------------------------------------- #

def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_each_xdist_worker_takes_its_share_of_the_cores():
    """tests/torch_threads.py, imported by every port test file, sets
    PyTorch's intra-op threads to the host's cores over pytest-xdist's
    workers (all of them without xdist), so the workers do not oversubscribe
    the host."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    assert torch_threads.WORKERS == workers
    assert torch.get_num_threads() == torch_threads.THREADS == max(
        1, torch_threads.cores() // workers)
    tests = Path(__file__).resolve().parent
    for f in sorted(tests.glob("test_torch_*.py")):
        assert "\nimport torch_threads" in f.read_text(), f.name


def test_port_imports_neither_jax_nor_reference():
    """Nor msgpack, which the machine with the card does not have (the
    checkpoints' manifest goes through ``train/checkpoint.py``'s codec)."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    assert ROOT / "src" / "repro_torch" / "train" / "checkpoint.py" in files
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "msgpack"), f"{f}: imports {mod}"


def test_kernel_sources_call_no_library_attention():
    for src in (build.CSRC).glob("*.cu"):
        text = src.read_text()
        for banned in ("cublas", "cudnn", "scaled_dot_product", "#include <torch"):
            assert banned not in text.lower(), f"{src.name}: {banned}"
    # bf16 flash runs on the wgmma kernel only: the split-TF32 one has no
    # bf16 instantiation, and the CUDA-core fp32 kernel is gone
    flash = (build.CSRC / "flash_attention.cu").read_text()
    assert re.search(r"flash_tf32_kernel<\s*__nv_bfloat16", flash) is None
    assert "flash_tf32_kernel<" in flash and re.search(r"\bflash_kernel\b", flash) is None
