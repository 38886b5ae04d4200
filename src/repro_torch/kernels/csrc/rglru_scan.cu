// RG-LRU diagonal linear recurrence for Hopper (sm_90a), plain CUDA C++, fp32.
//
// Replaces the Pallas TPU kernel repro/kernels/rglru.py (rglru_scan /
// _rglru_kernel), and at the decode step the XLA fusion around the
// reference's step (repro/models/griffin.py::rglru_step). Three entries:
//
// rglru_scan_launch -> rglru_fwd_carry_kernel, rglru_fwd_kernel: the
// sequence. Per (batch, channel):
//
//   h = h0[b, d];  for t < S:  h = a[b, t, d] * h + b[b, t, d];  y[b, t, d] = h
//   hn[b, d] = h
//
//   a, b, y (B,S,D); h0 and hn (B,D); all fp32. a, b, y and h0 come by
//   strides with the channel dimension contiguous, so the model's tensors
//   are read and written in place; hn is contiguous.
//
//   Bound on the H100: bytes, 4·(3·B·S·D + 2·B·D) at 3.35 TB/s (2·B·S·D
//   fp32 operations are far below the 67 TFLOP/s line): 23 µs at the model
//   phase's prefill (1,2560,2560), 75 µs at recurrentgemma-2b's training
//   shape (1,8192,2560). One thread walking a channel's whole chain gives
//   batch 1 only D/256 blocks (10 for 132 SMs) and an S-step dependent chain
//   each, far above that bound.
//
//   Design: a chunked two-pass scan, the backward's pattern (below) run
//   forward; a decoupled look-back single pass would save pass 1's reads
//   but makes a block wait on its predecessors, and this order is fixed
//   with no waiting. The recurrence is cut along time into chunks of
//   kScanChunk = 128 steps, one thread a channel, blocks of 128 channels
//   over (d-block, chunk, batch): at (1,8192,2560) 20 x 64 blocks, at
//   (1,2560,2560) 20 x 20. The state out of a chunk is affine in the state
//   into it: L + M·h, with L the chunk's scan from a zero state and M the
//   product of its a's. Pass 1 (rglru_fwd_carry_kernel, chunks 0..K-2)
//   writes (L, M), 2·B·K·D fp32 (1.3 MB at the training shape, in L2);
//   pass 2 (rglru_fwd_kernel, every chunk) folds h0 through the (L, M) of
//   the chunks before its own, first first, by fmaf, then walks its steps
//   with that state, rounding each product and sum apart (__fmul_rn,
//   __fadd_rn) as the plain version `a_t * h + b_t` does (the compiler would
//   otherwise contract them into one FMA), and writes y; the last chunk
//   writes h_S. At S <= 128 (one chunk) pass 2 runs alone from h0 and the
//   result is the plain version's bit for bit; past it the folded states
//   round otherwise than one long chain, so it holds RGLRU_TOL, not the
//   bits, and two calls give the same bits (no atomics, a fixed order).
//   a_t and b_t do not depend on h: each thread loads them kAhead steps
//   ahead, so only the multiply-add chain is serial. Bytes moved: pass 1
//   reads a and b, pass 2 a and b and writes y, about 5·B·S·D·4, 1.7× the
//   bound's. Any D (the Pallas kernel's block_d and its divisibility
//   assert are TPU tiling), any S >= 0 (S = 0 copies h0 to hn), any B up to
//   the grid's 65,535.
//
// rglru_scan_bwd_launch -> rglru_bwd_carry_kernel, rglru_bwd_kernel: the
// scan's gradient, which the reference takes by autodiff of its
// associative_scan (repro/models/griffin.py::rglru_scan,
// repro/kernels/ref.py::rglru_scan_ref); no Pallas kernel. Per (batch,
// channel), from the scan's output y and the output gradients dy and dh_S
// (zero if none):
//
//   carry = dh_S;  for t = S-1 down to 0:  g = dy[t] + carry;
//   db[t] = g;  da[t] = g * y[t-1] (h0 at t = 0);  carry = a[t] * g
//   dh0 = carry
//
//   a, y, dy, da, db (B,S,D) by strides, the channel dimension contiguous;
//   h0 by a batch stride; dh_S and dh0 (B,D) contiguous; fp32. Bound: bytes,
//   4·(5·B·S·D + 3·B·D) (a, y, dy in; da, db out; h0, dh_S, dh0) at 3.35
//   TB/s, 0.125 ms at recurrentgemma-2b's training shape (1,8192,2560).
//
//   Design. The reverse recurrence is cut along time into chunks of
//   kBwdChunk = 128 steps, so at batch 1 the 20 channel blocks of 128 become
//   20 x 64 blocks instead of a 10-block, 8,192-step chain. The carry out of
//   a chunk is affine in the carry into it: L + M·c, with L its reverse scan
//   from a zero carry (times a_{t0}) and M the product of its a's. Pass 1
//   (rglru_bwd_carry_kernel, chunks 1..K-1) writes (L, M), 2·B·K·D fp32
//   (1.3 MB at the training shape, in L2); pass 2 (rglru_bwd_kernel, every
//   chunk) folds dh_S through the (L, M) of the chunks after its own, last
//   first, then walks its steps with that carry, rounding each product and
//   sum separately (__fmul_rn, __fadd_rn) as the plain version does; chunk
//   0 writes dh0. The composed carries round differently from one long
//   chain, so the result is not the plain version's bit for bit; it is the
//   same bits from call to call (no atomics, a fixed order). At S <= 128 one
//   chunk, pass 2 alone. Bytes moved: pass 1 reads a and dy, pass 2 a, y and
//   dy and writes da and db, about 7·B·S·D·4, 1.4× the bound's.
//
// rglru_step_launch -> rglru_step_kernel<T, VEC>, one decode step with its
// whole elementwise chain, from the two fp32 GEMV outputs gx_a = x·wa and
// gx_x = x·wx (torch.matmul, outside the kernel). Per (batch, channel):
//
//   r = σ(gx_a + ba), i = σ(gx_x + bx), log_a = -8·softplus(λ)·r,
//   a = exp(log_a), b = sqrt(max(1 - exp(2·log_a), 1e-12))·i·x,
//   h' = a·h + b;   y = h' rounded to x's type T (bf16: to nearest even)
//
//   gx_a, gx_x, h (B,D) fp32 and x (B,D) T by a batch stride, the channel
//   dimension contiguous; ba, bx, lam (D,) fp32; y (B,D) T and hn (B,D)
//   fp32 contiguous. Every elementwise operation rounds as the plain
//   version's PyTorch op does (__fadd_rn, __fmul_rn: no contraction into
//   FMAs); exp, log1p and sqrt are the precise library functions.
//
//   Design. At the engine's step (1,2560) the call moves 4·(7·D) + 2·2·D
//   bytes, 82 KB, 0.025 µs at 3.35 TB/s: far below the fixed cost of a
//   launch. So the gain is in launches: this one replaces the ~15 PyTorch
//   launches of the chain around the recurrence (bias adds, sigmoids,
//   softplus, exps, clamp, square root, products, the recurrence, y's
//   cast), as XLA's fusion does on the TPU. A thread takes 4 adjacent
//   channels, every load 16 bytes (8 for bf16) and issued before the first
//   use; VEC is that vector path (D % 4 == 0, bases and batch strides
//   aligned to 4 elements), otherwise the same threads load element by
//   element. Any D, B up to 65,535.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScanChunk = 128;     // steps per chunk (scan)
constexpr int kScanThreads = 128;   // channels per block (scan)
constexpr int kAhead = 8;           // time steps loaded ahead of the chain
constexpr int kStepThreads = 128;   // threads per block (step), 4 channels each
constexpr int kBwdChunk = 128;      // steps per chunk (backward)
constexpr int kBwdThreads = 128;    // channels per block (backward)

// the scan's chunks at length S: ceil(S / kScanChunk), one at S <= kScanChunk
inline int scan_chunks(int S) { return S > kScanChunk ? (S + kScanChunk - 1) / kScanChunk : 1; }
// the backward's chunks at length S: ceil(S / kBwdChunk), one at S <= kBwdChunk
inline int bwd_chunks(int S) { return S > kBwdChunk ? (S + kBwdChunk - 1) / kBwdChunk : 1; }

struct Params {
  const float* __restrict__ a;
  const float* __restrict__ b;
  const float* __restrict__ h0;
  float* __restrict__ y;
  float* __restrict__ hn;
  float* __restrict__ lm;          // (L, M) of each chunk: [2][B][K][D]
  int S, D, K;
  long long a_sb, a_ss, b_sb, b_ss, y_sb, y_ss, h_sb;
};

// a_t and b_t of the kAhead steps t0, t0 + 1, ...; steps at or past hi read
// as 0.
__device__ __forceinline__ void load_chunk(const Params& p, const float* a,
                                           const float* b, int t0, int hi,
                                           float (&at)[kAhead], float (&bt)[kAhead]) {
#pragma unroll
  for (int c = 0; c < kAhead; ++c) {
    const int t = t0 + c;
    at[c] = t < hi ? __ldg(a + (long long)t * p.a_ss) : 0.f;
    bt[c] = t < hi ? __ldg(b + (long long)t * p.b_ss) : 0.f;
  }
}

// Pass 1, chunks 0 .. K-2: the chunk's scan from a zero state gives L, its
// last h, and M = Π a_t over the chunk; the true state out of the chunk is
// L + M · (the state into it).
__global__ void __launch_bounds__(kScanThreads) rglru_fwd_carry_kernel(const Params p) {
  const int d = blockIdx.x * kScanThreads + threadIdx.x;
  const int kc = blockIdx.y, bi = blockIdx.z;
  if (d >= p.D) return;
  const int lo = kc * kScanChunk, hi = min(p.S, lo + kScanChunk);
  const float* a = p.a + bi * p.a_sb + d;
  const float* b = p.b + bi * p.b_sb + d;
  float h = 0.f, m = 1.f;
  float an[kAhead], bn[kAhead];
  load_chunk(p, a, b, lo, hi, an, bn);
  for (int t0 = lo; t0 < hi; t0 += kAhead) {
    float at[kAhead], bt[kAhead];
#pragma unroll
    for (int c = 0; c < kAhead; ++c) { at[c] = an[c]; bt[c] = bn[c]; }
    if (t0 + kAhead < hi) load_chunk(p, a, b, t0 + kAhead, hi, an, bn);
#pragma unroll
    for (int c = 0; c < kAhead; ++c) {
      if (t0 + c < hi) {
        h = __fadd_rn(__fmul_rn(at[c], h), bt[c]);
        m = __fmul_rn(m, at[c]);
      }
    }
  }
  const long long o = ((long long)bi * p.K + kc) * p.D + d;
  p.lm[o] = h;
  p.lm[(long long)gridDim.z * p.K * p.D + o] = m;
}

// Pass 2, every chunk: the state into the chunk, folded from h0 through the
// (L, M) of the chunks before it, first first (the same order in every
// block, so a chunk starts from the state its predecessor ends with), then
// the chunk's steps, each product and sum rounded apart as the plain
// version rounds them; the last chunk writes h_S.
__global__ void __launch_bounds__(kScanThreads) rglru_fwd_kernel(const Params p) {
  const int d = blockIdx.x * kScanThreads + threadIdx.x;
  const int kc = blockIdx.y, bi = blockIdx.z;
  if (d >= p.D) return;
  const int lo = kc * kScanChunk, hi = min(p.S, lo + kScanChunk);
  const float* a = p.a + bi * p.a_sb + d;
  const float* b = p.b + bi * p.b_sb + d;
  float* y = p.y + bi * p.y_sb + d;
  float an[kAhead], bn[kAhead];
  if (lo < hi) load_chunk(p, a, b, lo, hi, an, bn);
  float h = __ldg(p.h0 + bi * p.h_sb + d);
  for (int j0 = 0; j0 < kc; j0 += kAhead) {
    const float* L = p.lm + (long long)bi * p.K * p.D + d;
    const float* M = L + (long long)gridDim.z * p.K * p.D;
    float lj[kAhead], mj[kAhead];
#pragma unroll
    for (int c = 0; c < kAhead; ++c) {
      const int j = j0 + c;
      lj[c] = j < kc ? __ldg(L + (long long)j * p.D) : 0.f;
      mj[c] = j < kc ? __ldg(M + (long long)j * p.D) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < kAhead; ++c)
      if (j0 + c < kc) h = fmaf(mj[c], h, lj[c]);
  }
  for (int t0 = lo; t0 < hi; t0 += kAhead) {
    float at[kAhead], bt[kAhead];
#pragma unroll
    for (int c = 0; c < kAhead; ++c) { at[c] = an[c]; bt[c] = bn[c]; }
    if (t0 + kAhead < hi) load_chunk(p, a, b, t0 + kAhead, hi, an, bn);
#pragma unroll
    for (int c = 0; c < kAhead; ++c) {
      if (t0 + c < hi) {
        h = __fadd_rn(__fmul_rn(at[c], h), bt[c]);
        y[(long long)(t0 + c) * p.y_ss] = h;
      }
    }
  }
  if (kc == p.K - 1) p.hn[(long long)bi * p.D + d] = h;
}

struct BwdParams {
  const float* __restrict__ a;
  const float* __restrict__ h0;
  const float* __restrict__ y;
  const float* __restrict__ dy;
  const float* __restrict__ dhn;   // null: zero
  float* __restrict__ da;
  float* __restrict__ db;
  float* __restrict__ dh0;
  float* __restrict__ lm;          // (L, M) of each chunk: [2][B][K][D]
  int S, D, K;
  long long a_sb, a_ss, y_sb, y_ss, dy_sb, dy_ss, da_sb, da_ss, db_sb, db_ss, h_sb;
};

// a_t, dy_t and (with Y) y_{t-1} (h0 at t = 0) for the kAhead steps t0,
// t0 - 1, ... walking back; steps before lo read as 0.
template <bool Y>
__device__ __forceinline__ void load_back(const BwdParams& p, const float* a, const float* y,
                                          const float* dy, float h0, int t0, int lo,
                                          float (&at)[kAhead], float (&yt)[kAhead],
                                          float (&gt)[kAhead]) {
#pragma unroll
  for (int c = 0; c < kAhead; ++c) {
    const int t = t0 - c;
    at[c] = t >= lo ? __ldg(a + t * p.a_ss) : 0.f;
    if constexpr (Y) yt[c] = t >= lo ? (t > 0 ? __ldg(y + (t - 1) * p.y_ss) : h0) : 0.f;
    gt[c] = t >= lo ? __ldg(dy + t * p.dy_ss) : 0.f;
  }
}

// Pass 1, chunks 1 .. K-1: the chunk's reverse scan from a zero carry gives
// L = a_{t0} g'_{t0}, the carry it sends down, and M = Π a_t over the chunk;
// the true carry out of the chunk is L + M · (the carry into it).
__global__ void __launch_bounds__(kBwdThreads) rglru_bwd_carry_kernel(const BwdParams p) {
  const int d = blockIdx.x * kBwdThreads + threadIdx.x;
  const int kc = blockIdx.y + 1, bi = blockIdx.z;
  if (d >= p.D) return;
  const int lo = kc * kBwdChunk, hi = min(p.S, lo + kBwdChunk);
  const float* a = p.a + bi * p.a_sb + d;
  const float* dy = p.dy + bi * p.dy_sb + d;
  float carry = 0.f, m = 1.f;
  float an[kAhead], gn[kAhead], unused[kAhead];
  load_back<false>(p, a, nullptr, dy, 0.f, hi - 1, lo, an, unused, gn);
  for (int t0 = hi - 1; t0 >= lo; t0 -= kAhead) {
    float at[kAhead], gt[kAhead];
#pragma unroll
    for (int c = 0; c < kAhead; ++c) { at[c] = an[c]; gt[c] = gn[c]; }
    if (t0 - kAhead >= lo)
      load_back<false>(p, a, nullptr, dy, 0.f, t0 - kAhead, lo, an, unused, gn);
#pragma unroll
    for (int c = 0; c < kAhead; ++c) {
      if (t0 - c >= lo) {
        carry = __fmul_rn(at[c], __fadd_rn(gt[c], carry));
        m = __fmul_rn(m, at[c]);
      }
    }
  }
  const long long o = ((long long)bi * p.K + kc) * p.D + d;
  p.lm[o] = carry;
  p.lm[(long long)gridDim.z * p.K * p.D + o] = m;
}

// Pass 2, every chunk: the carry into the chunk, folded from dh_S through
// the (L, M) of the chunks after it, last first (the same order in every
// block, so a chunk's carry is the one its successor sends), then the
// chunk's steps with the scan's rounding.
__global__ void __launch_bounds__(kBwdThreads) rglru_bwd_kernel(const BwdParams p) {
  const int d = blockIdx.x * kBwdThreads + threadIdx.x;
  const int kc = blockIdx.y, bi = blockIdx.z;
  if (d >= p.D) return;
  const int lo = kc * kBwdChunk, hi = min(p.S, lo + kBwdChunk);
  const float* a = p.a + bi * p.a_sb + d;
  const float* y = p.y + bi * p.y_sb + d;
  const float* dy = p.dy + bi * p.dy_sb + d;
  float* da = p.da + bi * p.da_sb + d;
  float* db = p.db + bi * p.db_sb + d;
  const float h0 = __ldg(p.h0 + bi * p.h_sb + d);
  float an[kAhead], yn[kAhead], gn[kAhead];
  if (lo < hi) load_back<true>(p, a, y, dy, h0, hi - 1, lo, an, yn, gn);
  // carry = a_{t+1} g_{t+1}, the gradient that reaches h_t from the later
  // steps; dh_S at t = S - 1
  float carry = p.dhn != nullptr ? __ldg(p.dhn + (long long)bi * p.D + d) : 0.f;
  for (int j0 = p.K - 1; j0 > kc; j0 -= kAhead) {
    const float* L = p.lm + (long long)bi * p.K * p.D + d;
    const float* M = L + (long long)gridDim.z * p.K * p.D;
    float lj[kAhead], mj[kAhead];
#pragma unroll
    for (int c = 0; c < kAhead; ++c) {
      const int j = j0 - c;
      lj[c] = j > kc ? __ldg(L + (long long)j * p.D) : 0.f;
      mj[c] = j > kc ? __ldg(M + (long long)j * p.D) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < kAhead; ++c)
      if (j0 - c > kc) carry = fmaf(mj[c], carry, lj[c]);
  }
  for (int t0 = hi - 1; t0 >= lo; t0 -= kAhead) {
    float at[kAhead], yt[kAhead], gt[kAhead];
#pragma unroll
    for (int c = 0; c < kAhead; ++c) { at[c] = an[c]; yt[c] = yn[c]; gt[c] = gn[c]; }
    if (t0 - kAhead >= lo) load_back<true>(p, a, y, dy, h0, t0 - kAhead, lo, an, yn, gn);
#pragma unroll
    for (int c = 0; c < kAhead; ++c) {
      const int t = t0 - c;
      if (t >= lo) {
        const float g = __fadd_rn(gt[c], carry);       // g_t = dy_t + a_{t+1} g_{t+1}
        db[(long long)t * p.db_ss] = g;
        da[(long long)t * p.da_ss] = __fmul_rn(g, yt[c]);
        carry = __fmul_rn(at[c], g);
      }
    }
  }
  if (kc == 0) p.dh0[(long long)bi * p.D + d] = carry;   // a_0 g_0, or dh_S at S = 0
}

struct StepParams {
  const float* __restrict__ ga;
  const float* __restrict__ gx;
  const float* __restrict__ ba;
  const float* __restrict__ bx;
  const float* __restrict__ lam;
  const void* __restrict__ x;     // T
  const float* __restrict__ h;
  void* __restrict__ y;           // T
  float* __restrict__ hn;
  int D;
  long long ga_sb, gx_sb, x_sb, h_sb;
};

__device__ __forceinline__ float ld1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __uint_as_float(
      (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// o[0..3] = p[0..3] as fp32; elements at or past n read as 0. With VEC, p
// is aligned to 4 elements and n >= 4 (D % 4 == 0).
template <bool VEC>
__device__ __forceinline__ void load4(const float* p, int n, float* o) {
  if (VEC) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = e < n ? ld1(p + e) : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void load4(const __nv_bfloat16* p, int n, float* o) {
  if (VEC) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    o[0] = __uint_as_float(q.x << 16);
    o[1] = __uint_as_float(q.x & 0xffff0000u);
    o[2] = __uint_as_float(q.y << 16);
    o[3] = __uint_as_float(q.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = e < n ? ld1(p + e) : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* p, int n, const float* o) {
  if (VEC) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) p[e] = o[e];
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(__nv_bfloat16* p, int n, const float* o) {
  unsigned short q[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) q[e] = __bfloat16_as_ushort(__float2bfloat16_rn(o[e]));
  if (VEC) {
    *reinterpret_cast<uint2*>(p) = make_uint2(q[0] | (unsigned)q[1] << 16,
                                              q[2] | (unsigned)q[3] << 16);
  } else {
    unsigned short* u = reinterpret_cast<unsigned short*>(p);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) u[e] = q[e];
  }
}

// torch.sigmoid and F.softplus (beta 1, threshold 20) as PyTorch computes them
__device__ __forceinline__ float sigmoid(float v) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v)));
}
__device__ __forceinline__ float softplus(float v) { return v > 20.f ? v : log1pf(expf(v)); }

template <typename T, bool VEC>
__global__ void __launch_bounds__(kStepThreads) rglru_step_kernel(const StepParams p) {
  const int d0 = (blockIdx.x * kStepThreads + threadIdx.x) * 4;
  const long long bi = blockIdx.y;
  if (d0 >= p.D) return;
  const int n = p.D - d0;
  float ga[4], gx[4], ba[4], bx[4], lam[4], x[4], h[4];
  load4<VEC>(p.ga + bi * p.ga_sb + d0, n, ga);
  load4<VEC>(p.gx + bi * p.gx_sb + d0, n, gx);
  load4<VEC>(p.ba + d0, n, ba);
  load4<VEC>(p.bx + d0, n, bx);
  load4<VEC>(p.lam + d0, n, lam);
  load4<VEC>(static_cast<const T*>(p.x) + bi * p.x_sb + d0, n, x);
  load4<VEC>(p.h + bi * p.h_sb + d0, n, h);
  float hn[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float r = sigmoid(__fadd_rn(ga[e], ba[e]));
    const float i = sigmoid(__fadd_rn(gx[e], bx[e]));
    const float log_a = __fmul_rn(__fmul_rn(-8.f, softplus(lam[e])), r);
    const float a = expf(log_a);
    const float s = sqrtf(fmaxf(__fsub_rn(1.f, expf(__fmul_rn(2.f, log_a))), 1e-12f));
    const float b = __fmul_rn(__fmul_rn(s, i), x[e]);
    hn[e] = __fadd_rn(__fmul_rn(a, h[e]), b);
  }
  store4<VEC>(p.hn + bi * p.D + d0, n, hn);
  store4<VEC>(static_cast<T*>(p.y) + bi * p.D + d0, n, hn);
}

template <typename T>
void launch_step(const StepParams& p, int B, cudaStream_t st) {
  auto ok = [](const void* q, int elem) {
    return reinterpret_cast<uintptr_t>(q) % (4u * elem) == 0;
  };
  const int et = (int)sizeof(T);
  const bool vec = p.D % 4 == 0 && p.ga_sb % 4 == 0 && p.gx_sb % 4 == 0 &&
                   p.x_sb % 4 == 0 && p.h_sb % 4 == 0 && ok(p.ga, 4) && ok(p.gx, 4) &&
                   ok(p.ba, 4) && ok(p.bx, 4) && ok(p.lam, 4) && ok(p.x, et) &&
                   ok(p.h, 4) && ok(p.y, et) && ok(p.hn, 4);
  const int quads = (p.D + 3) / 4;
  const dim3 grid((unsigned)((quads + kStepThreads - 1) / kStepThreads), (unsigned)B);
  if (vec)
    rglru_step_kernel<T, true><<<grid, kStepThreads, 0, st>>>(p);
  else
    rglru_step_kernel<T, false><<<grid, kStepThreads, 0, st>>>(p);
}

}  // namespace

extern "C" {

// The scan's plan at (B, S, D): returns the device kernels one call of
// rglru_scan_launch launches (rglru_fwd_carry_kernel past one chunk of
// kScanChunk steps, then rglru_fwd_kernel) and writes to *lm_floats the fp32
// scratch it takes as lm, 2·B·K·D for K = ceil(S / kScanChunk) chunks (0 at
// one chunk); -1 for a shape the launch refuses (B outside 1..65535, S < 0,
// D <= 0, K above 65535).
int rglru_scan_plan(int B, int S, int D, long long* lm_floats) {
  const int K = scan_chunks(S);
  if (B <= 0 || B > 65535 || S < 0 || D <= 0 || K > 65535) return -1;
  *lm_floats = K > 1 ? 2LL * B * K * D : 0;
  return K > 1 ? 2 : 1;
}

// a, b, y: strides of (batch, step); h0: of batch; the channel dimension of
// each is contiguous. hn is contiguous (B,D). lm holds the fp32 scratch that
// rglru_scan_plan gives (null at one chunk). Returns a cudaError_t (0 =
// launched; cudaErrorInvalidValue for a shape the plan refuses or no lm past
// one chunk).
int rglru_scan_launch(const float* a, const float* b, const float* h0, float* y,
                      float* hn, float* lm, int B, int S, int D,
                      long long a_sb, long long a_ss, long long b_sb, long long b_ss,
                      long long y_sb, long long y_ss, long long h_sb, void* stream) {
  const int K = scan_chunks(S);
  if (B <= 0 || B > 65535 || S < 0 || D <= 0 || K > 65535 || (K > 1 && lm == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.a = a; p.b = b; p.h0 = h0; p.y = y; p.hn = hn; p.lm = lm;
  p.S = S; p.D = D; p.K = K;
  p.a_sb = a_sb; p.a_ss = a_ss; p.b_sb = b_sb; p.b_ss = b_ss;
  p.y_sb = y_sb; p.y_ss = y_ss; p.h_sb = h_sb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned dblocks = (unsigned)((D + kScanThreads - 1) / kScanThreads);
  if (K > 1) {
    rglru_fwd_carry_kernel<<<dim3(dblocks, (unsigned)(K - 1), (unsigned)B), kScanThreads, 0,
                             st>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  rglru_fwd_kernel<<<dim3(dblocks, (unsigned)K, (unsigned)B), kScanThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// The backward's plan at (B, S, D): returns the device kernels one call of
// rglru_scan_bwd_launch launches (rglru_bwd_carry_kernel past one chunk of
// kBwdChunk steps, then rglru_bwd_kernel) and writes to *lm_floats the fp32
// scratch it takes as lm, 2·B·K·D for K = ceil(S / kBwdChunk) chunks (0 at
// one chunk); -1 for a shape the launch refuses (B outside 1..65535, S < 0,
// D <= 0, K above 65535).
int rglru_scan_bwd_plan(int B, int S, int D, long long* lm_floats) {
  const int K = bwd_chunks(S);
  if (B <= 0 || B > 65535 || S < 0 || D <= 0 || K > 65535) return -1;
  *lm_floats = K > 1 ? 2LL * B * K * D : 0;
  return K > 1 ? 2 : 1;
}

// The scan's backward. a, y (the scan's output), dy, da, db: strides of
// (batch, step); h0: of batch; the channel dimension of each is contiguous.
// dh_S (null: zero) and dh0 are contiguous (B,D). lm holds the fp32 scratch
// that rglru_scan_bwd_plan gives (null at one chunk). Returns a cudaError_t
// (0 = launched; cudaErrorInvalidValue for a shape the plan refuses or no
// lm past one chunk).
int rglru_scan_bwd_launch(const float* a, const float* h0, const float* y, const float* dy,
                          const float* dhn, float* da, float* db, float* dh0, float* lm,
                          int B, int S, int D,
                          long long a_sb, long long a_ss, long long y_sb, long long y_ss,
                          long long dy_sb, long long dy_ss, long long da_sb, long long da_ss,
                          long long db_sb, long long db_ss, long long h_sb, void* stream) {
  const int K = bwd_chunks(S);
  if (B <= 0 || B > 65535 || S < 0 || D <= 0 || K > 65535 || (K > 1 && lm == nullptr))
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.a = a; p.h0 = h0; p.y = y; p.dy = dy; p.dhn = dhn; p.da = da; p.db = db; p.dh0 = dh0;
  p.lm = lm; p.S = S; p.D = D; p.K = K;
  p.a_sb = a_sb; p.a_ss = a_ss; p.y_sb = y_sb; p.y_ss = y_ss; p.dy_sb = dy_sb;
  p.dy_ss = dy_ss; p.da_sb = da_sb; p.da_ss = da_ss; p.db_sb = db_sb; p.db_ss = db_ss;
  p.h_sb = h_sb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned dblocks = (unsigned)((D + kBwdThreads - 1) / kBwdThreads);
  if (K > 1) {
    rglru_bwd_carry_kernel<<<dim3(dblocks, (unsigned)(K - 1), (unsigned)B), kBwdThreads, 0,
                             st>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  rglru_bwd_kernel<<<dim3(dblocks, (unsigned)K, (unsigned)B), kBwdThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// gx_a, gx_x, x, h: batch strides (the channel dimension contiguous); ba,
// bx, lam (D,) and y, hn (B,D) contiguous; x and y bf16 if x_bf16, else
// fp32. Returns a cudaError_t (0 = launched; cudaErrorInvalidValue for B
// outside 1..65535 or D <= 0).
int rglru_step_launch(const float* gx_a, const float* gx_x, const float* ba,
                      const float* bx, const float* lam, const void* x, const float* h,
                      void* y, float* hn, int B, int D, int x_bf16,
                      long long ga_sb, long long gx_sb, long long x_sb, long long h_sb,
                      void* stream) {
  if (B <= 0 || B > 65535 || D <= 0) return (int)cudaErrorInvalidValue;
  StepParams p;
  p.ga = gx_a; p.gx = gx_x; p.ba = ba; p.bx = bx; p.lam = lam; p.x = x; p.h = h;
  p.y = y; p.hn = hn; p.D = D;
  p.ga_sb = ga_sb; p.gx_sb = gx_sb; p.x_sb = x_sb; p.h_sb = h_sb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    launch_step<__nv_bfloat16>(p, B, st);
  else
    launch_step<float>(p, B, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
