// RWKV6 ("Finch") WKV recurrence for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/wkv6.py (wkv6 / _wkv_kernel).
// Per (batch, head) the hd x hd state S is carried through the sequence:
//
//   y_t     = (S_t + u ⊙ (k_t ⊗ v_t))ᵀ r_t        (state before the update)
//   S_{t+1} = diag(w_t) S_t + k_t ⊗ v_t
//
//   r, k, v (B,H,S,hd) fp32 or bf16 (all three alike; bf16 is upcast in
//   registers, exactly, so the function is the fp32 one on the upcast
//   values); w and y (B,H,S,hd), u (H,hd), s0 and s_n (B,H,hd,hd), fp32.
//   Every tensor but s_n comes by strides with its last dimension
//   contiguous, so the model's (B,S,H,hd) activations are read, and y
//   written, in place through permuted views. s_n is contiguous.
//
// Two kernels behind the one entry, wkv6_launch:
//
//  * S == 1, the engine's step -> wkv6_step_kernel<HD, T, P>. The call is
//    one read and one write of the state, 2·hd² of the 5·hd + 2·hd² words a
//    head moves, and no time loop; what it costs is latency, and with the
//    state cold in device memory (the model's weights pass through L2
//    between two steps of a layer) the latency of its reads. y_j needs only
//    column j of S and every row, so the columns of a head are split into
//    8-column slices, one warp (one CTA) per (b, h, slice): 256 CTAs at
//    rwkv6-1.6b's (1,32,1,64), two on most SMs. Lane (g, c) owns columns
//    4c..4c+3 of its slice and the hd/16 rows g·HD/16.., all in registers.
//    Every load of the call (its state rows as 16-byte float4, r, k, w, u
//    for its rows and v for its columns) is issued before the first is
//    used, so the call is one memory round trip; no shared memory, no
//    barrier: y's sum over rows is a shuffle tree over the 16 row groups,
//    and the new state is stored as float4.
//  * S == 0 or S >= 2 -> wkv6_kernel<HD, T, P>, the time loop. The columns
//    of a head's state evolve apart (S[:, j] needs v_t[j] and every row's
//    r, k, w, u), so, as in the step kernel, each head is cut into 8-column
//    slices, one block of 64 threads each: B·H·hd/8 blocks, 256 at
//    rwkv6-1.6b's (1,32,S,64), which fill the 132 SMs (one block per head
//    would leave three quarters of them idle). Thread (g, c) of the 32 x 2
//    owns columns 4c..4c+3 of the slice and the HD/32 rows g·HD/32.., all in
//    registers for the whole sequence; per step one shared read of each of
//    its rows' r, k, w (a vector of HD/32) and of its 4 columns' v feeds
//    4·HD/32 state elements, and u stays in registers. Each element's
//    update is one fmaf(st, w_i, k_i·v_j), the step kernel's, so s_n and
//    the checkpoints do not depend on the layout; y_j is summed over a
//    thread's rows by fmaf, then over the 32 row groups in order, once a
//    chunk, from per-step partials in shared memory (two barriers a
//    chunk). The chunk's r, k, w rows and the slice's v (kChunk steps: 16,
//    8 at hd 128) are staged a chunk ahead into a two-slot ring in shared
//    memory by 16-byte cp.async copies (r, k, v as stored: bf16 is upcast
//    where it is read), so the copies of chunk n+1 run while chunk n is
//    computed. The training entry stores its checkpoints
//    streaming (st.global.cs): only the backward reads them, much later,
//    and through L2 as usual they evict the r, k, w rows that a head's
//    slices share. S = 0 copies s0 to s_n.
//
// P is how memory is reached. kFull (hd equals the template width, every
// base and stride aligned to 4 elements, and for the time loop r, k and v
// to 16 bytes; the models' calls): the step loads 4 elements at a time with
// no mask, and the time loop stages by 16-byte cp.async.
// kElem (any other hd or view): element by element; the time loop's
// staging loads are unconditional (an element outside the call reads
// element (0, 0) and is stored as 0), so they issue together, and are
// stored into the same ring, so the two paths compute alike.
//
// Columns and rows past hd (hd below the template width) hold zeros and are
// never stored; any hd from 1 to 128.
//
// The training entry, wkv6_train_launch, runs the same kernels with the
// template flag CKPT set: they also write the state before every `every`-th
// step (at the start of a staged chunk; the step kernel writes s0) into
// ckpt, from which the backward (csrc/wkv6_bwd.cu) recomputes each chunk's
// states. y and s_n are the serving entry's bit for bit. CKPT is false in
// the serving instantiations, whose code is unchanged: the two fields the
// flag reads come last in Params.
//
// Bound on the H100: bytes, (2|4)·3·B·H·S·hd for r, k, v plus
// 4·(2·B·H·S·hd + 2·B·H·hd² + H·hd) for w, y, the state in and out and u,
// at 3.35 TB/s (and the checkpoints, 4·B·H·⌈S/16⌉·hd², for the training
// entry): at the engine's shape (1,32,1,64) with bf16 r, k, v about
// 0.32 µs, dominated by the state, far below the fixed cost of a launch; at
// the prefill shape (1,32,2048,64) bytes (25 µs in fp32) and the
// 6·B·H·S·hd² fp32 operations (24 µs at 67 TFLOP/s) are close; at the
// training shape (1,32,4096,64, bf16 r/k/v) bytes, 75 µs against 48. The
// time loop's cost past the bound: every block reads its head's r, k, w
// (8 slices: 8 times, from L2) and each step is a chain of dependent fmafs
// a thread; its times are in PERF.md. A chunked tensor-core formulation
// (repro/models/rwkv6.py::wkv_scan_chunked) is not written: its factorised
// decays need that function's clamps, and the CUDA cores' operations bound
// sits below the bytes bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxHd = 128;
constexpr int kSlice = 8;                // state columns per warp (step) or block (time loop)

struct Params {
  const void* r;                         // T
  const void* k;                         // T
  const void* v;                         // T
  const float* w;
  const float* u;
  const float* s0;
  float* y;
  float* sn;
  int H, S, hd;
  long long r_sb, r_sh, r_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long w_sb, w_sh, w_ss;
  long long y_sb, y_sh, y_ss;
  long long u_sh;
  long long s_sb, s_sh, s_si;
  // the training entry's (last, so that the fields above keep their
  // offsets and the serving instantiations their code): the state before
  // every `every`-th step, (B,H,ceil(S/every),hd,hd) contiguous
  float* ckpt;
  int every;
};

__device__ __forceinline__ float ld1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __uint_as_float(
      (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// How a kernel reaches memory: kFull, hd equals the template width and every
// base and stride is aligned to 4 elements (4 elements a load, no mask);
// kElem, element by element (any other hd or view).
enum Path { kFull, kElem };

// o[0..N) = p[0..N) upcast to fp32; on kElem, elements at or past n read
// as 0 (n is not looked at on kFull). N = 4, 2 or 1 elements: one 16-, 8- or 4-byte load
// in fp32, half that in bf16.
template <int N, Path P>
__device__ __forceinline__ void loadn(const float* p, int n, float* o) {
  if (P == kElem) {
#pragma unroll
    for (int e = 0; e < N; ++e) o[e] = e < n ? ld1(p + e) : 0.f;
  } else if (N == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
  } else if (N == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    o[0] = q.x; o[1] = q.y;
  } else {
    o[0] = __ldg(p);
  }
}

template <int N, Path P>
__device__ __forceinline__ void loadn(const __nv_bfloat16* p, int n, float* o) {
  if (P == kElem) {
#pragma unroll
    for (int e = 0; e < N; ++e) o[e] = e < n ? ld1(p + e) : 0.f;
  } else if (N == 4) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    o[0] = __uint_as_float(q.x << 16);
    o[1] = __uint_as_float(q.x & 0xffff0000u);
    o[2] = __uint_as_float(q.y << 16);
    o[3] = __uint_as_float(q.y & 0xffff0000u);
  } else if (N == 2) {
    const unsigned q = __ldg(reinterpret_cast<const unsigned*>(p));
    o[0] = __uint_as_float(q << 16);
    o[1] = __uint_as_float(q & 0xffff0000u);
  } else {
    o[0] = ld1(p);
  }
}

// p[0..4) = o[0..4); on kElem, elements at or past n are not stored (n is
// not looked at on kFull, one 16-byte store). STREAM: stores that bypass
// the caches' keep (st.global.cs), for what no later kernel reads soon.
template <Path P, bool STREAM = false>
__device__ __forceinline__ void store4(float* p, int n, const float* o) {
  if (P == kElem) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e < n) {
        if constexpr (STREAM) __stcs(p + e, o[e]);
        else p[e] = o[e];
      }
    }
  } else if constexpr (STREAM) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(o[0], o[1], o[2], o[3]));
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  }
}

template <int HD, typename T, Path P, bool CKPT>
__global__ void __launch_bounds__(32) wkv6_step_kernel(const Params p) {
  constexpr int kRpt = HD / 16;                   // state rows per lane
  constexpr int kRv = kRpt < 4 ? kRpt : 4;        // elements per row-vector load
  const int lane = threadIdx.x;
  const int c = lane & 1, g = lane >> 1;          // column group, row group
  const int hd = P == kFull ? HD : p.hd;
  const int nslice = (hd + kSlice - 1) / kSlice;
  const int bh = blockIdx.x / nslice;
  const int b = bh / p.H, h = bh % p.H;
  const int j0 = (blockIdx.x % nslice) * kSlice + c * 4;   // first of 4 columns
  const int i0 = g * kRpt;                                  // first of kRpt rows
  const T* r = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* w = p.w + b * p.w_sb + h * p.w_sh;
  const float* u = p.u + h * p.u_sh;
  const float* s0 = p.s0 + b * p.s_sb + h * p.s_sh;

  // every load of the call, before any is used
  float rr[kRpt], kk[kRpt], ww[kRpt], uu[kRpt], vv[4], st[kRpt][4];
#pragma unroll
  for (int a = 0; a < kRpt; a += kRv) {
    const int n = hd - (i0 + a);
    loadn<kRv, P>(r + i0 + a, n, rr + a);
    loadn<kRv, P>(k + i0 + a, n, kk + a);
    loadn<kRv, P>(w + i0 + a, n, ww + a);
    loadn<kRv, P>(u + i0 + a, n, uu + a);
  }
  loadn<4, P>(v + j0, hd - j0, vv);
#pragma unroll
  for (int a = 0; a < kRpt; ++a) {
    const int i = i0 + a;
    loadn<4, P>(s0 + i * p.s_si + j0, i < hd ? hd - j0 : 0, st[a]);
  }

  if constexpr (CKPT) {             // the state before the one step: s0
    float* ck = p.ckpt + ((long long)b * p.H + h) * hd * hd;
#pragma unroll
    for (int a = 0; a < kRpt; ++a) {
      const int i = i0 + a;
      if (P == kFull || i < hd) store4<P>(ck + i * hd + j0, hd - j0, st[a]);
    }
  }

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int a = 0; a < kRpt; ++a) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float kv = kk[a] * vv[e];
      acc[e] = fmaf(rr[a], fmaf(uu[a], kv, st[a][e]), acc[e]);
      st[a][e] = fmaf(st[a][e], ww[a], kv);
    }
  }
  // y_j: the sum over the 16 row groups (lane bits 1-4)
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int off = 2; off < 32; off <<= 1)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  }
  if (g == 0) store4<P>(p.y + b * p.y_sb + h * p.y_sh + j0, hd - j0, acc);

  float* sn = p.sn + ((long long)b * p.H + h) * hd * hd;
#pragma unroll
  for (int a = 0; a < kRpt; ++a) {
    const int i = i0 + a;
    if (P == kFull || i < hd) store4<P>(sn + i * hd + j0, hd - j0, st[a]);
  }
}

// The time loop's layout: blocks of 64 threads, kRowGroups x 2, on one
// kSlice-column slice of a head; thread (g, c) owns kRows = HD / kRowGroups
// rows and 4 columns. Steps are staged kChunk at a time.
constexpr int kLoopThreads = 64;
constexpr int kRowGroups = 32;
// a step's y partials, padded so that the sum's 8-byte reads meet no bank twice
constexpr int kPart = kRowGroups * kSlice + 8;

template <int HD>
constexpr int kLoopChunk = HD >= 128 ? 8 : 16;   // time steps per staging

// r, k, v as stored: fp32, or bf16's 16 bits (upcast where they are read)
template <typename T>
using Raw = std::conditional_t<sizeof(T) == 2, unsigned short, float>;

// One slot of the staging ring: kChunk steps of r, k, w rows and of the
// slice's v.
template <int HD, typename U>
struct __align__(16) Stage {
  static constexpr int kChunk = kLoopChunk<HD>;
  U r[kChunk][HD];
  U k[kChunk][HD];
  float w[kChunk][HD];
  U v[kChunk][kSlice];
};

// Shared-memory reads of N adjacent elements upcast to fp32 (N = 4, 2, 1: one
// vector load).
template <int N>
__device__ __forceinline__ void lds(const float* p, float* o) {
  if constexpr (N == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
  } else if constexpr (N == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    o[0] = q.x; o[1] = q.y;
  } else {
    o[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void lds(const unsigned short* p, float* o) {
  if constexpr (N == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    o[0] = __uint_as_float(q.x << 16);
    o[1] = __uint_as_float(q.x & 0xffff0000u);
    o[2] = __uint_as_float(q.y << 16);
    o[3] = __uint_as_float(q.y & 0xffff0000u);
  } else if constexpr (N == 2) {
    const unsigned q = *reinterpret_cast<const unsigned*>(p);
    o[0] = __uint_as_float(q << 16);
    o[1] = __uint_as_float(q & 0xffff0000u);
  } else {
    o[0] = __uint_as_float((unsigned)*p << 16);
  }
}

// An asynchronous 16-byte copy from device memory into shared memory, past
// L1 (.cg); the group commits and waits below.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename U>
__device__ __forceinline__ U zero_unless(U x, bool in) { return in ? x : U(0); }

// Stage steps t0 .. t0 + n of r, k, w and of v's columns j0 .. j0 + kSlice
// into slot `st`. kFull: 16-byte cp.async copies (4 elements of fp32, 8 of
// bf16), issued and left in flight (the caller commits them). kElem: element by element, every load
// unconditional (an element outside the call reads element (0, 0), there
// when S > 0, and is stored as 0), zeros past hd and past step n.
template <int HD, typename U, Path P>
__device__ __forceinline__ void stage_chunk(Stage<HD, U>& st, const U* r, const U* k,
                                            const U* v, const float* w, const Params& p,
                                            int t0, int n, int j0, int hd) {
  constexpr int kChunk = Stage<HD, U>::kChunk;
  const int tid = threadIdx.x;
  if constexpr (P == kFull) {
    constexpr int E = 16 / sizeof(U), Q = HD / E;  // r, k, v elements a copy; copies a row
    for (int e = tid; e < n * Q; e += kLoopThreads) {
      const int c = e / Q, d = e % Q * E;
      const long long t = t0 + c;
      cp_async16(&st.r[c][d], r + t * p.r_ss + d);
      cp_async16(&st.k[c][d], k + t * p.k_ss + d);
    }
    for (int e = tid; e < n * (HD / 4); e += kLoopThreads) {
      const int c = e / (HD / 4), d = e % (HD / 4) * 4;
      cp_async16(&st.w[c][d], w + (long long)(t0 + c) * p.w_ss + d);
    }
    if (tid < n * (kSlice / E)) {
      const int c = tid / (kSlice / E), d = tid % (kSlice / E) * E;
      cp_async16(&st.v[c][d], v + (long long)(t0 + c) * p.v_ss + j0 + d);
    }
  } else {
    for (int e = tid; e < kChunk * HD; e += kLoopThreads) {
      const int c = e / HD, d = e % HD;
      const bool in = c < n && d < hd;
      const long long t = in ? t0 + c : 0;
      const int dd = in ? d : 0;
      const U rv = r[t * p.r_ss + dd], kv = k[t * p.k_ss + dd];
      const float wv = w[t * p.w_ss + dd];
      st.r[c][d] = zero_unless(rv, in);
      st.k[c][d] = zero_unless(kv, in);
      st.w[c][d] = zero_unless(wv, in);
    }
    for (int e = tid; e < kChunk * kSlice; e += kLoopThreads) {
      const int c = e / kSlice, j = j0 + e % kSlice;
      const bool in = c < n && j < hd;
      const U vv = v[(in ? t0 + c : 0) * p.v_ss + (in ? j : 0)];
      st.v[c][e % kSlice] = zero_unless(vv, in);
    }
  }
}

template <int HD, typename T, Path P, bool CKPT>
__global__ void __launch_bounds__(kLoopThreads) wkv6_kernel(const Params p) {
  constexpr int kRows = HD / kRowGroups;          // state rows per thread
  constexpr int kChunk = kLoopChunk<HD>;
  constexpr int kOut = kChunk * kSlice / kLoopThreads;   // y columns a thread sums
  using U = Raw<T>;
  __shared__ Stage<HD, U> ring[2];
  __shared__ __align__(16) float part[kChunk][kPart];

  const int tid = threadIdx.x;
  const int c4 = tid & 1, g = tid >> 1;           // column group, row group
  const int hd = P == kFull ? HD : p.hd, S = p.S;
  const int nslice = (hd + kSlice - 1) / kSlice;
  const int bh = blockIdx.x / nslice;
  const int b = bh / p.H, h = bh % p.H;
  const int j0 = (blockIdx.x % nslice) * kSlice;   // the block's first column
  const int jt = j0 + c4 * 4;                      // the thread's first of 4
  const int i0 = g * kRows;                        // its first of kRows rows
  const U* r = static_cast<const U*>(p.r) + b * p.r_sb + h * p.r_sh;
  const U* k = static_cast<const U*>(p.k) + b * p.k_sb + h * p.k_sh;
  const U* v = static_cast<const U*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* w = p.w + b * p.w_sb + h * p.w_sh;
  float* y = p.y + b * p.y_sb + h * p.y_sh;
  const float* s0 = p.s0 + b * p.s_sb + h * p.s_sh;

  float st[kRows][4], uu[kRows];
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int i = i0 + a;
    uu[a] = i < hd ? p.u[h * p.u_sh + i] : 0.f;
    loadn<4, P>(s0 + (i < hd ? i : 0) * p.s_si + jt, i < hd ? hd - jt : 0, st[a]);
  }

  const int nchunk = (S + kChunk - 1) / kChunk;
  if constexpr (P == kFull) {
    if (S > 0) {
      stage_chunk<HD, U, P>(ring[0], r, k, v, w, p, 0, min(kChunk, S), j0, hd);
      cp_async_commit();
    }
  }
  for (int q = 0; q < nchunk; ++q) {
    const int t0 = q * kChunk, n = min(kChunk, S - t0);
    Stage<HD, U>& cur = ring[q & 1];
    if constexpr (CKPT) {            // S_{t0}, at every `every`-th step (a multiple of kChunk)
      if (t0 % p.every == 0) {
        const long long nck = (S + p.every - 1) / p.every;
        float* ck = p.ckpt + (((long long)b * p.H + h) * nck + t0 / p.every) * hd * hd;
#pragma unroll
        for (int a = 0; a < kRows; ++a) {
          const int i = i0 + a;
          if (P == kFull || i < hd) store4<P, true>(ck + i * hd + jt, hd - jt, st[a]);
        }
      }
    }
    if constexpr (P == kFull) {      // the next chunk's copies, in flight under this one
      if (q + 1 < nchunk) {
        stage_chunk<HD, U, P>(ring[(q + 1) & 1], r, k, v, w, p, t0 + kChunk,
                              min(kChunk, S - t0 - kChunk), j0, hd);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      stage_chunk<HD, U, P>(cur, r, k, v, w, p, t0, n, j0, hd);
    }
    __syncthreads();                 // the chunk is staged; part is free
#pragma unroll 4
    for (int c = 0; c < n; ++c) {    // one step: kRows x 4 state elements, a partial of y
      float rr[kRows], kk[kRows], ww[kRows], vv[4];
      lds<kRows>(&cur.r[c][i0], rr);
      lds<kRows>(&cur.k[c][i0], kk);
      lds<kRows>(&cur.w[c][i0], ww);
      lds<4>(&cur.v[c][c4 * 4], vv);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float kv = kk[a] * vv[e];
          acc[e] = fmaf(rr[a], fmaf(uu[a], kv, st[a][e]), acc[e]);
          st[a][e] = fmaf(st[a][e], ww[a], kv);
        }
      }
      *reinterpret_cast<float4*>(&part[c][g * kSlice + c4 * 4]) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();                 // part is complete; the slot is free
    {                                // y: kOut columns of one step a thread
      const int c = tid / (kSlice / kOut), col = tid % (kSlice / kOut) * kOut;
      if (c < n) {
        float sum[kOut];
#pragma unroll
        for (int o = 0; o < kOut; ++o) sum[o] = 0.f;
#pragma unroll 8
        for (int gg = 0; gg < kRowGroups; ++gg) {   // the row groups' partials, in order
          float x[kOut];
          lds<kOut>(&part[c][gg * kSlice + col], x);
#pragma unroll
          for (int o = 0; o < kOut; ++o) sum[o] += x[o];
        }
#pragma unroll
        for (int o = 0; o < kOut; ++o)
          if (P == kFull || j0 + col + o < hd)
            y[(long long)(t0 + c) * p.y_ss + j0 + col + o] = sum[o];
      }
    }
  }

  float* sn = p.sn + ((long long)b * p.H + h) * hd * hd;
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int i = i0 + a;
    if (P == kFull || i < hd) store4<P>(sn + i * hd + jt, hd - jt, st[a]);
  }
}

// Whether a kernel may load and store 4 elements at a time (kFull, with hd
// the template width): every base and stride it reads or writes aligned to
// 4 elements.
bool vec4(const Params& p, int elem_rkv) {
  auto ok = [](const void* q, int elem) {
    return reinterpret_cast<uintptr_t>(q) % (4u * elem) == 0;
  };
  const long long strides[] = {p.r_sb, p.r_sh, p.r_ss, p.k_sb, p.k_sh, p.k_ss,
                               p.v_sb, p.v_sh, p.v_ss, p.w_sb, p.w_sh, p.w_ss,
                               p.y_sb, p.y_sh, p.u_sh, p.s_sb, p.s_sh, p.s_si};
  for (long long s : strides)
    if (s % 4 != 0) return false;
  return ok(p.r, elem_rkv) && ok(p.k, elem_rkv) && ok(p.v, elem_rkv) &&
         ok(p.w, 4) && ok(p.u, 4) && ok(p.s0, 4) && ok(p.y, 4) && ok(p.sn, 4);
}

template <int HD, typename T, Path P, bool CKPT>
void launch(const Params& p, int B, cudaStream_t st) {
  if (p.S == 1) {
    const dim3 grid((unsigned)B * (unsigned)p.H * (unsigned)((p.hd + kSlice - 1) / kSlice));
    wkv6_step_kernel<HD, T, P, CKPT><<<grid, 32, 0, st>>>(p);
  } else {
    const dim3 grid((unsigned)B * (unsigned)p.H * (unsigned)((p.hd + kSlice - 1) / kSlice));
    wkv6_kernel<HD, T, P, CKPT><<<grid, kLoopThreads, 0, st>>>(p);
  }
}

// Whether r, k and v may be copied 16 bytes at a time (the time loop's kFull):
// their bases and strides aligned to 16 bytes.
bool rkv16(const Params& p, int elem_rkv) {
  const long long e = 16 / elem_rkv;
  const long long strides[] = {p.r_sb, p.r_sh, p.r_ss, p.k_sb, p.k_sh, p.k_ss,
                               p.v_sb, p.v_sh, p.v_ss};
  for (long long s : strides)
    if (s % e != 0) return false;
  const void* bases[] = {p.r, p.k, p.v};
  for (const void* q : bases)
    if (reinterpret_cast<uintptr_t>(q) % 16 != 0) return false;
  return true;
}

template <int HD, typename T, bool CKPT>
void launch(const Params& p, int B, cudaStream_t st) {
  if (p.hd == HD && vec4(p, (int)sizeof(T)) && (p.S == 1 || rkv16(p, (int)sizeof(T))))
    launch<HD, T, kFull, CKPT>(p, B, st);
  else
    launch<HD, T, kElem, CKPT>(p, B, st);
}

template <typename T, bool CKPT>
void launch_hd(const Params& p, int B, cudaStream_t st) {
  if (p.hd <= 32)
    launch<32, T, CKPT>(p, B, st);
  else if (p.hd <= 64)
    launch<64, T, CKPT>(p, B, st);
  else
    launch<128, T, CKPT>(p, B, st);
}

// The fields both entries fill; false when the sizes are out of range.
bool fill(Params& p, const void* r, const void* k, const void* v, const float* w,
          const float* u, const float* s0, float* y, float* sn, int B, int H, int S, int hd,
          const long long* strides) {
  if (B <= 0 || H <= 0 || S < 0 || hd <= 0 || hd > kMaxHd) return false;
  p.r = r; p.k = k; p.v = v; p.w = w; p.u = u; p.s0 = s0; p.y = y; p.sn = sn;
  p.H = H; p.S = S; p.hd = hd;
  long long* f[] = {&p.r_sb, &p.r_sh, &p.r_ss, &p.k_sb, &p.k_sh, &p.k_ss,
                    &p.v_sb, &p.v_sh, &p.v_ss, &p.w_sb, &p.w_sh, &p.w_ss,
                    &p.y_sb, &p.y_sh, &p.y_ss, &p.u_sh, &p.s_sb, &p.s_sh, &p.s_si};
  for (int q = 0; q < 19; ++q) *f[q] = strides[q];
  p.ckpt = nullptr;
  p.every = 0;
  return true;
}

}  // namespace

extern "C" {

// The forward's plan at (B, H, S, hd): returns the device kernels one call of
// wkv6_launch or wkv6_train_launch launches (one: wkv6_step_kernel at S = 1,
// wkv6_kernel otherwise) and writes to *scratch_floats the fp32 scratch the
// call takes (none); -1 for a shape the launches refuse (a size out of
// range, hd outside 1..kMaxHd).
int wkv6_fwd_plan(int B, int H, int S, int hd, long long* scratch_floats) {
  if (B <= 0 || H <= 0 || S < 0 || hd <= 0 || hd > kMaxHd) return -1;
  *scratch_floats = 0;
  return 1;
}

// r, k, v (bf16 if rkv_bf16, else fp32), w, y: strides of (batch, head,
// step); u: of head; s0: of (batch, head, row); the last dimension of each
// is contiguous. s_n is contiguous (B,H,hd,hd). Returns a cudaError_t
// (0 = launched; cudaErrorInvalidValue for hd outside 1..kMaxHd or a
// negative size).
int wkv6_launch(const void* r, const void* k, const void* v, const float* w,
                const float* u, const float* s0, float* y, float* sn,
                int B, int H, int S, int hd, int rkv_bf16,
                long long r_sb, long long r_sh, long long r_ss,
                long long k_sb, long long k_sh, long long k_ss,
                long long v_sb, long long v_sh, long long v_ss,
                long long w_sb, long long w_sh, long long w_ss,
                long long y_sb, long long y_sh, long long y_ss,
                long long u_sh, long long s_sb, long long s_sh, long long s_si,
                void* stream) {
  const long long strides[] = {r_sb, r_sh, r_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                               w_sb, w_sh, w_ss, y_sb, y_sh, y_ss, u_sh, s_sb, s_sh, s_si};
  Params p;
  if (!fill(p, r, k, v, w, u, s0, y, sn, B, H, S, hd, strides))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rkv_bf16)
    launch_hd<__nv_bfloat16, false>(p, B, st);
  else
    launch_hd<float, false>(p, B, st);
  return (int)cudaGetLastError();
}

// The training entry: wkv6_launch's y and s_n, bit for bit (the same
// kernels, the same arithmetic), and ckpt (B,H,ceil(S/every),hd,hd)
// contiguous, the state before steps 0, every, 2·every, ... for the
// backward (csrc/wkv6_bwd.cu). `every` must be a positive multiple of 16,
// the time loop's staging (cudaErrorInvalidValue otherwise).
int wkv6_train_launch(const void* r, const void* k, const void* v, const float* w,
                      const float* u, const float* s0, float* y, float* sn, float* ckpt,
                      int every, int B, int H, int S, int hd, int rkv_bf16,
                      long long r_sb, long long r_sh, long long r_ss,
                      long long k_sb, long long k_sh, long long k_ss,
                      long long v_sb, long long v_sh, long long v_ss,
                      long long w_sb, long long w_sh, long long w_ss,
                      long long y_sb, long long y_sh, long long y_ss,
                      long long u_sh, long long s_sb, long long s_sh, long long s_si,
                      void* stream) {
  const long long strides[] = {r_sb, r_sh, r_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                               w_sb, w_sh, w_ss, y_sb, y_sh, y_ss, u_sh, s_sb, s_sh, s_si};
  Params p;
  if (every <= 0 || every % 16 != 0 ||
      !fill(p, r, k, v, w, u, s0, y, sn, B, H, S, hd, strides))
    return (int)cudaErrorInvalidValue;
  p.ckpt = ckpt;
  p.every = every;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rkv_bf16)
    launch_hd<__nv_bfloat16, true>(p, B, st);
  else
    launch_hd<float, true>(p, B, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
