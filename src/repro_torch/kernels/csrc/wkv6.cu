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
//  * S == 0 or S >= 2 -> wkv6_kernel<HD, T, P>: one block per (b, h), the
//    time loop inside the block. Thread (j, g) owns column j of the state and
//    the kRows rows g*kRows .. of it, in registers, so the state never leaves
//    the chip between steps. Time steps are staged kChunk at a time in shared
//    memory (r_t, k_t, v_t, w_t), so a chunk costs two barriers, not two per
//    step. Each thread adds its rows' share of y_t[j] to a shared partial;
//    after the chunk the kGroups partials of each column are summed and
//    written. S = 0 copies s0 to s_n.
//
// P is how memory is reached. kFull (hd equals the template width, every
// base and stride aligned to 4 elements; the models' calls): the step loads
// 4 elements at a time with no mask, and the time loop stages 4 adjacent
// elements of r, k, v and w per thread, loaded one chunk ahead into
// registers, so the loads of chunk n+1 are in flight while chunk n is
// computed (with bf16 r, k, v an 8-byte load). kElem (any other hd or
// view): element by element; the time loop's staging loads are
// unconditional (an element outside the call reads element (0, 0) and is
// stored as 0), so they issue together.
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
// at 3.35 TB/s: at the engine's shape (1,32,1,64) with bf16 r, k, v about
// 0.32 µs, dominated by the state, far below the fixed cost of a launch; at
// the prefill shape (1,32,2048,64) bytes (25 µs in fp32) and the
// 6·B·H·S·hd² fp32 operations (24 µs at 67 TFLOP/s) are close. The time loop
// sits far above both at long S: B·H = 32 blocks for 132 SMs, each carrying
// an S-step dependent chain. A chunked tensor-core formulation
// (repro/models/rwkv6.py::wkv_scan_chunked) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroups = 4;               // row groups sharing one column (time loop)
constexpr int kMaxHd = 128;
constexpr int kSlice = 8;                // state columns per warp (step)

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
// not looked at on kFull, one 16-byte store).
template <Path P>
__device__ __forceinline__ void store4(float* p, int n, const float* o) {
  if (P == kElem) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) p[e] = o[e];
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

// plain loads (not the read-only path, which was slower in this loop)
__device__ __forceinline__ float ldp(const float* p) { return *p; }
__device__ __forceinline__ float ldp(const __nv_bfloat16* p) {
  return __uint_as_float((unsigned)*reinterpret_cast<const unsigned short*>(p) << 16);
}

// The time loop's kFull staging: thread tid < kChunk·HD/4 takes 4 adjacent
// elements (step t0 + tid / (HD/4), columns 4·(tid % (HD/4))..) of r, k, v
// and w, upcast into o; a thread past the chunk or a step at or past S
// loads element (0, 0) (there when S > 0) and keeps zeros.
template <int HD, int kChunk, typename T>
__device__ __forceinline__ void fetch4(const T* r, const T* k, const T* v, const float* w,
                                       const Params& p, int t0, float (&o)[4][4]) {
  const int tid = threadIdx.x, c = tid / (HD / 4), d = tid % (HD / 4) * 4;
  const bool in = tid < kChunk * HD / 4 && c < p.S - t0;
  const long long t = in ? t0 + c : 0;
  const int dd = in ? d : 0;
  loadn<4, kFull>(r + t * p.r_ss + dd, 4, o[0]);
  loadn<4, kFull>(k + t * p.k_ss + dd, 4, o[1]);
  loadn<4, kFull>(v + t * p.v_ss + dd, 4, o[2]);
  loadn<4, kFull>(w + t * p.w_ss + dd, 4, o[3]);
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[q][e] = in ? o[q][e] : 0.f;
}

template <int HD, typename T, Path P, bool CKPT>
__global__ void __launch_bounds__(HD * kGroups) wkv6_kernel(Params p) {
  constexpr int kThreads = HD * kGroups;
  constexpr int kRows = HD / kGroups;             // state rows per thread
  constexpr int kChunk = HD >= 128 ? 8 : 16;      // time steps per staging
  __shared__ __align__(16) float Rs[kChunk][HD], Ks[kChunk][HD], Vs[kChunk][HD],
      Ws[kChunk][HD];
  __shared__ float Part[kChunk][kGroups][HD];

  const int tid = threadIdx.x;
  const int j = tid % HD, g = tid / HD;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int hd = P == kFull ? HD : p.hd, S = p.S;
  const T* r = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* w = p.w + b * p.w_sb + h * p.w_sh;
  float* y = p.y + b * p.y_sb + h * p.y_sh;
  const float* s0 = p.s0 + b * p.s_sb + h * p.s_sh;

  float st[kRows], ur[kRows];
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int i = g * kRows + a;
    st[a] = (i < hd && j < hd) ? s0[i * p.s_si + j] : 0.f;
    ur[a] = i < hd ? p.u[h * p.u_sh + i] : 0.f;
  }

  float pre[4][4];                   // kFull: the next chunk's r, k, v, w
  if constexpr (P == kFull)
    if (S > 0) fetch4<HD, kChunk>(r, k, v, w, p, 0, pre);

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
    if constexpr (CKPT) {            // S_{t0}, at every `every`-th step (a multiple of kChunk)
      if (t0 % p.every == 0) {
        const long long nck = (S + p.every - 1) / p.every;
        float* ck = p.ckpt + (((long long)b * p.H + h) * nck + t0 / p.every) * hd * hd;
#pragma unroll
        for (int a = 0; a < kRows; ++a) {
          const int i = g * kRows + a;
          if (i < hd && j < hd) ck[i * hd + j] = st[a];
        }
      }
    }
    if constexpr (P == kFull) {
      if (tid < kChunk * HD / 4) {
        const int c = tid / (HD / 4), d = tid % (HD / 4) * 4;
        float* rows[4] = {&Rs[c][d], &Ks[c][d], &Vs[c][d], &Ws[c][d]};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          *reinterpret_cast<float4*>(rows[q]) =
              make_float4(pre[q][0], pre[q][1], pre[q][2], pre[q][3]);
      }
    } else {
      // every element loads, from element (0, 0) where it lies outside, so
      // no load waits on a branch and all of them issue together
#pragma unroll
      for (int e = tid; e < kChunk * HD; e += kThreads) {
        const int c = e / HD, d = e % HD;
        const bool in = c < n && d < hd;
        const long long t = in ? t0 + c : 0;
        const int dd = in ? d : 0;
        const float rv = ldp(r + t * p.r_ss + dd), kv = ldp(k + t * p.k_ss + dd),
                    vv = ldp(v + t * p.v_ss + dd), wv = w[t * p.w_ss + dd];
        Rs[c][d] = in ? rv : 0.f;
        Ks[c][d] = in ? kv : 0.f;
        Vs[c][d] = in ? vv : 0.f;
        Ws[c][d] = in ? wv : 0.f;
      }
    }
    __syncthreads();                 // the chunk is staged; Part is free
    if constexpr (P == kFull)        // in flight while this chunk is computed
      if (t0 + kChunk < S) fetch4<HD, kChunk>(r, k, v, w, p, t0 + kChunk, pre);
    for (int c = 0; c < n; ++c) {
      const float vj = Vs[c][j];
      float acc = 0.f;
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        const int i = g * kRows + a;
        const float kv = Ks[c][i] * vj;
        acc = fmaf(Rs[c][i], fmaf(ur[a], kv, st[a]), acc);
        st[a] = fmaf(st[a], Ws[c][i], kv);
      }
      Part[c][g][j] = acc;
    }
    __syncthreads();                 // Part is complete; the stage is free
    for (int e = tid; e < n * HD; e += kThreads) {
      const int c = e / HD, d = e % HD;
      if (d < hd) {
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < kGroups; ++q) sum += Part[c][q][d];
        y[(t0 + c) * p.y_ss + d] = sum;
      }
    }
  }

  float* sn = p.sn + ((long long)b * p.H + h) * hd * hd;
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int i = g * kRows + a;
    if (i < hd && j < hd) sn[i * hd + j] = st[a];
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
    wkv6_kernel<HD, T, P, CKPT><<<(unsigned)B * (unsigned)p.H, HD * kGroups, 0, st>>>(p);
  }
}

template <int HD, typename T, bool CKPT>
void launch(const Params& p, int B, cudaStream_t st) {
  if (p.hd == HD && vec4(p, (int)sizeof(T)))
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
