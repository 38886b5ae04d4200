// Prefix-aware GQA flash attention for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel): online-softmax attention with queries at
// absolute positions q_offset + i (cached-prefix prefill), causal masking, an
// optional sliding window and GQA without a materialised K/V repeat.
//
//   q (B,H,Sq,hd), k/v (B,KV,Sk,hd), out (B,H,Sq,hd); H % KV == 0.
//   Every tensor comes by strides; the head dimension must be contiguous.
//   Inputs fp32 or bf16, all arithmetic in fp32.
//
// Layout: one block per (q-tile, kv_head, batch). The block packs the G = H/KV
// query heads that share the kv head into kRows = 64 rows (G*bq with
// bq = 64/G, head-major r = g*bq + i, as the Pallas kernel packs them), so each
// K/V tile is read from device memory once per group. Key tiles of kBK = 64
// are staged in shared memory as fp32; the fp32 running max, sum and
// accumulator stay in registers. Each warp owns 8 rows, so the row-wise
// softmax reductions are warp shuffles; lane l owns keys l and l+32 of a
// tile and output columns l, l+32, ... of its rows.
//
// Differences from the Pallas kernel, all forced by the GPU or the engine:
//  * ragged tails (Sq, Sk not multiples of any tile) are masked in-kernel —
//    the engine prefills suffixes of any length;
//  * hd up to 256, any width (not only powers of two);
//  * key tiles wholly outside the causal/window band of the block are skipped
//    (the Pallas grid visits all of them). That is exact only while every row
//    of the block sees a key. A row whose band is empty (causal with a window,
//    at position q_offset + i >= Sk + window - 1) scores -1e30 on every key,
//    so the reference gives it the mean of V over all Sk keys. A block
//    that holds such a row therefore visits every tile: its empty rows
//    average all keys, and its other rows, whose masked keys weigh
//    e^(-1e30 - m) = 0 once a visible key is seen, are unchanged.
//
// Bound on the H100: at the main path's shapes (Sq=512 against Sk=2560,
// G=8, hd=128) the arithmetic intensity is far above the memory roofline, so
// the kernel is bound by operations; this first version uses fp32 FMA on the
// CUDA cores (no tensor cores), fed from shared memory. wgmma and TMA are
// later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;                      // packed query rows per block
constexpr int kRowsPerWarp = kRows / kWarps;   // 8
constexpr int kBK = 64;                        // keys per tile (2 per lane)
constexpr float kNegInf = -1e30f;              // the reference's mask value

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int KV, G, Sq, Sk, hd, bq;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int q_offset, causal, has_window, window;
  float scale;
};

size_t smem_bytes(int hd) {
  const int kst = hd | 1;
  return sizeof(float) * (size_t)(kRows * hd + kBK * kst + kBK * hd + kRows * kBK);
}

// NJ = number of 32-wide column groups a lane holds (hd <= 32 * NJ).
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads) flash_kernel(const Params p) {
  extern __shared__ float smem[];
  const int hd = p.hd;
  const int kst = hd | 1;                 // odd stride: column reads hit 32 banks
  float* Qs = smem;                       // kRows x hd
  float* Ks = Qs + kRows * hd;            // kBK x kst
  float* Vs = Ks + kBK * kst;             // kBK x hd
  float* Ps = Vs + kBK * hd;              // kRows x kBK (each warp its own rows)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * p.bq, kvh = blockIdx.y, b = blockIdx.z;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  T* o = static_cast<T*>(p.o);

  for (int idx = tid; idx < kRows * hd; idx += kThreads) {
    const int r = idx / hd, d = idx - r * hd;
    const int g = r / p.bq, i = r - g * p.bq;
    float x = 0.f;
    if (g < p.G && q0 + i < p.Sq)
      x = to_f(q[b * p.q_sb + (long long)(kvh * p.G + g) * p.q_sh +
                 (long long)(q0 + i) * p.q_ss + d]);
    Qs[idx] = x;
  }

  int qpos[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    qpos[i] = p.q_offset + q0 + (r - (r / p.bq) * p.bq);
  }

  // Key range the block's rows can see, unless one of its rows sees none.
  int empty = 0;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    const int g = r / p.bq;
    if (g < p.G && q0 + (r - g * p.bq) < p.Sq) {
      const int lo = p.has_window ? max(0, qpos[i] - p.window + 1) : 0;
      const int hi = p.causal ? min(p.Sk - 1, qpos[i]) : p.Sk - 1;
      empty |= lo > hi;
    }
  }
  int kstart = 0, kend = p.Sk;
  if (!__syncthreads_or(empty)) {
    const int qmin = p.q_offset + q0;
    const int qmax = p.q_offset + min(q0 + p.bq, p.Sq) - 1;
    if (p.causal) kend = min(p.Sk, qmax + 1);
    if (p.has_window) kstart = max(0, qmin - p.window + 1);
  }

  float acc[kRowsPerWarp][NJ];
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = (kstart / kBK) * kBK; kt < kend; kt += kBK) {
    __syncthreads();   // Qs staged / previous tile's Vs reads done
    for (int idx = tid; idx < kBK * hd; idx += kThreads) {
      const int c = idx / hd, d = idx - c * hd;
      float kx = 0.f, vx = 0.f;
      if (kt + c < p.Sk) {
        kx = to_f(k[(long long)(kt + c) * p.k_ss + d]);
        vx = to_f(v[(long long)(kt + c) * p.v_ss + d]);
      }
      Ks[c * kst + d] = kx;
      Vs[c * hd + d] = vx;
    }
    __syncthreads();

    float s[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i][0] = s[i][1] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float k0 = Ks[lane * kst + d], k1 = Ks[(lane + 32) * kst + d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float qv = Qs[(warp + kWarps * i) * hd + d];
        s[i][0] = fmaf(qv, k0, s[i][0]);
        s[i][1] = fmaf(qv, k1, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int c = kt + lane + 32 * jj;
        float x;
        if (c >= p.Sk)
          x = -INFINITY;   // ragged tail: not a key at all
        else if ((p.causal && c > qpos[i]) ||
                 (p.has_window && c <= qpos[i] - p.window))
          x = kNegInf;
        else
          x = s[i][jj] * p.scale;
        s[i][jj] = x;
      }
      const float m_new = fmaxf(m[i], warp_max(fmaxf(s[i][0], s[i][1])));
      const float alpha = expf(m[i] - m_new);
      const float p0 = expf(s[i][0] - m_new), p1 = expf(s[i][1] - m_new);
      l[i] = l[i] * alpha + warp_sum(p0 + p1);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
      float* prow = Ps + (warp + kWarps * i) * kBK;
      prow[lane] = p0;
      prow[lane + 32] = p1;
    }
    __syncwarp();

    const int nc = min(kBK, p.Sk - kt);
    for (int c = 0; c < nc; ++c) {
      float vv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = lane + 32 * j;
        vv[j] = d < hd ? Vs[c * hd + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pc = Ps[(warp + kWarps * i) * kBK + c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pc, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    const int g = r / p.bq, qi = r - g * p.bq;
    if (g < p.G && q0 + qi < p.Sq) {
      const float den = fmaxf(l[i], 1e-20f);
      T* orow = o + b * p.o_sb + (long long)(kvh * p.G + g) * p.o_sh +
                (long long)(q0 + qi) * p.o_ss;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = lane + 32 * j;
        if (d < hd) orow[d] = from_f<T>(acc[i][j] / den);
      }
    }
  }
}

template <typename T, int NJ>
cudaError_t launch_typed(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + p.bq - 1) / p.bq, p.KV, B);
  flash_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const Params& p, int B, cudaStream_t stream) {
  if (p.hd <= 64) return launch_typed<T, 2>(p, B, stream);
  if (p.hd <= 128) return launch_typed<T, 4>(p, B, stream);
  return launch_typed<T, 8>(p, B, stream);
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16. Returns a cudaError_t (0 = launched).
int flash_attention_launch(int dtype, const void* q, const void* k, const void* v,
                           void* o, int B, int H, int KV, int Sq, int Sk, int hd,
                           long long q_sb, long long q_sh, long long q_ss,
                           long long k_sb, long long k_sh, long long k_ss,
                           long long v_sb, long long v_sh, long long v_ss,
                           long long o_sb, long long o_sh, long long o_ss,
                           int q_offset, int causal, int has_window, int window,
                           void* stream) {
  if (KV <= 0 || H % KV != 0 || hd <= 0 || hd > 256 || H / KV > kRows || Sq <= 0 ||
      Sk <= 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.KV = KV; p.G = H / KV; p.Sq = Sq; p.Sk = Sk; p.hd = hd;
  p.bq = kRows / p.G;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.q_offset = q_offset; p.causal = causal;
  p.has_window = has_window; p.window = window;
  p.scale = (float)(1.0 / sqrt((double)hd));   // hd ** -0.5, as the reference
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_hd<float>(p, B, st);
    case 1: return (int)launch_hd<__nv_bfloat16>(p, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
