// Single-token GQA decode attention over a ring KV cache, for Hopper
// (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention / _decode_kernel): one query token per sequence, a masked
// online softmax over the cache slots, the slot mask given as valid (W,) int32
// (it encodes causality, ring wrap-around and the sliding window).
//
//   q (B,H,hd), k/v cache (B,KV,W,hd), valid (W,) int32, out (B,H,hd).
//   q and the caches come by strides (head dimension contiguous), so the
//   model's (B,W,KV,hd) ring buffer is read in place through a permuted view.
//   Inputs fp32 or bf16, all arithmetic in fp32.
//
// Two passes (flash-decoding). The Pallas kernel walks W sequentially inside
// one grid row per (batch, kv_head); on the H100 that is B*KV blocks, 4 of 132
// SMs at batch 1 for yi-6b. Here W is split into nsplit chunks:
//
//  1. decode_partial_kernel, one block per (chunk, kv_head, batch): walks its
//     chunk in key tiles of kBK = 64 slots staged in shared memory as fp32,
//     forms the (G x hd)·(hd x kBK) scores of the G query heads sharing the kv
//     head, and keeps a running max m, sum l and (G x hd) accumulator per
//     head. It writes the unnormalised (m, l, acc) of its chunk.
//  2. decode_merge_kernel, one block per (head, batch): M = max m_c,
//     out = sum_c acc_c e^(m_c - M) / max(sum_c l_c e^(m_c - M), 1e-20).
//
// Masked slots score -1e30, as in the reference, so with no valid slot at
// all every score is -1e30 and the result is the mean of V over all W slots,
// as the reference gives. Slots past W score -inf and never count. A tile
// with no valid slot is skipped when some slot elsewhere is valid: its
// weight would be e^(-1e30 - m) = 0. A chunk whose tiles were all skipped
// writes l = 0 and acc = 0, so it adds nothing to the merge.
//
// Bound on the H100: memory. Each valid slot's K and V are read once
// (2*B*KV*nvalid*hd elements) for 4*G*hd operations per slot, far below the
// card's operations-per-byte balance. The split puts enough blocks on the
// card to draw on all SMs' load bandwidth; loads are still 2-byte scalars
// (bf16), and the partials make one extra round trip through L2.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 64;                 // cache slots per tile (2 per lane)
constexpr int kMergeThreads = 128;
constexpr float kNegInf = -1e30f;       // the reference's mask value

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
  const int* valid;
  void* o;
  float* part_ml;                       // (B, KV, nsplit, G, 2): m, l
  float* part_acc;                      // (B, KV, nsplit, G, hd)
  int KV, G, W, hd, nsplit, chunk;      // chunk: slots per split, a multiple of kBK
  long long q_sb, q_sh;
  long long k_sb, k_sh, k_sw;
  long long v_sb, v_sh, v_sw;
  long long o_sb, o_sh;
  float scale;
};

size_t smem_bytes(int G, int hd) {
  const int kst = hd | 1;
  return sizeof(float) *
         (size_t)(2 * G * hd + kBK * kst + kBK * hd + G * kBK + 3 * G);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_partial_kernel(const Params p) {
  extern __shared__ float smem[];
  const int hd = p.hd, G = p.G, W = p.W;
  const int kst = hd | 1;                 // odd stride: column reads hit 32 banks
  float* Qs = smem;                       // G x hd
  float* Acc = Qs + G * hd;               // G x hd
  float* Ks = Acc + G * hd;               // kBK x kst
  float* Vs = Ks + kBK * kst;             // kBK x hd
  float* Ss = Vs + kBK * hd;              // G x kBK scores, then probabilities
  float* Ms = Ss + G * kBK;               // G running max
  float* Ls = Ms + G;                     // G running sum
  float* As = Ls + G;                     // G rescale factor of the current tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const int* valid = p.valid;
  const int w_begin = split * p.chunk;
  const int w_end = min(W, w_begin + p.chunk);

  for (int idx = tid; idx < G * hd; idx += kThreads) {
    const int g = idx / hd, d = idx - g * hd;
    Qs[idx] = to_f(q[(long long)(kvh * G + g) * p.q_sh + d]);
    Acc[idx] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    Ms[g] = kNegInf;
    Ls[g] = 0.f;
  }
  int any = 0;
  for (int w = tid; w < W; w += kThreads) any |= valid[w] > 0;
  const int any_valid = __syncthreads_or(any);

  for (int w0 = w_begin; w0 < w_end; w0 += kBK) {
    int mine = 0;
    for (int c = tid; c < kBK; c += kThreads) mine |= (w0 + c < W) && valid[w0 + c] > 0;
    // barrier: the previous tile's reads of Vs/Ss are done
    const int tile_valid = __syncthreads_or(mine);
    if (any_valid && !tile_valid) continue;

    for (int idx = tid; idx < kBK * hd; idx += kThreads) {
      const int c = idx / hd, d = idx - c * hd;
      float kx = 0.f, vx = 0.f;
      if (w0 + c < W) {
        kx = to_f(k[(long long)(w0 + c) * p.k_sw + d]);
        vx = to_f(v[(long long)(w0 + c) * p.v_sw + d]);
      }
      Ks[c * kst + d] = kx;
      Vs[c * hd + d] = vx;
    }
    __syncthreads();

    for (int idx = tid; idx < G * kBK; idx += kThreads) {
      const int g = idx / kBK, c = idx - g * kBK;
      float x;
      if (w0 + c >= W) {
        x = -INFINITY;           // ragged tail: not a slot at all
      } else if (valid[w0 + c] <= 0) {
        x = kNegInf;
      } else {
        const float* qr = Qs + g * hd;
        const float* kr = Ks + c * kst;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        x = dot * p.scale;
      }
      Ss[idx] = x;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float* srow = Ss + g * kBK;
      const float s0 = srow[lane], s1 = srow[lane + 32];
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float sum = warp_sum(p0 + p1);
      srow[lane] = p0;
      srow[lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        As[g] = alpha;
        Ls[g] = Ls[g] * alpha + sum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();

    const int nc = min(kBK, W - w0);
    for (int idx = tid; idx < G * hd; idx += kThreads) {
      const int g = idx / hd, d = idx - g * hd;
      const float* prow = Ss + g * kBK;
      float a = Acc[idx] * As[g];
      for (int c = 0; c < nc; ++c) a = fmaf(prow[c], Vs[c * hd + d], a);
      Acc[idx] = a;
    }
  }
  __syncthreads();

  const long long part = ((long long)b * p.KV + kvh) * p.nsplit + split;   // (b, kvh, split)
  float* ml = p.part_ml + part * G * 2;
  float* acc = p.part_acc + part * G * hd;
  for (int g = tid; g < G; g += kThreads) {
    ml[2 * g] = Ms[g];
    ml[2 * g + 1] = Ls[g];
  }
  for (int idx = tid; idx < G * hd; idx += kThreads) acc[idx] = Acc[idx];
}

template <typename T>
__global__ void __launch_bounds__(kMergeThreads) decode_merge_kernel(const Params p) {
  extern __shared__ float wts[];          // nsplit weights e^(m_c - M)
  __shared__ float red[kMergeThreads / 32];
  __shared__ float m_all, l_all;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / p.G, g = h - kvh * p.G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.G, hd = p.hd, ns = p.nsplit;
  const long long base = ((long long)b * p.KV + kvh) * ns;   // split 0 of (b, kvh)

  float m = -INFINITY;
  for (int c = tid; c < ns; c += kMergeThreads) m = fmaxf(m, p.part_ml[((base + c) * G + g) * 2]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (tid == 0) {
    float x = red[0];
    for (int i = 1; i < kMergeThreads / 32; ++i) x = fmaxf(x, red[i]);
    m_all = x;
  }
  __syncthreads();

  float l = 0.f;
  for (int c = tid; c < ns; c += kMergeThreads) {
    const float* ml = p.part_ml + ((base + c) * G + g) * 2;
    const float w = expf(ml[0] - m_all);
    wts[c] = w;
    l = fmaf(ml[1], w, l);
  }
  l = warp_sum(l);
  __syncthreads();                        // red[] reads above are done
  if (lane == 0) red[warp] = l;
  __syncthreads();
  if (tid == 0) {
    float x = 0.f;
    for (int i = 0; i < kMergeThreads / 32; ++i) x += red[i];
    l_all = x;
  }
  __syncthreads();

  const float inv = 1.f / fmaxf(l_all, 1e-20f);
  T* o = static_cast<T*>(p.o) + b * p.o_sb + (long long)h * p.o_sh;
  for (int d = tid; d < hd; d += kMergeThreads) {
    float a = 0.f;
    for (int c = 0; c < ns; ++c) a = fmaf(p.part_acc[((base + c) * G + g) * hd + d], wts[c], a);
    o[d] = from_f<T>(a * inv);
  }
}

template <typename T>
cudaError_t launch_typed(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.G, p.hd);
  cudaError_t err = cudaFuncSetAttribute(
      decode_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  decode_partial_kernel<T><<<dim3(p.nsplit, p.KV, B), kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t msmem = sizeof(float) * (size_t)p.nsplit;
  err = cudaFuncSetAttribute(
      decode_merge_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)msmem);
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T><<<dim3(p.KV * p.G, B), kMergeThreads, msmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16. part_ml (B,KV,nsplit,G,2) and part_acc
// (B,KV,nsplit,G,hd) are fp32 scratch from the caller; chunk is a multiple
// of kBK and chunk * nsplit >= W. Returns a cudaError_t (0 = both kernels
// launched; cudaErrorInvalidValue also when G x hd needs more shared memory
// than a block has).
int decode_attention_launch(int dtype, const void* q, const void* k, const void* v,
                            const int* valid, void* o, float* part_ml, float* part_acc,
                            int B, int H, int KV, int W, int hd, int nsplit, int chunk,
                            long long q_sb, long long q_sh,
                            long long k_sb, long long k_sh, long long k_sw,
                            long long v_sb, long long v_sh, long long v_sw,
                            long long o_sb, long long o_sh, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || W <= 0 || nsplit <= 0 ||
      chunk <= 0 || chunk % kBK != 0 || (long long)chunk * nsplit < W)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.valid = valid; p.o = o;
  p.part_ml = part_ml; p.part_acc = part_acc;
  p.KV = KV; p.G = H / KV; p.W = W; p.hd = hd; p.nsplit = nsplit; p.chunk = chunk;
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sw = k_sw;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sw = v_sw;
  p.o_sb = o_sb; p.o_sh = o_sh;
  p.scale = (float)(1.0 / sqrt((double)hd));   // hd ** -0.5, as the reference
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_typed<float>(p, B, st);
    case 1: return (int)launch_typed<__nv_bfloat16>(p, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
