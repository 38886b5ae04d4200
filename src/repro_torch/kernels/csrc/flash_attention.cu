// Prefix-aware GQA flash attention for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel): online-softmax attention with queries at
// absolute positions q_offset + i (cached-prefix prefill), causal masking, an
// optional sliding window and GQA without a materialised K/V repeat.
//
//   q (B,H,Sq,hd), k/v (B,KV,Sk,hd), out (B,H,Sq,hd); H % KV == 0, H/KV <= 64,
//   hd <= 256. Every tensor comes by strides; the head dimension must be
//   contiguous.
//
// One entry, flash_attention_launch, with two routes chosen by dtype alone:
//
//  * bf16 -> flash_mma_kernel<HDP>, both products on the tensor cores.
//  * fp32 -> flash_kernel<NJ>, fp32 FMA on the CUDA cores. The fp32 callers
//    (the recurrent models' fp32 phases, held at 5e-4, and the 2e-5 kernel
//    tolerance) need fp32 products: TF32 keeps a 10-bit mantissa and meets
//    neither, so this route keeps its CUDA-core arithmetic.
//
// Both routes give a block the G = H/KV query heads that share one kv head,
// packed head-major into rows r = g*bq + i (bq = rows/G), as the Pallas kernel
// packs them, so each K/V tile is read once per group; the grid is
// (q-tile, kv_head, batch). Rows: 128 for bf16 (two warpgroups of 64), 64 for
// fp32.
//
// Semantics shared by both routes, beyond the Pallas kernel's (all forced by
// the GPU or the engine):
//  * ragged tails (Sq, Sk not multiples of any tile) are masked in-kernel:
//    keys past Sk score -inf, keys outside the causal/window band -1e30 (the
//    reference's mask value); K/V rows past Sk and head columns past hd are
//    zero-filled in shared memory, so stale memory never meets P = 0;
//  * any hd <= 256, any Sq, Sk >= 1;
//  * key tiles wholly outside the causal/window band of the block are skipped
//    (the Pallas grid visits all of them). Tiles start at multiples of the
//    tile width from key 0, and a skipped or extra tile changes a row's
//    result by exactly nothing (its keys weigh e^(-1e30 - m) = 0, or are
//    wiped by alpha = 0 once a visible key is seen), so a row's output does
//    not depend on the block it lands in: a cache hit's suffix rows equal the
//    cold run's bit for bit (held in bf16 at full width by
//    cases.FLASH_IDENTITY). That is exact only while every row of the block
//    sees a key. A row whose band is empty (causal with a window, at position
//    q_offset + i >= Sk + window - 1) scores -1e30 on every key, so the
//    reference gives it the mean of V over all Sk keys; a block that holds
//    such a row therefore visits every tile.
//
// Bound on the H100 at the main path's shapes (yi-6b: 32 heads of 128 on 4 kv
// heads, 512 suffix queries against 2,560 keys; Griffin: 10 heads of 256 on
// one, 2,560 against 2,560, window 2,048): 900-1,400 flops per byte that must
// move, above the H100's balance point of 295, so operations bound both
// routes: 989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s of fp32 FMA.
//
// The bf16 route (flash_mma_kernel) therefore runs both products as
// wgmma.mma_async (m64nNk16, fp32 accumulation), two warpgroups of 64 rows:
//  * S = Q K^T with Q and the K tile in shared memory (128-byte swizzle,
//    K-major); O += P V with P rounded to bf16 in registers as the A operand
//    (as SDPA and FlashAttention round it; l sums the fp32 p) and V read
//    through the transposed (MN-major) B descriptor; hd is padded to HDP =
//    64, 128 or 256 with zeros;
//  * 64-key K/V tiles arrive by TMA into a ring of 3 slots (2 at hd 256: Q
//    64 KB + 2 x 64 KB), issued by one thread two tiles ahead (one at hd
//    256) so the copies overlap the products. The TMA unit writes the
//    128-byte swizzle and zero-fills keys past Sk and columns past hd, and
//    completes each slot on an mbarrier that the consumers wait on; one
//    block barrier per tile frees the slot the next copies overwrite. Q
//    comes once per block by 16-byte cp.async. Without 16-byte-aligned rows
//    and strides (odd hd, unaligned views) the same layout is filled
//    element by element;
//  * between the products the softmax runs on the CUDA cores, and it is the
//    largest phase of a tile (python -m repro_torch.kernels.phases). It is
//    cut to one FFMA and one ex2.approx per score: the running max is taken
//    over raw scores (scaling is monotonic), masks are applied only in
//    tiles that cross Sk or the block's band, and a warp whose rows kept
//    their maxima skips rescaling O. Masked keys keep the reference's
//    meaning: they weigh 1 while a row has seen no visible key (-1e30
//    against -1e30), else 0.
// The fp32 route (flash_kernel) keeps its CUDA-core form: key tiles staged
// in shared memory, the fp32 running max, sum and accumulator in registers.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;              // the reference's mask value
constexpr int kMaxGroup = 64;                  // query heads per kv head
constexpr int kMaxDevices = 64;

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
  int vec;       // bf16 route: q rows and strides allow 16-byte copies
  int tma;       // bf16 route: K/V tiles come by TMA (else element by element)
  int kdim[3], vdim[3];   // tensor-map dimension of k's/v's keys, kv heads, batch
  int pairs;     // bf16 route: output rows allow 4-byte stores of 2 values
  float scale;
};

// Sets a kernel's dynamic shared memory limit once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = bytes;
  return err;
}

// --------------------------------------------------------------------------
// fp32 route: CUDA-core FMA
// --------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;                      // packed query rows per block
constexpr int kRowsPerWarp = kRows / kWarps;   // 8
constexpr int kBK = 64;                        // keys per tile (2 per lane)

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

size_t smem_bytes(int hd) {
  const int kst = hd | 1;
  return sizeof(float) * (size_t)(kRows * hd + kBK * kst + kBK * hd + kRows * kBK);
}

// Key tiles are staged in shared memory; the fp32 running max, sum and
// accumulator stay in registers. Each warp owns 8 rows, so the row-wise
// softmax reductions are warp shuffles; lane l owns keys l and l+32 of a tile
// and output columns l, l+32, ... of its rows. NJ = number of 32-wide column
// groups a lane holds (hd <= 32 * NJ).
template <int NJ>
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
  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* o = static_cast<float*>(p.o);

  for (int idx = tid; idx < kRows * hd; idx += kThreads) {
    const int r = idx / hd, d = idx - r * hd;
    const int g = r / p.bq, i = r - g * p.bq;
    float x = 0.f;
    if (g < p.G && q0 + i < p.Sq)
      x = q[b * p.q_sb + (long long)(kvh * p.G + g) * p.q_sh +
            (long long)(q0 + i) * p.q_ss + d];
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
        kx = k[(long long)(kt + c) * p.k_ss + d];
        vx = v[(long long)(kt + c) * p.v_ss + d];
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
      float* orow = o + b * p.o_sb + (long long)(kvh * p.G + g) * p.o_sh +
                (long long)(q0 + qi) * p.o_ss;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = lane + 32 * j;
        if (d < hd) orow[d] = acc[i][j] / den;
      }
    }
  }
}

template <int NJ>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t stream) {
  static int allowed[kMaxDevices];
  const int smem = (int)smem_bytes(p.hd);
  cudaError_t err = allow_smem(flash_kernel<NJ>, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + p.bq - 1) / p.bq, p.KV, B);
  flash_kernel<NJ><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// --------------------------------------------------------------------------
// bf16 route: wgmma on the tensor cores
// --------------------------------------------------------------------------

namespace tc {

constexpr int kRows = 128;         // packed query rows per block
constexpr int kThreads = 256;      // two warpgroups, 64 rows each
constexpr int kBK = 64;            // keys per tile

// Shared memory: Q (kRows x HDP), then kStages slots of K and V (kBK x HDP
// each). Every tile is stored as HDP/64 column blocks of rows x 128 bytes in
// the 128-byte swizzle that wgmma's descriptors name: 16-byte chunk c of row
// r sits at chunk c ^ (r % 8) of its 128-byte line. At HDP 256, Q (64 KB)
// and two slots (64 KB each) fill most of the 227 KB a block may use.
template <int HDP>
struct Shape {
  static constexpr int kStages = HDP <= 128 ? 3 : 2;
  static constexpr int kQBytes = kRows * HDP * 2;
  static constexpr int kKVBytes = kBK * HDP * 2;
  static constexpr int kSmem = kQBytes + kStages * 2 * kKVBytes + 1024;   // + alignment
};

__device__ __forceinline__ uint32_t swz(int r, int c, int rows) {
  return (uint32_t)((c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// wgmma matrix descriptor of a 128-byte-swizzled tile at shared address
// `addr` (1024-byte aligned atoms): leading and stride byte offsets.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// generic-proxy writes (cp.async, st.shared) before async-proxy reads (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving accumulator registers across the async ops
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// 2^x on the special-function unit; subnormal results flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// D (64 x 64, fp32) (+)= A (64 x 16, smem) * B (16 x 64, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, fp32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, fp32) += A (64 x 16, registers) * B (16 x 256, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, "
      "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, "
      "%114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}"
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
        "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
        "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <int N> struct SS;
template <> struct SS<64> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db) {
    wgmma_ss_n64(d, da, db, 1);
  }
};
template <int N> struct RS;
template <> struct RS<64> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db) {
    wgmma_rs_n64(d, a, db);
  }
};
template <> struct RS<128> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db) {
    wgmma_rs_n128(d, a, db);
  }
};
template <> struct RS<256> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db) {
    wgmma_rs_n256(d, a, db);
  }
};

// Q rows of the block into the swizzled tile at `sq` (zero past Sq, G, hd).
template <int HDP>
__device__ __forceinline__ void load_q(const Params& p, uint32_t sq, unsigned char* gq,
                                       int q0, int kvh, int b, int tid) {
  constexpr int CH = HDP / 8;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb;
  if (p.vec) {
    for (int idx = tid; idx < kRows * CH; idx += kThreads) {
      const int r = idx / CH, c = idx - r * CH;
      const int g = r / p.bq, i = r - g * p.bq;
      const bool ok = g < p.G && q0 + i < p.Sq && c * 8 < p.hd;
      const __nv_bfloat16* src =
          ok ? q + (long long)(kvh * p.G + g) * p.q_sh + (long long)(q0 + i) * p.q_ss + c * 8
             : q;
      cp_async16(sq + swz(r, c, kRows), src, ok ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < kRows * HDP; idx += kThreads) {
      const int r = idx / HDP, d = idx - r * HDP;
      const int g = r / p.bq, i = r - g * p.bq;
      __nv_bfloat16 x = __float2bfloat16(0.f);
      if (g < p.G && q0 + i < p.Sq && d < p.hd)
        x = q[(long long)(kvh * p.G + g) * p.q_sh + (long long)(q0 + i) * p.q_ss + d];
      *reinterpret_cast<__nv_bfloat16*>(gq + swz(r, d >> 3, kRows) + (d & 7) * 2) = x;
    }
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n" :: "r"(bar), "r"(parity) : "memory");
}
// box (c0, c1, c2, c3) of a 4-d tensor map into shared memory at dst;
// completion adds its bytes to the transaction count of mbarrier bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
         "r"(bar)
      : "memory");
}

// Keys kt .. kt + BK - 1 of K and V into the ring slot at sk (K, then V) by
// TMA, one box of 64 columns x BK keys per column block that reaches into
// hd; the unit zero-fills keys past Sk and columns past hd, and writes the
// 128-byte swizzle. Issued by one thread; `bar` counts the bytes in.
template <int HDP, int BK>
__device__ __forceinline__ void tma_kv(const Params& p, const CUtensorMap* tk,
                                       const CUtensorMap* tv, uint32_t sk, uint32_t bar,
                                       int kt, int kvh, int b) {
  constexpr int kBox = BK * 128;
  const int ncb = (p.hd + 63) / 64;
  mbar_expect(bar, 2 * ncb * kBox);
  int kc[3], vc[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    kc[j] = (p.kdim[0] == j + 1 ? kt : 0) + (p.kdim[1] == j + 1 ? kvh : 0) +
            (p.kdim[2] == j + 1 ? b : 0);
    vc[j] = (p.vdim[0] == j + 1 ? kt : 0) + (p.vdim[1] == j + 1 ? kvh : 0) +
            (p.vdim[2] == j + 1 ? b : 0);
  }
  for (int cb = 0; cb < ncb; ++cb) {
    tma_load(sk + cb * kBox, tk, bar, cb * 64, kc[0], kc[1], kc[2]);
    tma_load(sk + BK * HDP * 2 + cb * kBox, tv, bar, cb * 64, vc[0], vc[1], vc[2]);
  }
}

// The same tile element by element, for inputs whose rows or strides the
// TMA unit cannot take (odd hd, unaligned views); zero past Sk and hd.
template <int HDP, int BK>
__device__ __forceinline__ void load_kv(const Params& p, unsigned char* gk,
                                        const __nv_bfloat16* k, const __nv_bfloat16* v,
                                        int kt, int tid) {
  constexpr int V_OFF = BK * HDP * 2;
  for (int idx = tid; idx < BK * HDP; idx += kThreads) {
    const int r = idx / HDP, d = idx - r * HDP;
    __nv_bfloat16 kx = __float2bfloat16(0.f), vx = kx;
    if (kt + r < p.Sk && d < p.hd) {
      kx = k[(long long)(kt + r) * p.k_ss + d];
      vx = v[(long long)(kt + r) * p.v_ss + d];
    }
    unsigned char* dst = gk + swz(r, d >> 3, BK) + (d & 7) * 2;
    *reinterpret_cast<__nv_bfloat16*>(dst) = kx;
    *reinterpret_cast<__nv_bfloat16*>(dst + V_OFF) = vx;
  }
}

// Built with -DFLASH_PHASE_CLOCKS (repro_torch.kernels.phases), one thread
// per warpgroup adds the clock64 cycles of each phase of the tile loop to
// phase_clocks[warpgroup]: ring barrier (the block barrier, then the wait
// on the tile's mbarrier), copy issue, S, softmax, PV; then the tiles. The
// shipped library has none of it.
#ifdef FLASH_PHASE_CLOCKS
__device__ unsigned long long phase_clocks[2][6];
#define PHASE_MARK(i) do { c1 = clock64(); dc[i] += c1 - c0; c0 = c1; } while (0)
#else
#define PHASE_MARK(i) do {} while (0)
#endif

// HDP = head width padded to 64, 128 or 256. Thread t of warpgroup w holds
// accumulator rows w*64 + 16*(t/32) + (t%32)/4 and that + 8; for each 8-key
// (or 8-column) group n it holds columns 8n + 2*(t%4) + {0, 1}: registers
// 4n, 4n+1 on the first row, 4n+2, 4n+3 on the second.
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_mma_kernel(const Params p, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv) {
  using Sh = Shape<HDP>;
  constexpr int kStages = Sh::kStages;
  constexpr int kSlot = 2 * Sh::kKVBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  const uint32_t sQ = raw + pad;
  unsigned char* gQ = smem_raw + pad;
  const uint32_t sKV = sQ + Sh::kQBytes;
  unsigned char* gKV = gQ + Sh::kQBytes;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int q0 = blockIdx.x * p.bq, kvh = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  __shared__ __align__(8) uint64_t full[kStages];   // slot s holds its tile
  const uint32_t sFull = static_cast<uint32_t>(__cvta_generic_to_shared(full));
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(sFull + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // Key range the block's rows can see, unless one of its rows sees none.
  int empty = 0;
  if (tid < kRows) {
    const int g = tid / p.bq, i = tid - g * p.bq;
    if (g < p.G && q0 + i < p.Sq) {
      const int pos = p.q_offset + q0 + i;
      const int lo = p.has_window ? max(0, pos - p.window + 1) : 0;
      const int hi = p.causal ? min(p.Sk - 1, pos) : p.Sk - 1;
      empty = lo > hi;
    }
  }
  const int qmin = p.q_offset + q0;
  const int qmax = p.q_offset + min(q0 + p.bq, p.Sq) - 1;
  int kstart = 0, kend = p.Sk;
  if (!__syncthreads_or(empty)) {
    if (p.causal) kend = min(p.Sk, qmax + 1);
    if (p.has_window) kstart = max(0, qmin - p.window + 1);
  }
  const int kt0 = (kstart / kBK) * kBK;
  const int ntiles = (kend - kt0 + kBK - 1) / kBK;

  // the first kStages - 1 tiles, then Q
  if (p.tma) {
    if (tid == 0) {
      for (int s = 0; s < kStages - 1 && s < ntiles; ++s)
        tma_kv<HDP, kBK>(p, &tk, &tv, sKV + s * kSlot, sFull + 8 * s, kt0 + s * kBK, kvh, b);
    }
    // column blocks wholly past hd (hd 129-192): no box is issued for them,
    // so they are zeroed once here
    for (int idx = ((p.hd + 63) / 64) * kBK * 8 + tid; idx < HDP / 64 * kBK * 8;
         idx += kThreads)
      for (int s = 0; s < kStages; ++s) {
        reinterpret_cast<uint4*>(gKV + s * kSlot)[idx] = make_uint4(0, 0, 0, 0);
        reinterpret_cast<uint4*>(gKV + s * kSlot + Sh::kKVBytes)[idx] = make_uint4(0, 0, 0, 0);
      }
  } else {
    for (int s = 0; s < kStages - 1 && s < ntiles; ++s)
      load_kv<HDP, kBK>(p, gKV + s * kSlot, k, v, kt0 + s * kBK, tid);
  }
  load_q<HDP>(p, sQ, gQ, q0, kvh, b, tid);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();                 // st.shared and cp.async before wgmma reads

  // this thread's two rows and their positions
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wg * 64 + (warp & 3) * 16 + (lane >> 2) + 8 * h;
    pos[h] = p.q_offset + q0 + (r - (r / p.bq) * p.bq);
  }
  const float sl2 = p.scale * 1.4426950408889634f;    // exp(x) = exp2(x log2 e)

  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
  // m: running max of the scaled scores of visible keys, kNegInf while a
  // row has seen none (then its masked keys weigh e^0 = 1, as the
  // reference's -1e30 scores do); l: this thread's part of the row sum
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // A: this warpgroup's 64 rows of Q, K-major; the leading offset is unused
  const uint64_t dq = sw128_desc(sQ + wg * 64 * 128, 16, 1024);

#ifdef FLASH_PHASE_CLOCKS
  unsigned long long dc[6] = {0, 0, 0, 0, 0, 0};
  long long c0 = clock64(), c1;
#endif
  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();                   // slot (t - 1) % kStages is free; element path:
    PHASE_MARK(0);                     // tile t is in
    const int nt = t + kStages - 1;
    if (nt < ntiles) {
      const int slot = nt % kStages;
      if (!p.tma)
        load_kv<HDP, kBK>(p, gKV + slot * kSlot, k, v, kt0 + nt * kBK, tid);
      else if (tid == 0)
        tma_kv<HDP, kBK>(p, &tk, &tv, sKV + slot * kSlot, sFull + 8 * slot, kt0 + nt * kBK,
                         kvh, b);
    }
    PHASE_MARK(1);
    if (p.tma) mbar_wait(sFull + 8 * (t % kStages), (t / kStages) & 1);
    PHASE_MARK(0);
    const int kt = kt0 + t * kBK;
    const uint32_t sK = sKV + (t % kStages) * kSlot;

    // S = Q K^T over hd in steps of 16: +32 bytes inside a 128-byte line,
    // the next column block every 4 steps
    float s[kBK / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
    const uint64_t dk = sw128_desc(sK, 16, 1024);
    fence_regs(s);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < HDP / 16; ++j) {
      const uint32_t qoff = (j >> 2) * (kRows * 128) + (j & 3) * 32;
      const uint32_t koff = (j >> 2) * (kBK * 128) + (j & 3) * 32;
      SS<kBK>::mma(s, dq + (qoff >> 4), dk + (koff >> 4));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    PHASE_MARK(2);

    // Masks, only in tiles that reach past Sk or the block's band: a key
    // outside a row's band (-1e30 in the reference) or past Sk (no key)
    // drops out of the max; `band` marks the former.
    const bool edge = kt + kBK > p.Sk || (p.causal && kt + kBK - 1 > qmin) ||
                      (p.has_window && kt <= qmax - p.window);
    uint64_t band = 0;
    if (edge) {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int c = kt + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
        const int qp = pos[(i >> 1) & 1];
        if (c >= p.Sk) {
          s[i] = -INFINITY;
        } else if ((p.causal && c > qp) || (p.has_window && c <= qp - p.window)) {
          s[i] = -INFINITY;
          band |= 1ull << i;
        }
      }
    }

    // online softmax on raw scores: scaling is monotonic, so the max of the
    // scaled scores is the scaled max; p = 2^(s sl2 - m) in one FFMA
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2], nm[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h] * sl2);
      alpha[h] = mn == m[h] ? 1.f : ex2(m[h] - mn);
      m[h] = mn;
      nm[h] = -mn;
    }
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] = ex2(fmaf(s[i], sl2, nm[(i >> 1) & 1]));
    if (edge) {                        // rows that have seen no visible key yet
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i)
        if (((band >> i) & 1) && m[(i >> 1) & 1] == kNegInf) s[i] = 1.f;
    }
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) rs[(i >> 1) & 1] += s[i];
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];

    // a warp whose rows kept their maxima skips the rescale (x 1 is exact)
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    }
    // P in bf16 as wgmma's register A operand, 16 keys per step
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    PHASE_MARK(3);

    // O += P V; V is MN-major (hd contiguous): 8-key groups 1024 bytes
    // apart, 64-column blocks kBK * 128 bytes apart
    const uint64_t dv = sw128_desc(sK + Sh::kKVBytes, kBK * 128, 1024);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) RS<HDP>::mma(o, pa[kk], dv + ((kk * 16 * 128) >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (!p.tma) fence_proxy_async();   // the element path's next tile, before wgmma
    PHASE_MARK(4);
  }
#ifdef FLASH_PHASE_CLOCKS
  if ((tid & 127) == 0) {
    for (int i = 0; i < 5; ++i) atomicAdd(&phase_clocks[wg][i], dc[i]);
    atomicAdd(&phase_clocks[wg][5], (unsigned long long)ntiles);
  }
#endif

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = wg * 64 + (warp & 3) * 16 + (lane >> 2) + 8 * h;
    const int g = r / p.bq, qi = r - g * p.bq;
    if (g < p.G && q0 + qi < p.Sq) {
      const float den = fmaxf(l[h], 1e-20f);
      __nv_bfloat16* orow = out + b * p.o_sb + (long long)(kvh * p.G + g) * p.o_sh +
                            (long long)(q0 + qi) * p.o_ss;
#pragma unroll
      for (int n = 0; n < HDP / 8; ++n) {
        const int d = n * 8 + (lane & 3) * 2;
        const float x0 = o[4 * n + 2 * h] / den, x1 = o[4 * n + 2 * h + 1] / den;
        if (p.pairs && d + 1 < p.hd) {
          *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(x0, x1);
        } else {
          if (d < p.hd) orow[d] = __float2bfloat16(x0);
          if (d + 1 < p.hd) orow[d + 1] = __float2bfloat16(x1);
        }
      }
    }
  }
}

}  // namespace tc

template <int HDP>
cudaError_t launch_mma(const Params& p, const CUtensorMap& tk, const CUtensorMap& tv, int B,
                       cudaStream_t stream) {
  static int allowed[kMaxDevices];
  constexpr int smem = tc::Shape<HDP>::kSmem;
  cudaError_t err = allow_smem(tc::flash_mma_kernel<HDP>, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + p.bq - 1) / p.bq, p.KV, B);
  tc::flash_mma_kernel<HDP><<<grid, tc::kThreads, smem, stream>>>(p, tk, tv);
  return cudaGetLastError();
}

// A stride allows 16-byte copies if it is a positive multiple of 8 elements
// or its dimension has one entry (then it is never applied).
bool aligned8(long long stride, int n) { return n == 1 || (stride > 0 && stride % 8 == 0); }

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime
// (so the library needs no link to libcuda); null if the driver lacks it.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// Describes k or v (B, KV, Sk, hd; strides in elements) to the TMA unit as
// boxes of 64 head columns x 64 keys in the 128-byte swizzle. Dimension 0 is
// the head column; keys, kv heads and batch follow in order of stride, a
// dimension of one entry last with the stride that would follow. dim[j]
// receives the map dimension of keys (j = 0), kv heads (1) and batch (2).
// Returns false if the driver has no encoder or refuses the map.
bool encode_kv(CUtensorMap* map, const void* base, int hd, int Sk, int KV, int B,
               long long ss, long long sh, long long sb, int* dim) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const long long n[3] = {Sk, KV, B}, st[3] = {ss, sh, sb};
  int order[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i)          // insertion sort: size-1 last, else by stride
    for (int j = i; j > 0; --j) {
      const int a = order[j - 1], c = order[j];
      const bool swap = (n[a] == 1 && n[c] > 1) ||
                        (n[a] > 1 && n[c] > 1 && st[c] < st[a]);
      if (!swap) break;
      order[j - 1] = c;
      order[j] = a;
    }
  cuuint64_t gdim[4] = {(cuuint64_t)hd, 1, 1, 1}, gstride[3];
  cuuint32_t box[4] = {64, 1, 1, 1}, estride[4] = {1, 1, 1, 1};
  unsigned long long extent = 2ull * hd;   // bytes spanned by the dimensions so far
  for (int i = 0; i < 3; ++i) {
    const int d = order[i];
    const unsigned long long bytes = n[d] > 1 ? 2ull * st[d] : (extent + 15) / 16 * 16;
    gdim[i + 1] = (cuuint64_t)n[d];
    gstride[i] = bytes;
    box[i + 1] = d == 0 ? tc::kBK : 1;
    extent = bytes * n[d];
    dim[d] = i + 1;
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), gdim,
                gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
  if (KV <= 0 || H % KV != 0 || hd <= 0 || hd > 256 || H / KV > kMaxGroup || Sq <= 0 ||
      Sk <= 0)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.KV = KV; p.G = H / KV; p.Sq = Sq; p.Sk = Sk; p.hd = hd;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.q_offset = q_offset; p.causal = causal;
  p.has_window = has_window; p.window = window;
  p.scale = (float)(1.0 / sqrt((double)hd));   // hd ** -0.5, as the reference
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    p.bq = kRows / p.G;
    if (hd <= 64) return (int)launch_f32<2>(p, B, st);
    if (hd <= 128) return (int)launch_f32<4>(p, B, st);
    return (int)launch_f32<8>(p, B, st);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  p.bq = tc::kRows / p.G;
  p.vec = hd % 8 == 0 && (uintptr_t)q % 16 == 0 && aligned8(q_sb, B) && aligned8(q_sh, H) &&
          aligned8(q_ss, Sq);
  // TMA takes K and V wherever their rows and strides allow 16-byte copies
  CUtensorMap tk = {}, tv = {};
  p.tma = hd % 8 == 0 && (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0 &&
          aligned8(k_sb, B) && aligned8(k_sh, KV) && aligned8(k_ss, Sk) && aligned8(v_sb, B) &&
          aligned8(v_sh, KV) && aligned8(v_ss, Sk);
  if (p.tma && !(encode_kv(&tk, k, hd, Sk, KV, B, k_ss, k_sh, k_sb, p.kdim) &&
                 encode_kv(&tv, v, hd, Sk, KV, B, v_ss, v_sh, v_sb, p.vdim)))
    return (int)cudaErrorNotSupported;
  p.pairs = hd % 2 == 0 && (uintptr_t)o % 4 == 0 && o_sb % 2 == 0 && o_sh % 2 == 0 &&
            o_ss % 2 == 0;
  if (hd <= 64) return (int)launch_mma<64>(p, tk, tv, B, st);
  if (hd <= 128) return (int)launch_mma<128>(p, tk, tv, B, st);
  return (int)launch_mma<256>(p, tk, tv, B, st);
}

#ifdef FLASH_PHASE_CLOCKS
// Copies phase_clocks (2 x 6 counters) to `out` and zeroes them.
int flash_phase_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, tc::phase_clocks, sizeof(tc::phase_clocks));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[12] = {};
  return (int)cudaMemcpyToSymbol(tc::phase_clocks, zero, sizeof(zero));
}
#endif
}  // extern "C"
