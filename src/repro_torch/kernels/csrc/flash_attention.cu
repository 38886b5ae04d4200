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
// Two entries. flash_attention_launch serves; flash_attention_train_launch,
// the training path's forward, also writes each row's logsumexp to lse
// (B,H,Sq) fp32, in base 2 of the scores times hd^-0.5 log2 e (the units in
// which both kernels keep their running max, and in which the backward's
// ex2 exponentiates), so that the backward does not recompute it. The write
// sits in each route's epilogue behind a template flag (kLse) that the
// serving entry's instantiations leave false, so their code is the code
// without it. A row whose band is empty gets -1e30 log2 e, the mask value's.
// Each entry has two routes chosen by dtype alone:
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
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kNegInf = -1e30f;              // the reference's mask value
constexpr int kMaxGroup = 64;                  // query heads per kv head
constexpr float kLog2e = 1.4426950408889634f;

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
template <int NJ, bool kLse>
__global__ void __launch_bounds__(kThreads) flash_kernel(const Params p, float* lse) {
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
      if constexpr (kLse) {            // base 2: m and l are natural-log units here
        if (lane == 0)
          lse[((long long)b * p.KV * p.G + kvh * p.G + g) * p.Sq + q0 + qi] =
              (m[i] + logf(l[i])) * kLog2e;
      }
    }
  }
}

template <int NJ, bool kLse>
cudaError_t launch_f32(const Params& p, float* lse, int B, cudaStream_t stream) {
  static int allowed[kMaxDevices];
  const int smem = (int)smem_bytes(p.hd);
  cudaError_t err = allow_smem(flash_kernel<NJ, kLse>, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + p.bq - 1) / p.bq, p.KV, B);
  flash_kernel<NJ, kLse><<<grid, kThreads, smem, stream>>>(p, lse);
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
template <int HDP, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
    flash_mma_kernel(const Params p, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, float* lse) {
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
      // base 2, of the raw scores times scale log2 e, as the backward's ex2
      // takes it; a row that saw no visible key gets the mask value's
      if constexpr (kLse) {
        if ((lane & 3) == 0)
          lse[((long long)b * p.KV * p.G + kvh * p.G + g) * p.Sq + q0 + qi] =
              m[h] == kNegInf ? kNegInf * kLog2e : m[h] + log2f(l[h]);
      }
    }
  }
}

}  // namespace tc

template <int HDP, bool kLse>
cudaError_t launch_mma(const Params& p, const CUtensorMap& tk, const CUtensorMap& tv,
                       float* lse, int B, cudaStream_t stream) {
  static int allowed[kMaxDevices];
  constexpr int smem = tc::Shape<HDP>::kSmem;
  cudaError_t err = allow_smem(tc::flash_mma_kernel<HDP, kLse>, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + p.bq - 1) / p.bq, p.KV, B);
  tc::flash_mma_kernel<HDP, kLse><<<grid, tc::kThreads, smem, stream>>>(p, tk, tv, lse);
  return cudaGetLastError();
}

// Both entries: kLse (the training entry) also writes lse; the serving
// entry's instantiations (kLse = false) never read the pointer.
template <bool kLse>
int launch_entry(int dtype, const void* q, const void* k, const void* v, void* o, float* lse,
                 int B, int H, int KV, int Sq, int Sk, int hd,
                 long long q_sb, long long q_sh, long long q_ss,
                 long long k_sb, long long k_sh, long long k_ss,
                 long long v_sb, long long v_sh, long long v_ss,
                 long long o_sb, long long o_sh, long long o_ss,
                 int q_offset, int causal, int has_window, int window, void* stream) {
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
    if (hd <= 64) return (int)launch_f32<2, kLse>(p, lse, B, st);
    if (hd <= 128) return (int)launch_f32<4, kLse>(p, lse, B, st);
    return (int)launch_f32<8, kLse>(p, lse, B, st);
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
  if (p.tma && !(encode_rows(&tk, k, hd, Sk, KV, B, k_ss, k_sh, k_sb, p.kdim, tc::kBK) &&
                 encode_rows(&tv, v, hd, Sk, KV, B, v_ss, v_sh, v_sb, p.vdim, tc::kBK)))
    return (int)cudaErrorNotSupported;
  p.pairs = hd % 2 == 0 && (uintptr_t)o % 4 == 0 && o_sb % 2 == 0 && o_sh % 2 == 0 &&
            o_ss % 2 == 0;
  if (hd <= 64) return (int)launch_mma<64, kLse>(p, tk, tv, lse, B, st);
  if (hd <= 128) return (int)launch_mma<128, kLse>(p, tk, tv, lse, B, st);
  return (int)launch_mma<256, kLse>(p, tk, tv, lse, B, st);
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
  return launch_entry<false>(dtype, q, k, v, o, nullptr, B, H, KV, Sq, Sk, hd, q_sb, q_sh,
                             q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                             q_offset, causal, has_window, window, stream);
}

// The training entry: the same launch, and lse (B, H, Sq) fp32 contiguous,
// each row's logsumexp in base 2 of its scores times hd^-0.5 log2 e.
int flash_attention_train_launch(int dtype, const void* q, const void* k, const void* v,
                                 void* o, void* lse, int B, int H, int KV, int Sq, int Sk,
                                 int hd, long long q_sb, long long q_sh, long long q_ss,
                                 long long k_sb, long long k_sh, long long k_ss,
                                 long long v_sb, long long v_sh, long long v_ss,
                                 long long o_sb, long long o_sh, long long o_ss,
                                 int q_offset, int causal, int has_window, int window,
                                 void* stream) {
  return launch_entry<true>(dtype, q, k, v, o, static_cast<float*>(lse), B, H, KV, Sq, Sk, hd,
                            q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,
                            o_ss, q_offset, causal, has_window, window, stream);
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
