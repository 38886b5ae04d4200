// Backward of the prefix-aware GQA flash attention (csrc/flash_attention.cu)
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package has no backward kernel, because
// its model never calls Pallas; training there differentiates the jnp
// attention of repro/models/common.py (_attend, attention; l. 167-215) by
// autodiff. In the port the forward kernel *is* the attention on the card,
// so its gradient needs a kernel of its own (the plain version's autograd is
// for CPU tensors only, and a library's backward is not a port).
//
//   q, o, dout (B,H,Sq,hd); k, v (B,KV,Sk,hd); H % KV == 0, H/KV <= 64,
//   hd <= 256. Inputs come by strides (head dimension contiguous); dq, dk,
//   dv are written contiguous in the inputs' dtype. lse (B,H,Sq) fp32 is the
//   forward's: flash_attention_train_launch writes each row's logsumexp in
//   base 2 of its scores times hd^-0.5 log2 e. dsum (B,H,Sq) fp32 is scratch
//   that the wrapper allocates.
//
// The function is the gradient of the reference's: s = scale q.k on the
// causal/window band, -1e30 elsewhere, p = softmax over all Sk keys,
// o = p v. With P = 2^(s log2 e - lse) and D = rowsum(dO * O):
//   dV = P^T dO,  dS = P * (dO V^T - D),  dQ = scale dS K,  dK = scale dS^T Q.
// A row whose band holds no key (a window that ends before the keys begin)
// gets the mean of V over all Sk keys in the forward, so its gradient is
// dV_j += dO / Sk for every key j, no dQ and no dK; its lse (-1e30 log2 e)
// is never used. The masked scores of a row that sees a key weigh exactly 0.
//
// One entry, flash_attention_bwd_launch, two launches on the caller's stream
// and no atomics, so two runs give the same bits: a dQ kernel that also
// writes D to dsum, then a dK/dV kernel that reads it. GQA's sum over the
// G query heads that share a kv head happens inside one dK/dV block.
//
// Bound on the H100: five products of 2 hd flops per visible (query, key)
// pair (Q K^T, dO V^T, P^T dO, dS^T Q, dS K); at the training shapes
// (h2o-danube-1.8b: 32 heads of 80 on 8 kv heads, 8,192 tokens, window
// 4,096; yi-6b: 32 heads of 128 on 4, 4,096 tokens) that is about 3,000
// and 2,300 flops per byte that must move (q, k, v, o, dO in; dq, dk, dv
// out), far above the card's 295, so operations bound it: 989 TFLOP/s for
// bf16 on the tensor cores, 67 TFLOP/s of fp32 FMA.
// Two kernels without atomics recompute S and dP in both, seven products;
// the single kernel that adds dQ by atomics does five but gives other bits
// from run to run.
//
// Routes, chosen from (dtype, hd) alone by the caller (flash_attention.
// bwd_route), which passes the route to the entry:
//
//  * bf16, hd <= 128 (every training shape: danube hd 80, yi-6b and
//    qwen2-vl-2b 128, the enc-dec 64): the tensor cores, wgmma with fp32
//    accumulation, two warpgroups a block, the forward's 128-byte swizzle
//    and descriptors (hopper.cuh).
//    - flash_bwd_dq_mma_kernel: 128 packed query rows (the G heads times
//      128/G positions, as the forward packs them), Q and dO resident (by
//      cp.async), 64-key K/V tiles by TMA through a ring of 3 mbarrier
//      slots, issued by one thread two tiles ahead. Per tile S = Q K^T and
//      dP = dO V^T (both operands in shared memory), P and dS in registers,
//      dS rounded to bf16 as the register A operand of dQ += dS K (K read
//      through the transposed, MN-major, descriptor, as the forward reads V).
//      Blocks of the last rows run first: under a causal mask they see the
//      most keys.
//    - flash_bwd_dkdv_mma_kernel: a block of keys of one kv head, K and V
//      resident (by TMA). Its work is the sequence of 64-row Q/dO tiles of
//      the G query heads whose band reaches those keys, by TMA through a
//      ring of mbarrier slots, issued by one thread ahead of the round that
//      needs them. Per tile S^T = K Q^T and dP^T = V dO^T, then P^T and dS^T
//      in registers, each rounded to bf16 (as FlashAttention-2 and -3 round
//      them) as the A operand of dV += P^T dO and dK += dS^T Q, Q and dO
//      through the MN-major descriptor. lse and D of the next round's rows
//      go to shared memory during the current one. Blocks of the first keys
//      run first. The block's keys follow the mask (the caller's rule,
//      flash_attention.bwd_keys, passes them to the entry):
//      . a window, or no causal mask: 128 keys, 64 a warpgroup, both on
//        every tile, so each tile is loaded once for 128 keys. Every block
//        sees about the same rows (at most window + 64 of each head).
//      . causal without a window: 64 keys, both warpgroups on them, taking
//        alternate tiles and adding their dK and dV through shared memory
//        at the end. The first keys see every row and the last one tile, so
//        the longest block of 128 keys took twice the mean (yi-6b's shape
//        had 128 such blocks, one wave on 132 SMs); 64-key blocks give twice
//        the blocks at half the longest, for twice the tile loads.
//    Tiles are stored with hd padded to HDP = 64 or 128 columns (zero-filled
//    by the TMA unit and by cp.async) for the 128-byte swizzle, but every
//    product runs over HDK = hd rounded up to 16 columns only: the four
//    that reduce over hd take HDK / 16 k-steps, the three whose N is hd
//    (dV, dK, dQ) are m64nHDKk16 with B read through the MN-major descriptor
//    across the first column block and into the second (N = 80 at danube's
//    hd 80: 40 accumulator registers a thread instead of 64, and 5/8 of the
//    padded products' work).
//  * fp32, any hd: the CUDA cores. TF32 products would miss the 2e-5 kernel
//    tolerance and the fp32 layer-gradient gate, for the reason the
//    forward's fp32 route keeps fp32 FMA.
//  * bf16, hd > 128: the CUDA-core kernels with bf16 loads. The fp32 dK and
//    dV accumulators of 64 keys x hd would not fit a warpgroup's registers
//    beside S and dP; no training path sends such a shape.
//  On the CUDA cores each warp owns 8 rows (dq) or 8 keys (dk/dv) of a 64-row
//  block; a lane owns X keys (dq) or X query rows (dk/dv) of a tile and NJ
//  32-wide column groups of hd; shared memory is read as warp broadcasts and
//  conflict-free columns (odd row strides). Both take lse from the forward.
#include <limits.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kNegInf = -1e30f;      // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxGroup = 64;          // query heads per kv head
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;              // dq kernel: packed query rows per block
constexpr int kKeys = 64;              // dk/dv kernel: keys per block
constexpr int kPerWarp = 8;            // rows (dq) or keys (dk/dv) per warp

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  const float* lse;  // (B, H, Sq) contiguous, base 2, from the forward
  float* dsum;       // (B, H, Sq) contiguous: D = rowsum(dO * O)
  int H, KV, G, Sq, Sk, hd, bq;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long d_sb, d_sh, d_ss;
  int q_offset, causal, has_window, window;
  int qdim[3], ddim[3], kdim[3], vdim[3];   // tensor-map dimensions (tensor-core route)
  float scale;
  float sl2;         // scale * log2 e
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The keys [lo, hi] that the query at absolute position pos sees; lo > hi
// for a row whose band is empty. As the forward and the reference: causal
// keeps keys <= pos, a window keeps keys > pos - window.
__device__ __forceinline__ void band(const BwdParams& p, int pos, int& lo, int& hi) {
  lo = p.has_window ? max(0, pos - p.window + 1) : 0;
  hi = p.causal ? min(p.Sk - 1, pos) : p.Sk - 1;
}

__device__ __forceinline__ bool masked(const BwdParams& p, int key, int pos) {
  return (p.causal && key > pos) || (p.has_window && key <= pos - p.window);
}

__host__ __device__ __forceinline__ int clamp_rows(long long x, int Sq) {
  return (int)(x < 0 ? 0 : (x > Sq ? Sq : x));
}

// Query rows whose band can reach keys k0..klast: causal needs pos >= k0, a
// window pos <= klast + window - 1.
__device__ __forceinline__ void row_range(const BwdParams& p, int k0, int klast, int& ibeg,
                                          int& iend) {
  ibeg = p.causal ? clamp_rows((long long)k0 - p.q_offset, p.Sq) : 0;
  iend = p.has_window ? clamp_rows((long long)klast + p.window - p.q_offset, p.Sq) : p.Sq;
}

// Rows whose band is empty weigh every key 1/Sk in the forward. They are the
// positions below e0 (causal: pos < 0; with a window <= 0, all) and from
// e1 = Sk + window - 1 on (a window that ends before the keys begin): rows
// [0, ie0) and [ie1, Sq).
__device__ __forceinline__ void empty_rows(const BwdParams& p, int& ie0, int& ie1) {
  const long long e0 = p.causal ? ((p.has_window && p.window <= 0) ? LLONG_MAX / 2 : 0)
                                : LLONG_MIN / 2;
  const long long e1 = p.has_window ? (long long)p.Sk + p.window - 1 : LLONG_MAX / 2;
  ie0 = clamp_rows(e0 - p.q_offset, p.Sq);
  ie1 = max(ie0, clamp_rows(e1 - p.q_offset, p.Sq));
}

// --------------------------------------------------------------------------
// CUDA-core route (fp32; bf16 at hd > 128)
// dQ and D: one block per 64 packed query rows of one kv head's group
// --------------------------------------------------------------------------

size_t dq_smem_bytes(int hd, int bk) {
  return sizeof(float) * (size_t)(2 * kRows * hd + 2 * bk * (hd | 1) + kRows * bk);
}

template <typename T, int NJ, int X>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int BK = 32 * X;              // keys per tile, X per lane
  extern __shared__ float smem[];
  __shared__ int krange[2];
  const int hd = p.hd;
  const int kst = hd | 1;                 // odd stride: column reads hit 32 banks
  float* Qs = smem;                       // kRows x hd
  float* Gs = Qs + kRows * hd;            // kRows x hd: dO
  float* Ks = Gs + kRows * hd;            // BK x kst
  float* Vs = Ks + BK * kst;              // BK x kst
  float* Ss = Vs + BK * kst;              // kRows x BK: dS (each warp its own rows)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * p.bq, kvh = blockIdx.y, b = blockIdx.z;
  const T* q = static_cast<const T*>(p.q);
  const T* o = static_cast<const T*>(p.o);
  const T* dO = static_cast<const T*>(p.dout);
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  if (tid == 0) {
    krange[0] = INT_MAX;
    krange[1] = -1;
  }
  for (int idx = tid; idx < kRows * hd; idx += kThreads) {
    const int r = idx / hd, d = idx - r * hd;
    const int g = r / p.bq, i = r - g * p.bq;
    float x = 0.f, y = 0.f;
    if (g < p.G && q0 + i < p.Sq) {
      const long long h = kvh * p.G + g, row = q0 + i;
      x = ld(q + b * p.q_sb + h * p.q_sh + row * p.q_ss + d);
      y = ld(dO + b * p.d_sb + h * p.d_sh + row * p.d_ss + d);
    }
    Qs[idx] = x;
    Gs[idx] = y;
  }
  __syncthreads();

  // the warp's rows: r = warp + kWarps * i; live = a real row that sees a key
  int lo[kPerWarp], hi[kPerWarp];
  bool live[kPerWarp];
  float D[kPerWarp], lse[kPerWarp];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int r = warp + kWarps * i;
    const int g = r / p.bq, qi = r - g * p.bq;
    const bool valid = g < p.G && q0 + qi < p.Sq;
    band(p, p.q_offset + q0 + qi, lo[i], hi[i]);
    live[i] = valid && lo[i] <= hi[i];
    if (live[i] && lane == 0) {
      atomicMin(&krange[0], lo[i]);
      atomicMax(&krange[1], hi[i]);
    }
    float acc = 0.f;
    lse[i] = 0.f;
    if (valid) {
      const long long h = kvh * p.G + g, row = q0 + qi;
      const T* orow = o + b * p.o_sb + h * p.o_sh + row * p.o_ss;
      for (int d = lane; d < hd; d += 32) acc = fmaf(Gs[r * hd + d], ld(orow + d), acc);
      if (live[i]) lse[i] = p.lse[((long long)b * p.H + h) * p.Sq + row];
    }
    D[i] = warp_sum(acc);
  }
  __syncthreads();
  // the keys of the live rows' bands (none if no row is live); an empty row
  // has no dQ, and its dV share is the dk/dv kernel's
  const int kstart = krange[0], kend = krange[1] + 1;
  const int kfirst = kstart < kend ? (kstart / BK) * BK : kend;

  // P = 2^(s scale log2 e - lse), dS = P (dO V^T - D), dQ += dS K
  float acc[kPerWarp][NJ];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int kt = kfirst; kt < kend; kt += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * hd; idx += kThreads) {
      const int c = idx / hd, d = idx - c * hd;
      float kx = 0.f, vx = 0.f;
      if (kt + c < p.Sk) {
        kx = ld(k + (long long)(kt + c) * p.k_ss + d);
        vx = ld(v + (long long)(kt + c) * p.v_ss + d);
      }
      Ks[c * kst + d] = kx;
      Vs[c * kst + d] = vx;
    }
    __syncthreads();
    float s[kPerWarp][X], dp[kPerWarp][X];
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i)
#pragma unroll
      for (int x = 0; x < X; ++x) s[i][x] = dp[i][x] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float kx[X], vx[X];
#pragma unroll
      for (int x = 0; x < X; ++x) {
        kx[x] = Ks[(lane + 32 * x) * kst + d];
        vx[x] = Vs[(lane + 32 * x) * kst + d];
      }
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i) {
        const int r = warp + kWarps * i;
        const float qv = Qs[r * hd + d], gv = Gs[r * hd + d];
#pragma unroll
        for (int x = 0; x < X; ++x) {
          s[i][x] = fmaf(qv, kx[x], s[i][x]);
          dp[i][x] = fmaf(gv, vx[x], dp[i][x]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      float* srow = Ss + (warp + kWarps * i) * BK;
#pragma unroll
      for (int x = 0; x < X; ++x) {
        const int c = kt + lane + 32 * x;
        const bool vis = live[i] && c >= lo[i] && c <= hi[i];
        const float pr = vis ? exp2f(s[i][x] * p.sl2 - lse[i]) : 0.f;
        srow[lane + 32 * x] = vis ? pr * (dp[i][x] - D[i]) : 0.f;
      }
    }
    __syncwarp();
    const int nc = min(BK, p.Sk - kt);
    for (int c = 0; c < nc; ++c) {
      float kk[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = lane + 32 * j;
        kk[j] = d < hd ? Ks[c * kst + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i) {
        const float ds = Ss[(warp + kWarps * i) * BK + c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(ds, kk[j], acc[i][j]);
      }
    }
  }

  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int r = warp + kWarps * i;
    const int g = r / p.bq, qi = r - g * p.bq;
    if (g < p.G && q0 + qi < p.Sq) {
      const long long row = ((long long)b * p.H + kvh * p.G + g) * p.Sq + q0 + qi;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = lane + 32 * j;
        if (d < hd) st(dq + row * hd + d, acc[i][j] * p.scale);
      }
      if (lane == 0) p.dsum[row] = D[i];
    }
  }
}

// --------------------------------------------------------------------------
// CUDA-core route: dK and dV, one block per 64 keys of one kv head
// --------------------------------------------------------------------------

size_t dkdv_smem_bytes(int hd, int bq) {
  return sizeof(float) * (size_t)(2 * kKeys * hd + 2 * bq * (hd | 1) + kKeys * bq + 2 * bq);
}

template <typename T, int NJ, int X>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(const BwdParams p) {
  constexpr int BQ = 32 * X;              // query rows per tile, X per lane
  extern __shared__ float smem[];
  const int hd = p.hd;
  const int kst = hd | 1;
  float* Ks = smem;                       // kKeys x hd (read as warp broadcasts)
  float* Vs = Ks + kKeys * hd;            // kKeys x hd
  float* Qs = Vs + kKeys * hd;            // BQ x kst
  float* Gs = Qs + BQ * kst;              // BQ x kst: dO
  float* Ps = Gs + BQ * kst;              // kKeys x BQ: P, then dS (each warp its own keys)
  float* Ls = Ps + kKeys * BQ;            // BQ: lse
  float* Ds = Ls + BQ;                    // BQ: D
  float* Es = Qs;                         // kWarps x hd, after the band loop: empty rows' dO

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * kKeys, kvh = blockIdx.y, b = blockIdx.z;
  const T* q = static_cast<const T*>(p.q);
  const T* dO = static_cast<const T*>(p.dout);
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  for (int idx = tid; idx < kKeys * hd; idx += kThreads) {
    const int c = idx / hd, d = idx - c * hd;
    float kx = 0.f, vx = 0.f;
    if (k0 + c < p.Sk) {
      kx = ld(k + (long long)(k0 + c) * p.k_ss + d);
      vx = ld(v + (long long)(k0 + c) * p.v_ss + d);
    }
    Ks[idx] = kx;
    Vs[idx] = vx;
  }

  float dk[kPerWarp][NJ], dv[kPerWarp][NJ];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int klast = min(k0 + kKeys, p.Sk) - 1;
  int ibeg, iend;
  row_range(p, k0, klast, ibeg, iend);
  // Far rows first: under a causal mask a key's largest terms come from the
  // rows nearest it (they see the fewest keys), so adding those last keeps
  // the fp32 running sums small while most of the G * rows terms are added.
  const int ntiles = iend > ibeg ? (iend - ibeg + BQ - 1) / BQ : 0;
  for (int t = ntiles - 1; t >= 0; --t) {
    const int it = ibeg + t * BQ;
    for (int g = 0; g < p.G; ++g) {
      const long long h = kvh * p.G + g;
      const T* qh = q + b * p.q_sb + h * p.q_sh;
      const T* gh = dO + b * p.d_sb + h * p.d_sh;
      const long long srow = ((long long)b * p.H + h) * p.Sq;
      __syncthreads();   // K/V staged / the previous tile's reads done
      for (int idx = tid; idx < BQ * hd; idx += kThreads) {
        const int r = idx / hd, d = idx - r * hd;
        float x = 0.f, y = 0.f;
        if (it + r < p.Sq) {
          x = ld(qh + (long long)(it + r) * p.q_ss + d);
          y = ld(gh + (long long)(it + r) * p.d_ss + d);
        }
        Qs[r * kst + d] = x;
        Gs[r * kst + d] = y;
      }
      for (int r = tid; r < BQ; r += kThreads) {
        const bool in = it + r < p.Sq;
        Ls[r] = in ? p.lse[srow + it + r] : 0.f;
        Ds[r] = in ? p.dsum[srow + it + r] : 0.f;
      }
      __syncthreads();

      int lo[X], hi[X];
#pragma unroll
      for (int x = 0; x < X; ++x) {
        const int row = it + lane + 32 * x;
        band(p, p.q_offset + row, lo[x], hi[x]);
        if (row >= p.Sq) hi[x] = -1;        // not a row: sees no key
      }
      float s[kPerWarp][X], dp[kPerWarp][X];
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i)
#pragma unroll
        for (int x = 0; x < X; ++x) s[i][x] = dp[i][x] = 0.f;
      for (int d = 0; d < hd; ++d) {
        float qx[X], gx[X];
#pragma unroll
        for (int x = 0; x < X; ++x) {
          qx[x] = Qs[(lane + 32 * x) * kst + d];
          gx[x] = Gs[(lane + 32 * x) * kst + d];
        }
#pragma unroll
        for (int i = 0; i < kPerWarp; ++i) {
          const int c = warp + kWarps * i;
          const float kv = Ks[c * hd + d], vv = Vs[c * hd + d];
#pragma unroll
          for (int x = 0; x < X; ++x) {
            s[i][x] = fmaf(kv, qx[x], s[i][x]);
            dp[i][x] = fmaf(vv, gx[x], dp[i][x]);
          }
        }
      }
      // P into the warp's rows of Ps; dS kept in s
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i) {
        const int c = warp + kWarps * i, key = k0 + c;
#pragma unroll
        for (int x = 0; x < X; ++x) {
          const int r = lane + 32 * x;
          const bool vis = key <= klast && key >= lo[x] && key <= hi[x];
          const float pr = vis ? exp2f(s[i][x] * p.sl2 - Ls[r]) : 0.f;
          Ps[c * BQ + r] = pr;
          s[i][x] = vis ? pr * (dp[i][x] - Ds[r]) : 0.f;
        }
      }
      __syncwarp();
      const int nr = min(BQ, p.Sq - it);
      for (int r = nr - 1; r >= 0; --r) {     // dV += P^T dO, far rows first
        float gg[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = lane + 32 * j;
          gg[j] = d < hd ? Gs[r * kst + d] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kPerWarp; ++i) {
          const float pr = Ps[(warp + kWarps * i) * BQ + r];
#pragma unroll
          for (int j = 0; j < NJ; ++j) dv[i][j] = fmaf(pr, gg[j], dv[i][j]);
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i)
#pragma unroll
        for (int x = 0; x < X; ++x) Ps[(warp + kWarps * i) * BQ + lane + 32 * x] = s[i][x];
      __syncwarp();
      for (int r = nr - 1; r >= 0; --r) {     // dK += dS^T Q
        float qq[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = lane + 32 * j;
          qq[j] = d < hd ? Qs[r * kst + d] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kPerWarp; ++i) {
          const float ds = Ps[(warp + kWarps * i) * BQ + r];
#pragma unroll
          for (int j = 0; j < NJ; ++j) dk[i][j] = fmaf(ds, qq[j], dk[i][j]);
        }
      }
    }
  }

  int ie0, ie1;
  empty_rows(p, ie0, ie1);
  if (ie0 > 0 || ie1 < p.Sq) {
    float es[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) es[j] = 0.f;
    for (int g = 0; g < p.G; ++g) {
      const T* gh = dO + b * p.d_sb + (long long)(kvh * p.G + g) * p.d_sh;
      for (int part = 0; part < 2; ++part) {      // rows [0, ie0), then [ie1, Sq)
        const int rend = part ? p.Sq : ie0;
        for (int r = (part ? ie1 : 0) + warp; r < rend; r += kWarps) {
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int d = lane + 32 * j;
            if (d < hd) es[j] += ld(gh + (long long)r * p.d_ss + d);
          }
        }
      }
    }
    __syncthreads();   // the band loop's reads of Qs are done
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) Es[warp * hd + d] = es[j];
    }
    __syncthreads();
    const float inv = 1.f / (float)p.Sk;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + 32 * j;
      if (d >= hd) continue;
      float e = 0.f;
      for (int w = 0; w < kWarps; ++w) e += Es[w * hd + d];
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i) dv[i][j] = fmaf(e, inv, dv[i][j]);
    }
  }

  T* dkp = static_cast<T*>(p.dk);
  T* dvp = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int key = k0 + warp + kWarps * i;
    if (key >= p.Sk) continue;
    const long long row = ((long long)b * p.KV + kvh) * p.Sk + key;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) {
        st(dkp + row * hd + d, dk[i][j] * p.scale);
        st(dvp + row * hd + d, dv[i][j]);
      }
    }
  }
}

template <typename T, int NJ, int X>
cudaError_t launch(const BwdParams& p, int B, cudaStream_t stream) {
  static int allowed_dq[kMaxDevices], allowed_dkdv[kMaxDevices];
  const int dq_smem = (int)dq_smem_bytes(p.hd, 32 * X);
  const int dkdv_smem = (int)dkdv_smem_bytes(p.hd, 32 * X);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, NJ, X>, dq_smem, allowed_dq);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dkdv_kernel<T, NJ, X>, dkdv_smem, allowed_dkdv);
  if (err != cudaSuccess) return err;
  const dim3 dq_grid((p.Sq + p.bq - 1) / p.bq, p.KV, B);
  flash_bwd_dq_kernel<T, NJ, X><<<dq_grid, kThreads, dq_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 dkdv_grid((p.Sk + kKeys - 1) / kKeys, p.KV, B);
  flash_bwd_dkdv_kernel<T, NJ, X><<<dkdv_grid, kThreads, dkdv_smem, stream>>>(p);
  return cudaGetLastError();
}

// NJ 32-wide column groups cover hd; X = 2 keys (dq) or rows (dk/dv) per lane
// where shared memory allows two blocks per SM at that width, else 1.
cudaError_t dispatch_f32(const BwdParams& p, int B, cudaStream_t stream) {
  if (p.hd <= 64) return launch<float, 2, 2>(p, B, stream);
  if (p.hd <= 96) return launch<float, 3, 2>(p, B, stream);
  if (p.hd <= 128) return launch<float, 4, 1>(p, B, stream);
  return launch<float, 8, 1>(p, B, stream);
}

// --------------------------------------------------------------------------
// bf16 route at hd <= 128: wgmma on the tensor cores
// --------------------------------------------------------------------------

namespace tc {

constexpr int kThreads = 256;      // two warpgroups
constexpr int kRows = 128;         // dq kernel: packed query rows per block, 64 a warpgroup
constexpr int kBK = 64;            // dq kernel: keys per K/V tile
constexpr int kBQ = 64;            // dk/dv kernel: query rows per Q/dO tile

// Every tile is stored as HDP/64 column blocks of rows x 128 bytes in the
// 128-byte swizzle (hopper.cuh swz), as the forward stores its tiles.
// dq kernel: Q and dO (kRows x HDP each), then a ring of 3 slots of a K and
// a V tile (64 KB + 96 KB at HDP 128). dk/dv kernel of KW x 64 keys: K and V
// (KW x 64 x HDP each), then a ring of slots of a Q and a dO tile (at HDP
// 128, 32 KB + 5 x 32 KB for 64 keys, 64 KB + 4 x 32 KB for 128; 6 slots at
// HDP 64).
template <int HDP>
struct Shape {
  static constexpr int kTileBytes = 64 * HDP * 2;   // one 64-row tile
  static constexpr int kDqStages = 3;
  static constexpr int kDqSmem = 4 * kTileBytes + kDqStages * 2 * kTileBytes + 1024;
  template <int KW>
  static constexpr int kDkdvSlots = HDP <= 64 ? 6 : 6 - KW;
  template <int KW>
  static constexpr int kDkdvSmem = 2 * KW * kTileBytes + kDkdvSlots<KW> * 2 * kTileBytes + 1024;
};

// Rows row0 .. row0 + 63 of head `head` of a (B, N, S, hd) tensor into the
// tile at dst (64 rows) by TMA, one box per 64-column block that reaches
// into hd; the unit zero-fills rows past S and columns past hd.
__device__ __forceinline__ void tma_rows(const CUtensorMap* map, const int* dim, uint32_t dst,
                                         uint32_t bar, int ncb, int rows_stride, int row0,
                                         int head, int b) {
  int c[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    c[j] = (dim[0] == j + 1 ? row0 : 0) + (dim[1] == j + 1 ? head : 0) +
           (dim[2] == j + 1 ? b : 0);
  for (int cb = 0; cb < ncb; ++cb) tma_load(dst + cb * rows_stride * 128, map, bar, cb * 64,
                                            c[0], c[1], c[2]);
}

// dQ and D: 128 packed query rows of one kv head's group, the G heads x bq
// positions. HDK = hd rounded up to 16 (64, 80 or 128): the k-steps of the
// products over hd and the N of dQ's.
template <int HDP, int HDK>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_mma_kernel(const BwdParams p, const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv) {
  using Sh = Shape<HDP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  constexpr int kStages = Sh::kDqStages;
  constexpr int kSlot = 2 * Sh::kTileBytes;
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sO = sQ + 2 * Sh::kTileBytes;       // dO
  const uint32_t sKV = sO + 2 * Sh::kTileBytes;
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ float Ls[kRows], Ds[kRows];
  __shared__ int krange[2];
  const uint32_t sFull = static_cast<uint32_t>(__cvta_generic_to_shared(full));

  // the last rows first: under a causal mask they see the most keys
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * p.bq, kvh = blockIdx.y, b = blockIdx.z;
  const int ncb = (p.hd + 63) / 64;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(sFull + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    krange[0] = INT_MAX;
    krange[1] = -1;
  }

  // Q and dO rows of the block by cp.async, zero past Sq, G and hd
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb;
  const __nv_bfloat16* dO = static_cast<const __nv_bfloat16*>(p.dout) + b * p.d_sb;
  for (int idx = tid; idx < kRows * (HDP / 8); idx += kThreads) {
    const int r = idx / (HDP / 8), c = idx - r * (HDP / 8);
    const int g = r / p.bq, i = r - g * p.bq;
    const bool ok = g < p.G && q0 + i < p.Sq && c * 8 < p.hd;
    const int bytes = ok ? min(16, 2 * (p.hd - c * 8)) : 0;
    const long long h = kvh * p.G + g, row = q0 + i;
    cp_async16(sQ + swz(r, c, kRows), ok ? q + h * p.q_sh + row * p.q_ss + c * 8 : q, bytes);
    cp_async16(sO + swz(r, c, kRows), ok ? dO + h * p.d_sh + row * p.d_ss + c * 8 : dO, bytes);
  }
  cp_async_commit();
  __syncthreads();                     // barriers initialised, krange set

  // each row's lse (+inf where it sees no key: P = 0) and D = rowsum(dO * O),
  // two threads a row
  {
    const int r = tid >> 1, half = tid & 1;
    const int g = r / p.bq, i = r - g * p.bq;
    const bool valid = g < p.G && q0 + i < p.Sq;
    const long long h = kvh * p.G + g, row = q0 + i;
    float acc = 0.f;
    if (valid) {
      const __nv_bfloat16* orow = static_cast<const __nv_bfloat16*>(p.o) + b * p.o_sb +
                                  h * p.o_sh + row * p.o_ss;
      const __nv_bfloat16* grow = dO + h * p.d_sh + row * p.d_ss;
      for (int d = half; d < p.hd; d += 2)
        acc = fmaf(__bfloat162float(grow[d]), __bfloat162float(orow[d]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      int lo, hi;
      band(p, p.q_offset + q0 + i, lo, hi);
      const bool live = valid && lo <= hi;
      const long long srow = ((long long)b * p.H + h) * p.Sq + row;
      Ls[r] = live ? p.lse[srow] : INFINITY;
      Ds[r] = acc;
      if (valid) p.dsum[srow] = acc;
      if (live) {
        atomicMin(&krange[0], lo);
        atomicMax(&krange[1], hi);
      }
    }
  }
  cp_async_wait<0>();
  fence_proxy_async();                 // cp.async writes before wgmma reads
  __syncthreads();

  // the keys of the live rows' bands; a row with no key has no dQ
  const int kstart = krange[0], kend = krange[1] + 1;
  const int kt0 = kstart < kend ? (kstart / kBK) * kBK : 0;
  const int ntiles = kstart < kend ? (kend - kt0 + kBK - 1) / kBK : 0;
  if (tid == 0) {
    for (int s = 0; s < kStages - 1 && s < ntiles; ++s) {
      mbar_expect(sFull + 8 * s, 2 * ncb * Sh::kTileBytes / (HDP / 64));
      tma_rows(&tk, p.kdim, sKV + s * kSlot, sFull + 8 * s, ncb, kBK, kt0 + s * kBK, kvh, b);
      tma_rows(&tv, p.vdim, sKV + s * kSlot + Sh::kTileBytes, sFull + 8 * s, ncb, kBK,
               kt0 + s * kBK, kvh, b);
    }
  }

  // this thread's two rows
  int pos[2];
  float lse[2], D[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wg * 64 + (warp & 3) * 16 + (lane >> 2) + 8 * h;
    pos[h] = p.q_offset + q0 + (r - (r / p.bq) * p.bq);
    lse[h] = Ls[r];
    D[h] = Ds[r];
  }
  const int qmin = p.q_offset + q0;
  const int qmax = p.q_offset + min(q0 + p.bq, p.Sq) - 1;
  const float sl2 = p.sl2;
  const uint64_t dqa = sw128_desc(sQ + wg * 64 * 128, 16, 1024);
  const uint64_t doa = sw128_desc(sO + wg * 64 * 128, 16, 1024);

  float dq[HDK / 2];
#pragma unroll
  for (int i = 0; i < HDK / 2; ++i) dq[i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();                   // slot (t - 1) % kStages is free
    const int nt = t + kStages - 1;
    if (tid == 0 && nt < ntiles) {
      const int slot = nt % kStages;
      mbar_expect(sFull + 8 * slot, 2 * ncb * Sh::kTileBytes / (HDP / 64));
      tma_rows(&tk, p.kdim, sKV + slot * kSlot, sFull + 8 * slot, ncb, kBK,
               kt0 + nt * kBK, kvh, b);
      tma_rows(&tv, p.vdim, sKV + slot * kSlot + Sh::kTileBytes, sFull + 8 * slot, ncb,
               kBK, kt0 + nt * kBK, kvh, b);
    }
    mbar_wait(sFull + 8 * (t % kStages), (t / kStages) & 1);
    const int kt = kt0 + t * kBK;
    const uint32_t sK = sKV + (t % kStages) * kSlot;
    const uint32_t sV = sK + Sh::kTileBytes;

    // S = Q K^T, dP = dO V^T over hd in steps of 16
    float s[kBK / 2], dp[kBK / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] = dp[i] = 0.f;
    const uint64_t dkb = sw128_desc(sK, 16, 1024), dvb = sw128_desc(sV, 16, 1024);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < HDK / 16; ++j) {
      const uint32_t aoff = ((j >> 2) * (kRows * 128) + (j & 3) * 32) >> 4;
      const uint32_t boff = ((j >> 2) * (kBK * 128) + (j & 3) * 32) >> 4;
      SS<kBK>::mma(s, dqa + aoff, dkb + boff);
      SS<kBK>::mma(dp, doa + aoff, dvb + boff);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P = 2^(s sl2 - lse), masked in tiles that reach past Sk or the
    // block's band; dS = P (dP - D), into s
    const bool edge = kt + kBK > p.Sk || (p.causal && kt + kBK - 1 > qmin) ||
                      (p.has_window && kt <= qmax - p.window);
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const int h = (i >> 1) & 1;
      float pr = ex2(fmaf(s[i], sl2, -lse[h]));
      if (edge) {
        const int c = kt + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
        if (c >= p.Sk || masked(p, c, pos[h])) pr = 0.f;
      }
      s[i] = pr * (dp[i] - D[h]);
    }
    uint32_t da[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      da[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      da[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      da[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      da[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // dQ += dS K; K is MN-major here (hd contiguous): 8-key groups 1024
    // bytes apart, 64-column blocks kBK * 128 bytes apart
    const uint64_t dkm = sw128_desc(sK, kBK * 128, 1024);
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) RS<HDK>::mma(dq, da[kk], dkm + ((kk * 16 * 128) >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.dq);
  const bool pairs = p.hd % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wg * 64 + (warp & 3) * 16 + (lane >> 2) + 8 * h;
    const int g = r / p.bq, qi = r - g * p.bq;
    if (g < p.G && q0 + qi < p.Sq) {
      __nv_bfloat16* orow =
          out + (((long long)b * p.H + kvh * p.G + g) * p.Sq + q0 + qi) * p.hd;
#pragma unroll
      for (int n = 0; n < HDK / 8; ++n) {
        const int d = n * 8 + (lane & 3) * 2;
        const float x0 = dq[4 * n + 2 * h] * p.scale, x1 = dq[4 * n + 2 * h + 1] * p.scale;
        if (pairs && d + 1 < p.hd) {
          *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(x0, x1);
        } else {
          if (d < p.hd) orow[d] = __float2bfloat16(x0);
          if (d + 1 < p.hd) orow[d + 1] = __float2bfloat16(x1);
        }
      }
    }
  }
}

// lse (+inf for a row past Sq or whose band is empty: P = 0) and D of query
// row `row` of head h, for the dk/dv kernel's tile of that row
__device__ __forceinline__ void row_stats(const BwdParams& p, int b, int h, int row,
                                          float& lse, float& D) {
  lse = INFINITY;
  D = 0.f;
  if (row < p.Sq) {
    int lo, hi;
    band(p, p.q_offset + row, lo, hi);
    const long long srow = ((long long)b * p.H + h) * p.Sq + row;
    if (lo <= hi) lse = p.lse[srow];
    D = p.dsum[srow];
  }
}

// A warpgroup's accumulator rows (keys key0 and key1 of this thread) times
// `mul` into out (B, KV, Sk, hd) in bf16.
template <int N>
__device__ __forceinline__ void store_keys(__nv_bfloat16* out, const float (&acc)[N], float mul,
                                           const BwdParams& p, int b, int kvh, int key0,
                                           int key1, int lane) {
  const bool pairs = p.hd % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = h ? key1 : key0;
    if (key >= p.Sk) continue;
    const long long row = (((long long)b * p.KV + kvh) * p.Sk + key) * p.hd;
#pragma unroll
    for (int n = 0; n < N / 4; ++n) {
      const int d = n * 8 + (lane & 3) * 2;
      const float x0 = acc[4 * n + 2 * h] * mul, x1 = acc[4 * n + 2 * h + 1] * mul;
      if (pairs && d + 1 < p.hd) {
        *reinterpret_cast<__nv_bfloat162*>(out + row + d) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (d < p.hd) out[row + d] = __float2bfloat16(x0);
        if (d + 1 < p.hd) out[row + d + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// dK and dV: KW x 64 keys of one kv head, over the sequence of 64-row tiles
// (head g, query tile) of the rows whose band reaches them (tile u in ring
// slot u % kSlots; one thread issues the tiles of round r + 1 onwards when
// round r begins, up to kSlots ahead).
//  * KW = 2: 128 keys, 64 a warpgroup; both warpgroups take every tile (one
//    a round), and each writes the dK and dV of its own keys.
//  * KW = 1: 64 keys, both warpgroups on them; they take alternate tiles
//    (round r: tiles 2r and 2r + 1), each summing its own dK and dV; at the
//    end warpgroup 0 adds the other's dK and writes dK, warpgroup 1 the same
//    for dV.
// Blocks run the first keys first: under a causal mask they see the most rows.
template <int HDP, int HDK, int KW>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_mma_kernel(const BwdParams p, const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv) {
  using Sh = Shape<HDP>;
  constexpr int kSlots = Sh::template kDkdvSlots<KW>;
  constexpr int kT = Sh::kTileBytes;
  constexpr int kKeys = 64 * KW;       // keys per block
  constexpr int kTiles = 3 - KW;       // tiles per round
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  const uint32_t sK = raw + pad;
  const uint32_t sV = sK + KW * kT;
  const uint32_t sQO = sV + KW * kT;   // slot s: Q, then dO
  float* scratch = reinterpret_cast<float*>(smem_raw + pad + 2 * KW * kT);
  __shared__ __align__(8) uint64_t full[kSlots + 1];   // the ring, then K/V
  __shared__ float Ls[2][kTiles * kBQ], Ds[2][kTiles * kBQ];   // [round & 1][tile x row]
  const uint32_t sFull = static_cast<uint32_t>(__cvta_generic_to_shared(full));
  const uint32_t sKVbar = sFull + 8 * kSlots;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int kvh = blockIdx.x % p.KV, k0 = (blockIdx.x / p.KV) * kKeys, b = blockIdx.y;
  const int ncb = (p.hd + 63) / 64;
  const int klast = min(k0 + kKeys, p.Sk) - 1;
  int ibeg, iend;
  row_range(p, k0, klast, ibeg, iend);
  const int nqt = iend > ibeg ? (iend - ibeg + kBQ - 1) / kBQ : 0;
  const int ntiles = p.G * nqt;        // tile u: head kvh G + u / nqt, rows from
                                       // ibeg + (u % nqt) kBQ
  const int nrounds = (ntiles + kTiles - 1) / kTiles;
  const int box = ncb * kT / (HDP / 64);   // bytes of a 64-row tile's boxes

  // tile u into its slot (one thread)
  auto issue = [&](int u) {
    const int slot = u % kSlots, h = kvh * p.G + u / nqt, it = ibeg + (u % nqt) * kBQ;
    const uint32_t dst = sQO + slot * 2 * kT;
    mbar_expect(sFull + 8 * slot, 2 * box);
    tma_rows(&tq, p.qdim, dst, sFull + 8 * slot, ncb, kBQ, it, h, b);
    tma_rows(&tdo, p.ddim, dst + kT, sFull + 8 * slot, ncb, kBQ, it, h, b);
  };
  // lse and D of row `tid % 64` of tile kTiles r + tid / 64 (threads below
  // kTiles x 64)
  auto stats = [&](int r, float& l, float& d) {
    const int u = kTiles * r + tid / kBQ;
    l = INFINITY;
    d = 0.f;
    if (u < ntiles) {
      const int g = u / nqt;
      row_stats(p, b, kvh * p.G + g, ibeg + (u - g * nqt) * kBQ + tid % kBQ, l, d);
    }
  };

  if (tid == 0) {
    for (int s = 0; s <= kSlots; ++s) mbar_init(sFull + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const int parts = k0 + 64 < p.Sk ? KW : 1;   // 64-key boxes that start below Sk
    mbar_expect(sKVbar, 2 * parts * box);
    for (int hf = 0; hf < parts; ++hf) {
      tma_rows(&tk, p.kdim, sK + hf * 64 * 128, sKVbar, ncb, kKeys, k0 + hf * 64, kvh, b);
      tma_rows(&tv, p.vdim, sV + hf * 64 * 128, sKVbar, ncb, kKeys, k0 + hf * 64, kvh, b);
    }
    for (int u = 0; u < kSlots && u < ntiles; ++u) issue(u);
  }
  if (tid < kTiles * kBQ) stats(0, Ls[0][tid], Ds[0][tid]);

  // this warpgroup's keys, and this thread's two
  const int kw0 = k0 + (KW == 2 ? wg * 64 : 0), kw1 = min(kw0 + 63, p.Sk - 1);
  int key[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) key[h] = kw0 + (warp & 3) * 16 + (lane >> 2) + 8 * h;
  const float sl2 = p.sl2;
  const uint64_t dka = sw128_desc(sK + (kw0 - k0) * 128, 16, 1024);
  const uint64_t dva = sw128_desc(sV + (kw0 - k0) * 128, 16, 1024);

  float dk[HDK / 2], dv[HDK / 2];
#pragma unroll
  for (int i = 0; i < HDK / 2; ++i) dk[i] = dv[i] = 0.f;
  __syncthreads();                     // barriers initialised, round 0's lse and D in
  mbar_wait(sKVbar, 0);

  for (int r = 0; r < nrounds; ++r) {
    __syncthreads();                   // round r - 1's tiles done: their slots are free;
                                       // lse, D of round r in
    if (tid == 0 && r > 0)
      for (int u = kTiles * r + kSlots - kTiles; u < kTiles * r + kSlots && u < ntiles; ++u)
        issue(u);
    // the next round's lse and D, stored after this round's products
    float nl = 0.f, nd = 0.f;
    const bool next = tid < kTiles * kBQ && r + 1 < nrounds;
    if (next) stats(r + 1, nl, nd);
    const int buf = r & 1, wt = KW == 1 ? wg : 0, u = kTiles * r + wt;

    // does the band reach this warpgroup's keys from its tile's rows, and
    // does it cover all of them (else mask)?
    const int g = u / nqt, it = ibeg + (u - g * nqt) * kBQ;
    const int pmin = p.q_offset + it, pmax = p.q_offset + min(it + kBQ, p.Sq) - 1;
    const bool active = u < ntiles && kw0 < p.Sk && (!p.causal || kw0 <= pmax) &&
                        (!p.has_window || kw1 > pmin - p.window);
    const bool edge = (p.causal && kw1 > pmin) || (p.has_window && kw0 <= pmax - p.window);
    if (u < ntiles) mbar_wait(sFull + 8 * (u % kSlots), (u / kSlots) & 1);
    if (active) {
      const uint32_t sQt = sQO + (u % kSlots) * 2 * kT;
      const uint32_t sOt = sQt + kT;
      const float* L = Ls[buf] + wt * kBQ;
      const float* Dr = Ds[buf] + wt * kBQ;
      // S^T = K Q^T, dP^T = V dO^T over hd in steps of 16
      float s[kBQ / 2], dp[kBQ / 2];
#pragma unroll
      for (int i = 0; i < kBQ / 2; ++i) s[i] = dp[i] = 0.f;
      const uint64_t dqb = sw128_desc(sQt, 16, 1024), dob = sw128_desc(sOt, 16, 1024);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < HDK / 16; ++j) {
        const uint32_t aoff = ((j >> 2) * (kKeys * 128) + (j & 3) * 32) >> 4;
        const uint32_t boff = ((j >> 2) * (kBQ * 128) + (j & 3) * 32) >> 4;
        SS<kBQ>::mma(s, dka + aoff, dqb + boff);
        SS<kBQ>::mma(dp, dva + aoff, dob + boff);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P^T = 2^(s sl2 - lse) and dS^T = P^T (dP^T - D); the columns are
      // the tile's rows
#pragma unroll
      for (int i = 0; i < kBQ / 2; ++i) {
        const int c = (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
        float pr = ex2(fmaf(s[i], sl2, -L[c]));
        if (edge && masked(p, key[(i >> 1) & 1], p.q_offset + it + c)) pr = 0.f;
        s[i] = pr;
        dp[i] = pr * (dp[i] - Dr[c]);
      }
      uint32_t pa[kBQ / 16][4], da[kBQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
          da[kk][e] = pack_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
        }
      }
      // dV += P^T dO, dK += dS^T Q; dO and Q are MN-major here: 8-row
      // groups 1024 bytes apart, 64-column blocks kBQ * 128 bytes apart
      const uint64_t dom = sw128_desc(sOt, kBQ * 128, 1024);
      const uint64_t dqm = sw128_desc(sQt, kBQ * 128, 1024);
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        RS<HDK>::mma(dv, pa[kk], dom + ((kk * 16 * 128) >> 4));
        RS<HDK>::mma(dk, da[kk], dqm + ((kk * 16 * 128) >> 4));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
    }
    if (next) {
      Ls[buf ^ 1][tid] = nl;
      Ds[buf ^ 1][tid] = nd;
    }
  }

  // rows whose band is empty: dV_j += the sum of their dO over the group / Sk
  int ie0, ie1;
  empty_rows(p, ie0, ie1);
  const bool empty = ie0 > 0 || ie1 < p.Sq;
  constexpr int kParts = kThreads / HDP;
  const int d = tid % HDP, grp = tid / HDP;
  float e = 0.f;
  if (empty && d < p.hd) {
    for (int g = 0; g < p.G; ++g) {
      const __nv_bfloat16* gh = static_cast<const __nv_bfloat16*>(p.dout) + b * p.d_sb +
                                (long long)(kvh * p.G + g) * p.d_sh;
      for (int part = 0; part < 2; ++part) {    // rows [0, ie0), then [ie1, Sq)
        const int rend = part ? p.Sq : ie0;
        for (int r = (part ? ie1 : 0) + grp; r < rend; r += kParts)
          e += __bfloat162float(gh[(long long)r * p.d_ss + d]);
      }
    }
  }
  // KW = 1: warpgroup 0 takes warpgroup 1's dK, warpgroup 1 takes warpgroup
  // 0's dV, through the ring's memory. The empty rows' term goes to the
  // warpgroups that write dV.
  const int t = tid & 127;
  const bool writes_dk = KW == 2 || wg == 0, writes_dv = KW == 2 || wg == 1;
  float* xk = scratch;                         // HDK / 2 x 128
  float* xv = scratch + (HDK / 2) * 128;       // HDK / 2 x 128
  float* es = scratch + HDK * 128;             // kParts x HDP
  __syncthreads();                             // every round's reads of the ring are done
  if (KW == 1) {
#pragma unroll
    for (int i = 0; i < HDK / 2; ++i) {
      if (wg) xk[i * 128 + t] = dk[i];
      else xv[i * 128 + t] = dv[i];
    }
  }
  es[grp * HDP + d] = e;
  __syncthreads();
  const float inv = 1.f / (float)p.Sk;
#pragma unroll
  for (int i = 0; i < HDK / 2; ++i) {
    if (KW == 1) {
      if (wg == 0) dk[i] += xk[i * 128 + t];
      else dv[i] += xv[i * 128 + t];
    }
    if (empty && writes_dv) {
      const int col = (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kParts; ++j) sum += es[j * HDP + col];
      dv[i] = fmaf(sum, inv, dv[i]);
    }
  }

  // dK (times scale) and dV of this warpgroup's keys
  if (writes_dk)
    store_keys(static_cast<__nv_bfloat16*>(p.dk), dk, p.scale, p, b, kvh, key[0], key[1], lane);
  if (writes_dv)
    store_keys(static_cast<__nv_bfloat16*>(p.dv), dv, 1.f, p, b, kvh, key[0], key[1], lane);
}

}  // namespace tc

template <int HDP, int HDK, int KW>
cudaError_t launch_dkdv(const BwdParams& p, const CUtensorMap& tq, const CUtensorMap& tdo,
                        const CUtensorMap& tk, const CUtensorMap& tv, int B,
                        cudaStream_t stream) {
  static int allowed[kMaxDevices];
  constexpr int smem = tc::Shape<HDP>::template kDkdvSmem<KW>;
  const cudaError_t err = allow_smem(tc::flash_bwd_dkdv_mma_kernel<HDP, HDK, KW>, smem, allowed);
  if (err != cudaSuccess) return err;
  // key blocks outer, kv heads inner: the first keys of every head first
  const dim3 grid(((p.Sk + 64 * KW - 1) / (64 * KW)) * p.KV, B);
  tc::flash_bwd_dkdv_mma_kernel<HDP, HDK, KW><<<grid, tc::kThreads, smem, stream>>>(
      p, tq, tdo, tk, tv);
  return cudaGetLastError();
}

template <int HDP, int HDK>
cudaError_t launch_mma(const BwdParams& p, const CUtensorMap& tq, const CUtensorMap& tdo,
                       const CUtensorMap& tk, const CUtensorMap& tv, int B, int keys,
                       cudaStream_t stream) {
  static int allowed_dq[kMaxDevices];
  using Sh = tc::Shape<HDP>;
  cudaError_t err =
      allow_smem(tc::flash_bwd_dq_mma_kernel<HDP, HDK>, Sh::kDqSmem, allowed_dq);
  if (err != cudaSuccess) return err;
  const dim3 dq_grid((p.Sq + p.bq - 1) / p.bq, p.KV, B);
  tc::flash_bwd_dq_mma_kernel<HDP, HDK><<<dq_grid, tc::kThreads, Sh::kDqSmem, stream>>>(
      p, tk, tv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (keys == 64) return launch_dkdv<HDP, HDK, 1>(p, tq, tdo, tk, tv, B, stream);
  return launch_dkdv<HDP, HDK, 2>(p, tq, tdo, tk, tv, B, stream);
}

// The tensor-core route: q, k, v and dout must start on 16 bytes and have
// strides of whole 16-byte chunks (the wrapper copies them so where they do
// not); the TMA unit reads hd columns of them and zero-fills the rest.
cudaError_t dispatch_mma(BwdParams& p, int B, int keys, cudaStream_t stream) {
  const bool ok = (uintptr_t)p.q % 16 == 0 && (uintptr_t)p.k % 16 == 0 &&
                  (uintptr_t)p.v % 16 == 0 && (uintptr_t)p.dout % 16 == 0 &&
                  aligned8(p.q_sb, B) && aligned8(p.q_sh, p.H) && aligned8(p.q_ss, p.Sq) &&
                  aligned8(p.d_sb, B) && aligned8(p.d_sh, p.H) && aligned8(p.d_ss, p.Sq) &&
                  aligned8(p.k_sb, B) && aligned8(p.k_sh, p.KV) && aligned8(p.k_ss, p.Sk) &&
                  aligned8(p.v_sb, B) && aligned8(p.v_sh, p.KV) && aligned8(p.v_ss, p.Sk);
  if (!ok) return cudaErrorInvalidValue;
  CUtensorMap tq = {}, tdo = {}, tk = {}, tv = {};
  if (!(encode_rows(&tq, p.q, p.hd, p.Sq, p.H, B, p.q_ss, p.q_sh, p.q_sb, p.qdim, tc::kBQ) &&
        encode_rows(&tdo, p.dout, p.hd, p.Sq, p.H, B, p.d_ss, p.d_sh, p.d_sb, p.ddim,
                    tc::kBQ) &&
        encode_rows(&tk, p.k, p.hd, p.Sk, p.KV, B, p.k_ss, p.k_sh, p.k_sb, p.kdim, 64) &&
        encode_rows(&tv, p.v, p.hd, p.Sk, p.KV, B, p.v_ss, p.v_sh, p.v_sb, p.vdim, 64)))
    return cudaErrorNotSupported;
  p.bq = tc::kRows / p.G;
  if (p.hd <= 64) return launch_mma<64, 64>(p, tq, tdo, tk, tv, B, keys, stream);
  if (p.hd <= 80) return launch_mma<128, 80>(p, tq, tdo, tk, tv, B, keys, stream);
  return launch_mma<128, 128>(p, tq, tdo, tk, tv, B, keys, stream);
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16. route: 0 the CUDA cores, 1 the tensor cores (bf16
// at hd <= 128 only), as the caller's rule (flash_attention.bwd_route)
// chooses it; keys: the tensor-core route's dK/dV block, 64 or 128 (the
// caller's flash_attention.bwd_keys). lse (B,H,Sq) fp32 contiguous, from the forward's training
// entry; dq (B,H,Sq,hd), dk and dv (B,KV,Sk,hd) contiguous, dsum (B,H,Sq)
// fp32 contiguous scratch. Returns a cudaError_t (0 = launched).
int flash_attention_bwd_launch(int dtype, int route, int keys, const void* q, const void* k,
                               const void* v, const void* o, const void* dout, void* dq,
                               void* dk, void* dv, const void* lse, void* dsum, int B, int H,
                               int KV, int Sq, int Sk, int hd, long long q_sb, long long q_sh,
                               long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                               long long v_sb, long long v_sh, long long v_ss,
                               long long o_sb, long long o_sh, long long o_ss,
                               long long d_sb, long long d_sh, long long d_ss, int q_offset,
                               int causal, int has_window, int window, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || hd > 256 || H / KV > kMaxGroup ||
      Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  BwdParams p = {};
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.lse = static_cast<const float*>(lse);
  p.dsum = static_cast<float*>(dsum);
  p.H = H; p.KV = KV; p.G = H / KV; p.Sq = Sq; p.Sk = Sk; p.hd = hd;
  p.bq = kRows / p.G;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.d_sb = d_sb; p.d_sh = d_sh; p.d_ss = d_ss;
  p.q_offset = q_offset; p.causal = causal;
  p.has_window = has_window; p.window = window;
  p.scale = (float)(1.0 / sqrt((double)hd));   // hd ** -0.5, as the forward
  p.sl2 = p.scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1 || hd > 128 || (keys != 64 && keys != 128))
      return (int)cudaErrorInvalidValue;
    return (int)dispatch_mma(p, B, keys, st);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch_f32(p, B, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  return (int)launch<__nv_bfloat16, 8, 1>(p, B, st);
}

}  // extern "C"
