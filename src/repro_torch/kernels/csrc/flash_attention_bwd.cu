// Backward of the prefix-aware GQA flash attention (csrc/flash_attention.cu)
// for Hopper (sm_90a), plain CUDA C++ on the CUDA cores.
//
// Replaces no Pallas kernel: the JAX package has no backward kernel, because
// its model never calls Pallas; training there differentiates the jnp
// attention of repro/models/common.py (_attend, attention) by autodiff. In
// the port the forward kernel *is* the attention on the card, so its
// gradient needs a kernel of its own (the plain version's autograd is for
// CPU tensors only, and a library's backward is not a port).
//
//   q, o, dout (B,H,Sq,hd); k, v (B,KV,Sk,hd); H % KV == 0, H/KV <= 64,
//   hd <= 256. Inputs come by strides (head dimension contiguous); dq, dk,
//   dv are written contiguous in the inputs' dtype; lse and dsum are fp32
//   (B,H,Sq) scratch that the wrapper allocates.
//
// The function is the gradient of the reference's: s = scale q.k on the
// causal/window band, -1e30 elsewhere, p = softmax over all Sk keys,
// o = p v. With P = exp(s - lse) and D = rowsum(dO * O):
//   dV = P^T dO,  dS = P * (dO V^T - D),  dQ = scale dS K,  dK = scale dS^T Q.
// A row whose band holds no key (a window that ends before the keys begin)
// gets the mean of V over all Sk keys in the forward, so its gradient is
// dV_j += dO / Sk for every key j, no dQ and no dK; the masked scores of a
// row that sees a key weigh exactly 0.
//
// One entry, flash_attention_bwd_launch, two launches on the caller's stream:
//  * flash_bwd_dq_kernel: one block per 64 packed query rows (the G heads
//    that share a kv head times 64/G positions, as the forward packs them),
//    so each K/V tile is read once for the group. A first pass over the
//    keys of the rows' bands takes each row's max and sum (the logsumexp);
//    D comes from O and dO. A second pass recomputes P, forms dS and
//    accumulates dQ. It writes lse and D to the scratch.
//  * flash_bwd_dkdv_kernel: one block per 64 keys of one kv head. It loops
//    over the G query heads of the group and over the query rows whose band
//    reaches its keys, recomputes P and dS from the scratch and accumulates
//    dV and dK; the empty-band rows' dO sum is added to every key's dV.
//    GQA's sum over the group happens inside the block: no atomics, so two
//    runs give the same bits.
// The backward recomputes the logsumexp rather than having the forward save
// it: saving it would change flash_mma_kernel, the serving kernel. That
// costs one more Q K^T pass.
//
// Bound on the H100: five products of 2*hd flops per visible (query, key)
// pair (Q K^T, dO V^T, P^T dO, dS^T Q, dS K) against the forward's two, so
// at the training shapes (h2o-danube-1.8b: 32 heads of 80 on 8 kv heads,
// 8,192 tokens, window 4,096) operations bound it: 989 TFLOP/s for bf16 on
// the tensor cores, 67 TFLOP/s of fp32 FMA. This first kernel does all
// arithmetic in fp32 on the CUDA cores for both dtypes (bf16 inputs are read
// as bf16 and widened in shared memory) and does eight products, not five
// (S three times, dO V^T twice): it is right first, and wgmma and TMA are
// for a later change. Each warp owns 8 rows (dq) or 8 keys (dk/dv) of the
// block; a lane owns X keys (dq) or X query rows (dk/dv) of a tile and
// NJ 32-wide column groups of the head dimension, so the products read
// shared memory as warp broadcasts and conflict-free columns (odd row
// strides).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;      // the reference's mask value
constexpr int kMaxGroup = 64;          // query heads per kv head
constexpr int kMaxDevices = 64;
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
  float* lse;      // (B, H, Sq) contiguous
  float* dsum;     // (B, H, Sq) contiguous: D = rowsum(dO * O)
  int H, KV, G, Sq, Sk, hd, bq;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long d_sb, d_sh, d_ss;
  int q_offset, causal, has_window, window;
  float scale;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

// The keys [lo, hi] that the query at absolute position pos sees; lo > hi
// for a row whose band is empty. As the forward and the reference: causal
// keeps keys <= pos, a window keeps keys > pos - window.
__device__ __forceinline__ void band(const BwdParams& p, int pos, int& lo, int& hi) {
  lo = p.has_window ? max(0, pos - p.window + 1) : 0;
  hi = p.causal ? min(p.Sk - 1, pos) : p.Sk - 1;
}

__device__ __forceinline__ int clamp_rows(long long x, int Sq) {
  return (int)(x < 0 ? 0 : (x > Sq ? Sq : x));
}

// --------------------------------------------------------------------------
// dQ, lse and D: one block per 64 packed query rows of one kv head's group
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
  float D[kPerWarp];
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
    if (valid) {
      const long long h = kvh * p.G + g, row = q0 + qi;
      const T* orow = o + b * p.o_sb + h * p.o_sh + row * p.o_ss;
      for (int d = lane; d < hd; d += 32) acc = fmaf(Gs[r * hd + d], ld(orow + d), acc);
    }
    D[i] = warp_sum(acc);
  }
  __syncthreads();
  // the keys of the live rows' bands (none if no row is live); an empty row
  // has no dQ, and its dV share is the dk/dv kernel's
  const int kstart = krange[0], kend = krange[1] + 1;
  const int kfirst = kstart < kend ? (kstart / BK) * BK : kend;

  // pass 1: each row's max and sum over its keys, as the forward takes them
  float m[kPerWarp], l[kPerWarp];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  for (int kt = kfirst; kt < kend; kt += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * hd; idx += kThreads) {
      const int c = idx / hd, d = idx - c * hd;
      Ks[c * kst + d] = kt + c < p.Sk ? ld(k + (long long)(kt + c) * p.k_ss + d) : 0.f;
    }
    __syncthreads();
    float s[kPerWarp][X];
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i)
#pragma unroll
      for (int x = 0; x < X; ++x) s[i][x] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float kx[X];
#pragma unroll
      for (int x = 0; x < X; ++x) kx[x] = Ks[(lane + 32 * x) * kst + d];
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i) {
        const float qv = Qs[(warp + kWarps * i) * hd + d];
#pragma unroll
        for (int x = 0; x < X; ++x) s[i][x] = fmaf(qv, kx[x], s[i][x]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int x = 0; x < X; ++x) {
        const int c = kt + lane + 32 * x;
        float val;
        if (c >= p.Sk)
          val = -INFINITY;                  // ragged tail: not a key at all
        else if (!live[i] || c < lo[i] || c > hi[i])
          val = kNegInf;
        else
          val = s[i][x] * p.scale;
        s[i][x] = val;
        mx = fmaxf(mx, val);
      }
      const float m_new = fmaxf(m[i], warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int x = 0; x < X; ++x) sum += expf(s[i][x] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + warp_sum(sum);
      m[i] = m_new;
    }
  }
  float lse[kPerWarp];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) lse[i] = live[i] ? m[i] + logf(l[i]) : 0.f;

  // pass 2: P, dS = P (dO V^T - D), dQ += dS K
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
        const float pr = vis ? expf(s[i][x] * p.scale - lse[i]) : 0.f;
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
      if (lane == 0) {
        p.lse[row] = lse[i];
        p.dsum[row] = D[i];
      }
    }
  }
}

// --------------------------------------------------------------------------
// dK and dV: one block per 64 keys of one kv head
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

  // query rows whose band can reach keys k0..klast: causal needs pos >= k0,
  // a window pos <= klast + window - 1
  const int klast = min(k0 + kKeys, p.Sk) - 1;
  const int ibeg = p.causal ? clamp_rows((long long)k0 - p.q_offset, p.Sq) : 0;
  const int iend = p.has_window
                       ? clamp_rows((long long)klast + p.window - p.q_offset, p.Sq)
                       : p.Sq;
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
          const float pr = vis ? expf(s[i][x] * p.scale - Ls[r]) : 0.f;
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

  // Rows whose band is empty weigh every key 1/Sk: dV_j += sum(dO) / Sk. They
  // are the positions below e0 (causal: pos < 0; with a window <= 0, all) and
  // from e1 = Sk + window - 1 on (a window that ends before the keys begin).
  const long long e0 = p.causal ? ((p.has_window && p.window <= 0) ? LLONG_MAX / 2 : 0)
                                : LLONG_MIN / 2;
  const long long e1 = p.has_window ? (long long)p.Sk + p.window - 1 : LLONG_MAX / 2;
  const int ie0 = clamp_rows(e0 - p.q_offset, p.Sq);
  const int ie1 = max(ie0, clamp_rows(e1 - p.q_offset, p.Sq));
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
template <typename T>
cudaError_t dispatch(const BwdParams& p, int B, cudaStream_t stream) {
  if (p.hd <= 64) return launch<T, 2, 2>(p, B, stream);
  if (p.hd <= 96) return launch<T, 3, 2>(p, B, stream);
  if (p.hd <= 128) return launch<T, 4, 1>(p, B, stream);
  return launch<T, 8, 1>(p, B, stream);
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16. dq (B,H,Sq,hd), dk and dv (B,KV,Sk,hd) contiguous,
// lse and dsum (B,H,Sq) fp32 contiguous. Returns a cudaError_t (0 = launched).
int flash_attention_bwd_launch(int dtype, const void* q, const void* k, const void* v,
                               const void* o, const void* dout, void* dq, void* dk, void* dv,
                               void* lse, void* dsum, int B, int H, int KV, int Sq, int Sk,
                               int hd, long long q_sb, long long q_sh, long long q_ss,
                               long long k_sb, long long k_sh, long long k_ss,
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
  p.lse = static_cast<float*>(lse);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(p, B, st);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(p, B, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
