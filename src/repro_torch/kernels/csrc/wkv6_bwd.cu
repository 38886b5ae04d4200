// RWKV6 WKV backward for Hopper (sm_90a), plain CUDA C++, fp32 on the CUDA
// cores.
//
// Replaces no Pallas kernel: the reference takes this gradient by autodiff
// of its scans (repro/models/rwkv6.py::wkv_scan, ::wkv_scan_chunked and
// repro/kernels/ref.py::wkv6_ref). It is the backward of csrc/wkv6.cu's
// recurrence,
//
//   y_t     = (S_t + u ⊙ (k_t ⊗ v_t))ᵀ r_t
//   S_{t+1} = diag(w_t) S_t + k_t ⊗ v_t,
//
// from G_S = ds_n (zero when the caller passes none), for t = S-1 down to 0:
//
//   dr_t[i] = Σ_j S_t[i,j] dy_t[j] + u_i k_t[i] (v_t · dy_t)
//   dk_t[i] = Σ_j G_{t+1}[i,j] v_t[j] + u_i r_t[i] (v_t · dy_t)
//   dv_t[j] = Σ_i G_{t+1}[i,j] k_t[i] + dy_t[j] Σ_i u_i r_t[i] k_t[i]
//   dw_t[i] = Σ_j S_t[i,j] G_{t+1}[i,j]
//   du[i]  += r_t[i] k_t[i] (v_t · dy_t)
//   G_t     = diag(w_t) G_{t+1} + r_t ⊗ dy_t,            ds0 = G_0
//
// (ref.wkv6_bwd_ref). The states S_t come from the training entry's
// checkpoints (csrc/wkv6.cu, wkv6_train_launch: S_{16c}), recomputed forwards
// through each chunk of kT = 16 steps with the forward kernel's arithmetic,
// so they are the forward's states bit for bit. They are never rebuilt
// backwards as (S_{t+1} - k_t v_tᵀ) / w_t: w = exp(-exp(·)) comes
// arbitrarily close to 0.
//
//   r, k, v (B,H,S,hd) fp32 or bf16 (all three alike, upcast in registers);
//   w and dy (B,H,S,hd) fp32; u (H,hd); ckpt (B,H,ceil(S/16),hd,hd) and
//   ds_n (B,H,hd,hd) contiguous fp32. dr, dk, dv in r's type (accumulated in
//   fp32, rounded once), dw fp32, each by strides with its last dimension
//   contiguous (the wrapper allocates them like the inputs, so the model's
//   permuted (B,S,H,hd) views are read and written in place); ds0 (B,H,hd,hd)
//   and du (B,H,hd), the per-(b,h) partials that the wrapper sums over b in a
//   fixed order, contiguous. No atomics: two calls give the same bits.
//
// Design. Column j of S and of G depends only on column j, and every sum
// runs over rows or over columns of one head, so one block takes one
// (b, h) and walks the chunks from the last to the first. Thread (i, g)
// owns row i and the kCols columns g·kCols.. of the state and of G, G in
// registers for the whole call. For each chunk:
//
//   1. r, k, v, w and dy of its 16 steps are staged in shared memory, with
//      v_t · dy_t and Σ_i u_i r_t[i] k_t[i] per step (one warp each);
//   2. its states S_{t0} .. S_{t0+15} are recomputed from the checkpoint
//      into a per-block scratch in device memory (16·HD² fp32, 256 KB at
//      hd 64: 8 MB for rwkv6-1.6b's 32 heads, which stays in L2), laid out
//      so that each thread writes and reads back only its own row slice,
//      coalesced along i;
//   3. the sweep back through the chunk updates G in registers. The sums
//      over columns (dr, dk, dw) are kCols FMAs in registers per row and
//      thread, written as kGroups partials per (step, row) to shared
//      memory; the sum over rows (dv) is a reduce-scatter over the warp's
//      32 rows by shuffles (16 of them a step for 16 columns), written as
//      HD/32 partials per (step, column);
//   4. after the chunk (one barrier), the partials are summed in a fixed
//      order and dr, dk, dv, dw written for its 16 steps.
//
// du is Kahan-summed over the steps by the thread (i, 0) of each row.
//
// Bound on the H100, per (b, h, t): 14·hd² fp32 operations (the state's
// recompute 3·hd², the four sums 2·hd² each, G's update 3·hd²) at 67
// TFLOP/s, or the bytes of r, k, v, w, dy in, dr, dk, dv, dw out, plus
// the checkpoints, at 3.35 TB/s: at rwkv6-1.6b's training shape
// (1,32,4096,64) with bf16 r, k, v, 0.112 ms of operations against about
// 0.10 ms of bytes. With B·H = 32 blocks for 132 SMs and a dependent chain
// of S steps per block, this first version sits far above it (see
// PERF.md); column slices across blocks are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 16;                   // steps per checkpoint and per staged chunk
constexpr int kMaxHd = 128;

template <int HD>
struct Shape {
  static constexpr int kCols = HD <= 64 ? 16 : 32;   // state columns per thread
  static constexpr int kGroups = HD / kCols;         // column groups
  static constexpr int kThreads = HD * kGroups;      // thread (i, g) = g·HD + i
  static constexpr int kRowBlocks = HD / 32;         // warps per column group
  // dynamic shared memory in floats: r, k, v, w, dy [kT][HD]; u [HD]; v·dy
  // and Σ u r k [kT]; the row partials of Σ_j S dy, Σ_j G v and Σ_j S G
  // [kT][kGroups][HD] each; the column partials of Σ_i G k [kT][kRowBlocks][HD]
  static constexpr int kSmemFloats =
      5 * kT * HD + HD + 2 * kT + 3 * kT * kGroups * HD + kT * kRowBlocks * HD;
};

struct BwdParams {
  const void* r;                         // T
  const void* k;                         // T
  const void* v;                         // T
  const float* w;
  const float* u;
  const float* ckpt;
  const float* dy;
  const float* dsn;                      // null: zero
  void* dr;                              // T
  void* dk;                              // T
  void* dv;                              // T
  float* dw;
  float* du;
  float* ds0;
  float* scratch;                        // B·H·kT·HD² fp32
  int H, S, hd;
  long long r_sb, r_sh, r_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long w_sb, w_sh, w_ss, dy_sb, dy_sh, dy_ss;
  long long dr_sb, dr_sh, dr_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  long long dw_sb, dw_sh, dw_ss;
  long long u_sh;
};

__device__ __forceinline__ float ld1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __uint_as_float(
      (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}
__device__ __forceinline__ void st1(float* p, float x) { *p = x; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// One stage of reduce_scatter: the first ACTIVE values of v become ACTIVE/2,
// each the sum over this lane and lane ^ OFF; a lane with bit OFF set keeps
// the upper half.
template <int ACTIVE, int OFF, int N>
__device__ __forceinline__ void rs_stage(float (&v)[N], int lane) {
  const bool hi = (lane & OFF) != 0;
#pragma unroll
  for (int e = 0; e < ACTIVE / 2; ++e) {
    const float send = hi ? v[e] : v[e + ACTIVE / 2];
    const float keep = hi ? v[e + ACTIVE / 2] : v[e];
    v[e] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// Σ over the warp's 32 lanes of v[col], col = lane / (32 / N), in N
// shuffles for N = 16 (8 + 4 + 2 + 1 + 1; lanes 2c and 2c+1 end with
// column c) and 31 for N = 32 (lane c with column c), rather than 5·N.
template <int N>
__device__ __forceinline__ float reduce_scatter(float (&v)[N], int lane) {
  static_assert(N == 16 || N == 32, "16 or 32 values a lane");
  if constexpr (N == 32) rs_stage<32, 16>(v, lane);
  rs_stage<16, N == 32 ? 8 : 16>(v, lane);
  rs_stage<8, N == 32 ? 4 : 8>(v, lane);
  rs_stage<4, N == 32 ? 2 : 4>(v, lane);
  rs_stage<2, N == 32 ? 1 : 2>(v, lane);
  if constexpr (N == 16) v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
  return v[0];
}

// o[0..N) = p[0..N), p in shared memory aligned to 16 bytes
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&o)[N]) {
#pragma unroll
  for (int e = 0; e < N; e += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + e);
    o[e] = q.x; o[e + 1] = q.y; o[e + 2] = q.z; o[e + 3] = q.w;
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(Shape<HD>::kThreads) wkv6_bwd_kernel(const BwdParams p) {
  using Sh = Shape<HD>;
  constexpr int kC = Sh::kCols, kG = Sh::kGroups, kTh = Sh::kThreads, kRB = Sh::kRowBlocks;
  extern __shared__ __align__(16) float smem[];
  float* Rs = smem;                      // [kT][HD]
  float* Ks = Rs + kT * HD;
  float* Vs = Ks + kT * HD;
  float* Ws = Vs + kT * HD;
  float* Ds = Ws + kT * HD;              // dy
  float* Us = Ds + kT * HD;              // [HD]
  float* VDy = Us + HD;                  // [kT] v_t · dy_t
  float* URK = VDy + kT;                 // [kT] Σ_i u_i r_t[i] k_t[i]
  float* Psdy = URK + kT;                // [kT][kG][HD] Σ_j S dy over a group's columns
  float* Pgv = Psdy + kT * kG * HD;      // Σ_j G v
  float* Psg = Pgv + kT * kG * HD;       // Σ_j S G
  float* Pgk = Psg + kT * kG * HD;       // [kT][kRB][HD] Σ_i G k over a warp's rows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = tid / HD, i = tid % HD, rb = i / 32;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int hd = p.hd, S = p.S;
  const long long hd2 = (long long)hd * hd;
  const T* r = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* w = p.w + b * p.w_sb + h * p.w_sh;
  const float* dy = p.dy + b * p.dy_sb + h * p.dy_sh;
  T* dr = static_cast<T*>(p.dr) + b * p.dr_sb + h * p.dr_sh;
  T* dk = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dv = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  float* dw = p.dw + b * p.dw_sb + h * p.dw_sh;
  const int nck = (S + kT - 1) / kT;
  const float* ckpt = p.ckpt + (long long)bh * nck * hd2;
  // [kT][kG][kC][HD]: thread (i, g)'s columns of S_t, adjacent along i
  float* scr = p.scratch + (long long)bh * kT * HD * HD + g * kC * HD + i;

  for (int e = tid; e < HD; e += kTh) Us[e] = e < hd ? __ldg(p.u + h * p.u_sh + e) : 0.f;
  float G[kC];                           // G[i, g·kC + c]: the gradient of the state
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int j = g * kC + c;
    G[c] = (p.dsn != nullptr && i < hd && j < hd) ? __ldg(p.dsn + bh * hd2 + i * hd + j)
                                                  : 0.f;
  }
  float du = 0.f, du_c = 0.f;            // du_i and its Kahan compensation (g == 0)

  for (int c0 = nck - 1; c0 >= 0; --c0) {
    const int t0 = c0 * kT, n = min(kT, S - t0);
    __syncthreads();                     // the previous chunk's last reads are done
    for (int e = tid; e < kT * HD; e += kTh) {
      const int cc = e / HD, d = e % HD;
      const bool in = cc < n && d < hd;
      const long long t = t0 + cc;
      Rs[e] = in ? ld1(r + t * p.r_ss + d) : 0.f;
      Ks[e] = in ? ld1(k + t * p.k_ss + d) : 0.f;
      Vs[e] = in ? ld1(v + t * p.v_ss + d) : 0.f;
      Ws[e] = in ? __ldg(w + t * p.w_ss + d) : 0.f;
      Ds[e] = in ? __ldg(dy + t * p.dy_ss + d) : 0.f;
    }
    float st[kC];                        // S_{t0}[i, g·kC + c], from the checkpoint
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int j = g * kC + c;
      st[c] = (i < hd && j < hd) ? __ldg(ckpt + c0 * hd2 + i * hd + j) : 0.f;
    }
    __syncthreads();                     // the stage is complete
    for (int q = warp; q < 2 * kT; q += kTh / 32) {
      const int cc = q >> 1;
      float s = 0.f;
      for (int d = lane; d < HD; d += 32)
        s += (q & 1) ? Us[d] * Rs[cc * HD + d] * Ks[cc * HD + d]
                     : Vs[cc * HD + d] * Ds[cc * HD + d];
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) ((q & 1) ? URK : VDy)[cc] = s;
    }
    // the chunk's states, as the forward kernel computes them
    for (int cc = 0; cc < n; ++cc) {
      float* out = scr + (long long)cc * HD * HD;
#pragma unroll
      for (int c = 0; c < kC; ++c) out[c * HD] = st[c];
      float vv[kC];
      lds<kC>(Vs + cc * HD + g * kC, vv);
      const float ki = Ks[cc * HD + i], wi = Ws[cc * HD + i];
#pragma unroll
      for (int c = 0; c < kC; ++c) st[c] = fmaf(st[c], wi, ki * vv[c]);
    }
    __syncthreads();                     // VDy and URK are complete
    // S_t of the step being undone; at 16 columns a thread also loads the
    // next step's a step ahead (at 32, hd 128, the registers are short)
    constexpr bool kAhead = kC == 16;
    float ahead[kAhead ? kC : 1];
    if constexpr (kAhead) {
#pragma unroll
      for (int c = 0; c < kC; ++c) ahead[c] = scr[(long long)(n - 1) * HD * HD + c * HD];
    }
    for (int cc = n - 1; cc >= 0; --cc) {
      float s[kC];
      if constexpr (kAhead) {
#pragma unroll
        for (int c = 0; c < kC; ++c) s[c] = ahead[c];
        if (cc > 0) {
#pragma unroll
          for (int c = 0; c < kC; ++c) ahead[c] = scr[(long long)(cc - 1) * HD * HD + c * HD];
        }
      } else {
#pragma unroll
        for (int c = 0; c < kC; ++c) s[c] = scr[(long long)cc * HD * HD + c * HD];
      }
      float dyj[kC], vj[kC], gk[kC];
      lds<kC>(Ds + cc * HD + g * kC, dyj);
      lds<kC>(Vs + cc * HD + g * kC, vj);
      const float ri = Rs[cc * HD + i], ki = Ks[cc * HD + i], wi = Ws[cc * HD + i];
      float sdy = 0.f, gv = 0.f, sg = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        sdy = fmaf(s[c], dyj[c], sdy);
        gv = fmaf(G[c], vj[c], gv);
        sg = fmaf(s[c], G[c], sg);
        gk[c] = G[c] * ki;
        G[c] = fmaf(G[c], wi, ri * dyj[c]);
      }
      Psdy[(cc * kG + g) * HD + i] = sdy;
      Pgv[(cc * kG + g) * HD + i] = gv;
      Psg[(cc * kG + g) * HD + i] = sg;
      const float col = reduce_scatter<kC>(gk, lane);
      if ((lane & (32 / kC - 1)) == 0) Pgk[(cc * kRB + rb) * HD + g * kC + lane / (32 / kC)] = col;
      if (g == 0) {                      // du_i += r_i k_i (v·dy)
        const float y = ri * ki * VDy[cc] - du_c;
        const float t = du + y;
        du_c = (t - du) - y;
        du = t;
      }
    }
    __syncthreads();                     // every partial of the chunk is written
    for (int e = tid; e < n * HD; e += kTh) {
      const int cc = e / HD, d = e % HD;
      if (d >= hd) continue;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int q = 0; q < kG; ++q) {
        a0 += Psdy[(cc * kG + q) * HD + d];
        a1 += Pgv[(cc * kG + q) * HD + d];
        a2 += Psg[(cc * kG + q) * HD + d];
      }
#pragma unroll
      for (int q = 0; q < kRB; ++q) a3 += Pgk[(cc * kRB + q) * HD + d];
      const long long t = t0 + cc;
      const float uvd = Us[d] * VDy[cc];
      st1(dr + t * p.dr_ss + d, fmaf(uvd, Ks[cc * HD + d], a0));
      st1(dk + t * p.dk_ss + d, fmaf(uvd, Rs[cc * HD + d], a1));
      st1(dv + t * p.dv_ss + d, fmaf(URK[cc], Ds[cc * HD + d], a3));
      dw[t * p.dw_ss + d] = a2;
    }
  }

#pragma unroll
  for (int c = 0; c < kC; ++c) {          // ds0 = G_0
    const int j = g * kC + c;
    if (i < hd && j < hd) p.ds0[bh * hd2 + i * hd + j] = G[c];
  }
  if (g == 0 && i < hd) p.du[(long long)bh * hd + i] = du;
}

template <int HD, typename T>
int launch(const BwdParams& p, int B, long long scratch_floats, cudaStream_t st) {
  using Sh = Shape<HD>;
  if (scratch_floats < (long long)B * p.H * kT * HD * HD) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(float) * Sh::kSmemFloats;
  const cudaError_t e = cudaFuncSetAttribute(
      wkv6_bwd_kernel<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  wkv6_bwd_kernel<HD, T><<<(unsigned)B * (unsigned)p.H, Sh::kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const BwdParams& p, int B, long long scratch_floats, cudaStream_t st) {
  if (p.hd <= 32) return launch<32, T>(p, B, scratch_floats, st);
  if (p.hd <= 64) return launch<64, T>(p, B, scratch_floats, st);
  return launch<128, T>(p, B, scratch_floats, st);
}

}  // namespace

extern "C" {

// r, k, v (bf16 if rkv_bf16, else fp32), w, dy and dr, dk, dv (r's type), dw:
// strides of (batch, head, step), the last dimension contiguous; u: of
// head. ckpt (B,H,ceil(S/every),hd,hd), ds_n (null: zero) and ds0
// (B,H,hd,hd), du (B,H,hd) contiguous fp32; scratch holds scratch_floats
// fp32, at least B·H·16·W² for the kernel's width W (32, 64 or 128, the
// smallest that holds hd). Returns a cudaError_t (0 = launched;
// cudaErrorInvalidValue for every other than 16, hd outside 1..kMaxHd, a
// negative size or too small a scratch).
int wkv6_bwd_launch(const void* r, const void* k, const void* v, const float* w,
                    const float* u, const float* ckpt, const float* dy, const float* dsn,
                    void* dr, void* dk, void* dv, float* dw, float* du, float* ds0,
                    float* scratch, long long scratch_floats, int every,
                    int B, int H, int S, int hd, int rkv_bf16,
                    long long r_sb, long long r_sh, long long r_ss,
                    long long k_sb, long long k_sh, long long k_ss,
                    long long v_sb, long long v_sh, long long v_ss,
                    long long w_sb, long long w_sh, long long w_ss,
                    long long dy_sb, long long dy_sh, long long dy_ss,
                    long long dr_sb, long long dr_sh, long long dr_ss,
                    long long dk_sb, long long dk_sh, long long dk_ss,
                    long long dv_sb, long long dv_sh, long long dv_ss,
                    long long dw_sb, long long dw_sh, long long dw_ss,
                    long long u_sh, void* stream) {
  if (every != kT || B <= 0 || H <= 0 || S < 0 || hd <= 0 || hd > kMaxHd)
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.r = r; p.k = k; p.v = v; p.w = w; p.u = u; p.ckpt = ckpt; p.dy = dy; p.dsn = dsn;
  p.dr = dr; p.dk = dk; p.dv = dv; p.dw = dw; p.du = du; p.ds0 = ds0; p.scratch = scratch;
  p.H = H; p.S = S; p.hd = hd;
  p.r_sb = r_sb; p.r_sh = r_sh; p.r_ss = r_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.w_sb = w_sb; p.w_sh = w_sh; p.w_ss = w_ss;
  p.dy_sb = dy_sb; p.dy_sh = dy_sh; p.dy_ss = dy_ss;
  p.dr_sb = dr_sb; p.dr_sh = dr_sh; p.dr_ss = dr_ss;
  p.dk_sb = dk_sb; p.dk_sh = dk_sh; p.dk_ss = dk_ss;
  p.dv_sb = dv_sb; p.dv_sh = dv_sh; p.dv_ss = dv_ss;
  p.dw_sb = dw_sb; p.dw_sh = dw_sh; p.dw_ss = dw_ss;
  p.u_sh = u_sh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rkv_bf16) return launch_hd<__nv_bfloat16>(p, B, scratch_floats, st);
  return launch_hd<float>(p, B, scratch_floats, st);
}

}  // extern "C"
