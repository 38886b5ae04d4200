// RWKV6 WKV backward for Hopper (sm_90a), plain CUDA C++, fp32 on the CUDA
// cores: each (batch, head) cut into slices of rows, one block each.
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
//   fixed order, contiguous; dvp, a scratch of dv's partial sums. No
//   atomics: two calls give the same bits.
//
// Bound on the H100, per (b, h, t): 14·hd² fp32 operations (the state's
// recompute 3·hd², the four sums 2·hd² each, G's update 3·hd²) at 67
// TFLOP/s, or the bytes of r, k, v, w, dy in, dr, dk, dv, dw out, plus the
// checkpoints, at 3.35 TB/s: at rwkv6-1.6b's training shape (1,32,4096,64)
// with bf16 r, k, v, 0.112 ms of operations against about 0.10 ms of bytes.
// The recurrence is the obstacle: each (b, h) is a chain of S steps, and
// B·H is 32 at that shape, a quarter of the card's 132 SMs.
//
// Design. Every element of S and of G evolves on its own (S_{t+1}[i,j] =
// w_t[i] S_t[i,j] + k_t[i] v_t[j], G_t[i,j] = w_t[i] G_{t+1}[i,j] + r_t[i]
// dy_t[j]), so each (b, h) is cut into P slices of kRows = 16 rows (8 at
// the 128-wide kernel), one block each: 128 blocks at the training shape.
// A block owns its rows' sums (dr, dk, dw) outright; dv, a sum over rows,
// leaves each block as a partial in the scratch dvp, and a second launch,
// wkv6_bwd_dv_kernel, adds the P partials in order. The blocks never wait
// for each other. (A thread-block cluster per head that exchanges the row
// sums through distributed shared memory was tried first: an H100 holds
// only 30 clusters of 4 one-SM blocks at once, so rwkv6-1.6b's 32 heads ran
// in two waves.) A block has kRows × kParts compute threads, thread (i, p)
// = row i and kCols = 4 (8 at W = 128) columns kCols·p.., the row's kParts
// = W / kCols lanes adjacent, and three helper warps. Each block walks the
// chunks from the last to the first; iteration c sweeps chunk c while the
// helpers load chunk c - 1, take chunk c's per-step scalars and write
// chunk c + 1 out, one barrier an iteration:
//
//   1. loads: r, k, v, w, dy of the chunk's 16 steps (every column: the
//      per-step scalars v_t · dy_t and Σ u r k need them) and the
//      checkpoint's rows, by cp.async into one of three stages (hd = W and
//      16-byte aligned rows, as the model's views are; other shapes stage
//      element by element);
//   2. compute: the thread recomputes its 16 × kCols states into registers
//      from the checkpoint (no scratch for them), then sweeps back through
//      the chunk with G's columns in registers, one FMA per element a step
//      on the chain, a whole chunk without a test per step so the steps'
//      instructions interleave. The row sums hang off the chain: in
//      registers over the thread's columns, then over the row's lanes by
//      one reduce-scatter for four steps at a time; dv's column sums over
//      the warp's rows by shuffles, into shared memory per warp;
//   3. dots and du: v_t · dy_t and Σ u r k, eight at a time by one
//      reduce-scatter; du Kahan-summed over the steps, last first;
//   4. outputs: dr, dk, dw of the block's rows, and its dv partial summed
//      over the compute warps in order (block 0 adds dy Σ u r k).
//
// Each block writes its rows of ds0 and reads its rows of ds_n. What bounds
// it: per step a compute warp loads its lanes' dy and v columns and the
// rows' r, k, w from shared memory and shuffles for the reduce-scatters,
// and the helpers add their copies and sums, so the SM's shared-memory
// pipe, not the FMAs, sets the pace (phase clocks show every warp of a
// block slowed alike); the dv partials cost the second launch
// 4·(P + 1)·B·H·S·hd bytes more than the bound counts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 16;                   // steps per checkpoint and per chunk
constexpr int kMaxHd = 128;

template <int HD, typename T>
struct Shape {
  static constexpr int kRows = HD == 128 ? 8 : 16;  // state rows per block
  static constexpr int kP = HD / kRows;             // blocks per (b, h): 2, 4, 16
  static constexpr int kCols = HD == 128 ? 8 : 4;   // state columns per thread
  static constexpr int kParts = HD / kCols;         // lanes per row: 8 or 16
  static constexpr int kCompute = kRows * kParts;   // thread (i, p) = kParts·i + p
  static constexpr int kWarps = kCompute / 32;      // compute warps, then three helpers:
  static constexpr int kThreads = kCompute + 3 * 32;  // loads; dots and du; outputs
  // one stage, bytes: r, k, v [kT][HD] T; w, dy [kT][HD] fp32; the
  // checkpoint's rows [kRows][HD] fp32. Three: the chunk being swept, the
  // next one loading, the last one being written out.
  static constexpr int kStageBytes = 3 * kT * HD * (int)sizeof(T) + 2 * kT * HD * 4 +
                                     kRows * HD * 4;
  // per chunk parity, floats: v·dy and Σ u r k [kT]; the row sums
  // [3][kT][kRows]; the dv partials [kWarps][kT][HD]
  static constexpr int kBufFloats = 2 * kT + 3 * kT * kRows + kWarps * kT * HD;
  static constexpr int kSmemBytes = 3 * kStageBytes + 4 * (HD + 2 * kBufFloats);
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
  float* dvp;                            // dv partials [B·H][P][S][hd]
  long long dvp_floats;
  int H, S, hd;
  long long r_sb, r_sh, r_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long w_sb, w_sh, w_ss, dy_sb, dy_sh, dy_ss;
  long long dr_sb, dr_sh, dr_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  long long dw_sb, dw_sh, dw_ss;
  long long u_sh;
};

__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(__nv_bfloat16 x) {
  return __uint_as_float((unsigned)__bfloat16_as_ushort(x) << 16);
}
__device__ __forceinline__ void st1(float* p, float x) { *p = x; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ float ldg1(const float* p) { return __ldg(p); }
__device__ __forceinline__ __nv_bfloat16 ldg1(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// o[0..N) = p[0..N) as fp32, N = 4 or 8, p in shared memory aligned to 4·N
// bytes (fp32) or 2·N (bf16)
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&o)[N]) {
#pragma unroll
  for (int e = 0; e < N; e += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + e);
    o[e] = a.x; o[e + 1] = a.y; o[e + 2] = a.z; o[e + 3] = a.w;
  }
}
template <int N>
__device__ __forceinline__ void lds(const __nv_bfloat16* p, float (&o)[N]) {
  unsigned q[N / 2];
  if constexpr (N == 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    q[0] = a.x; q[1] = a.y; q[2] = a.z; q[3] = a.w;
  } else {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    q[0] = a.x; q[1] = a.y;
  }
#pragma unroll
  for (int e = 0; e < N / 2; ++e) {
    o[2 * e] = __uint_as_float(q[e] << 16);
    o[2 * e + 1] = __uint_as_float(q[e] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
// no "memory" clobber on the copies: nothing reads their buffer before the
// wait and the barrier after it
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One stage of a reduce-scatter: the first ACTIVE values of v become
// ACTIVE/2, each the sum over this lane and lane ^ OFF; a lane with bit OFF
// set keeps the upper half.
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

// The shared memory of one stage (chunk): r, k, v, w, dy of its steps and
// the checkpoint's rows of the block.
template <int HD, typename T>
struct Stage {
  T* r;                                  // [kT][HD]
  T* k;
  T* v;
  float* w;                              // [kT][HD]
  float* dy;
  float* ck;                             // [kRows][HD]
  __device__ Stage(unsigned char* base) {
    r = reinterpret_cast<T*>(base);
    k = r + kT * HD;
    v = k + kT * HD;
    w = reinterpret_cast<float*>(v + kT * HD);
    dy = w + kT * HD;
    ck = dy + kT * HD;
  }
};

// The loading warp copies chunk c (steps t0 .. t0+n-1) into stage s: by
// cp.async in 16-byte granules (ASYNC: hd = HD, every row 16-byte aligned),
// else element by element with zeros past hd.
template <int HD, typename T, bool ASYNC>
__device__ __forceinline__ void stage_chunk(const BwdParams& p, const T* r, const T* k,
                                            const T* v, const float* w, const float* dy,
                                            const float* ckpt, int c, int row0,
                                            const Stage<HD, T>& s, int lane) {
  constexpr int kRows = Shape<HD, T>::kRows;
  const int t0 = c * kT, n = min(kT, p.S - t0), hd = p.hd;
  const long long hd2 = (long long)hd * hd;
  const float* ck = ckpt + c * hd2;
  if constexpr (ASYNC) {
    constexpr int kGT = 16 / (int)sizeof(T), kRowT = HD / kGT, kRowF = HD / 4;
    for (int e = lane; e < kT * kRowT; e += 32) {
      const int cc = e / kRowT, g = e % kRowT;
      if (cc >= n) break;
      const long long t = t0 + cc;
      cp_async16(smem_u32(s.r + cc * HD + g * kGT), r + t * p.r_ss + g * kGT);
      cp_async16(smem_u32(s.k + cc * HD + g * kGT), k + t * p.k_ss + g * kGT);
      cp_async16(smem_u32(s.v + cc * HD + g * kGT), v + t * p.v_ss + g * kGT);
    }
    for (int e = lane; e < kT * kRowF; e += 32) {
      const int cc = e / kRowF, g = e % kRowF;
      if (cc >= n) break;
      const long long t = t0 + cc;
      cp_async16(smem_u32(s.w + cc * HD + g * 4), w + t * p.w_ss + g * 4);
      cp_async16(smem_u32(s.dy + cc * HD + g * 4), dy + t * p.dy_ss + g * 4);
    }
    for (int e = lane; e < kRows * kRowF; e += 32)     // the block's rows, contiguous
      cp_async16(smem_u32(s.ck + e * 4), ck + row0 * hd + e * 4);
    cp_async_commit();
  } else {
    for (int e = lane; e < kT * HD; e += 32) {
      const int cc = e / HD, d = e % HD;
      const bool in = cc < n && d < hd;
      const long long t = t0 + cc;
      s.r[e] = in ? ldg1(r + t * p.r_ss + d) : T(0.f);
      s.k[e] = in ? ldg1(k + t * p.k_ss + d) : T(0.f);
      s.v[e] = in ? ldg1(v + t * p.v_ss + d) : T(0.f);
      s.w[e] = in ? __ldg(w + t * p.w_ss + d) : 0.f;
      s.dy[e] = in ? __ldg(dy + t * p.dy_ss + d) : 0.f;
    }
    for (int e = lane; e < kRows * HD; e += 32) {
      const int i = row0 + e / HD, j = e % HD;
      s.ck[e] = (i < hd && j < hd) ? __ldg(ck + i * hd + j) : 0.f;
    }
  }
}

// The dots warp's work on a chunk: v_t · dy_t (dot 2t) and Σ u r k (dot 2t
// + 1), eight dots at a time: a lane sums its columns of each, a
// reduce-scatter adds the lanes (lanes 0 .. 7 end with dot
// 4·bit0 + 2·bit1 + bit2 of the lane).
template <int HD, typename T>
__device__ __forceinline__ void chunk_dots(const Stage<HD, T>& s, int lane, const float* Us,
                                           float* VDy, float* URK) {
#pragma unroll
  for (int g8 = 0; g8 < 2 * kT / 8; ++g8) {
    float a[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int cc = (g8 * 8 + c) >> 1;
      float x = 0.f;
#pragma unroll
      for (int d = lane; d < HD; d += 32)
        x += (c & 1) ? Us[d] * f32(s.r[cc * HD + d]) * f32(s.k[cc * HD + d])
                     : f32(s.v[cc * HD + d]) * s.dy[cc * HD + d];
      a[c] = x;
    }
    rs_stage<8, 1>(a, lane);
    rs_stage<4, 2>(a, lane);
    rs_stage<2, 4>(a, lane);
    a[0] += __shfl_xor_sync(0xffffffffu, a[0], 8);
    a[0] += __shfl_xor_sync(0xffffffffu, a[0], 16);
    if (lane < 8) {
      const int c = 4 * (lane & 1) + 2 * ((lane >> 1) & 1) + ((lane >> 2) & 1);
      ((c & 1) ? URK : VDy)[(g8 * 8 + c) >> 1] = a[0];
    }
  }
}

// One chunk of a compute thread (row i of the block, columns j .. j + kCols
// - 1): its kT × kCols states recomputed from the checkpoint's row in
// registers, then the sweep from the chunk's last step back to its first:
// G's columns updated on the chain; the row sums over the row's kParts lanes
// into Rows (one lane per sum); dv's partial sums over the warp's rows into
// DvP. FULL: n = kT, no test per step.
template <int HD, typename T, bool FULL>
__device__ __forceinline__ void sweep_chunk(const Stage<HD, T>& s, int n, int il, int i,
                                            int j, int lane, int warp,
                                            float (&G)[Shape<HD, T>::kCols], float* Rows,
                                            float* DvP) {
  using Sh = Shape<HD, T>;
  constexpr int kC = Sh::kCols, kParts = Sh::kParts, kRows = Sh::kRows;
  float St[kT][kC];
  lds<kC>(s.ck + il * HD + j, St[0]);
#pragma unroll
  for (int cc = 1; cc < kT; ++cc) {
    if (FULL || cc < n) {
      float vv[kC];
      lds<kC>(s.v + (cc - 1) * HD + j, vv);
      const float ki = f32(s.k[(cc - 1) * HD + i]), wi = s.w[(cc - 1) * HD + i];
#pragma unroll
      for (int c = 0; c < kC; ++c) St[cc][c] = fmaf(St[cc - 1][c], wi, ki * vv[c]);
    }
  }
  // the row sums of four steps at a time: slot 3·(cc % 4) + q holds sum q
  // (Σ S dy, Σ G v, Σ S G) of step cc over the thread's columns
  float rows[16];
#pragma unroll
  for (int cc = kT - 1; cc >= 0; --cc) {
    if (cc % 4 == 3) {
#pragma unroll
      for (int e = 0; e < 16; ++e) rows[e] = 0.f;
    }
    if (FULL || cc < n) {
      float dyj[kC], vj[kC], gk[kC];
      lds<kC>(s.dy + cc * HD + j, dyj);
      lds<kC>(s.v + cc * HD + j, vj);
      const float ri = f32(s.r[cc * HD + i]), ki = f32(s.k[cc * HD + i]);
      const float wi = s.w[cc * HD + i];
      const int o = 3 * (cc % 4);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        rows[o] = fmaf(St[cc][c], dyj[c], rows[o]);
        rows[o + 1] = fmaf(G[c], vj[c], rows[o + 1]);
        rows[o + 2] = fmaf(St[cc][c], G[c], rows[o + 2]);
        gk[c] = G[c] * ki;
        G[c] = fmaf(G[c], wi, ri * dyj[c]);
      }
      // dv: the sums over the warp's rows (the lane bits from kParts up)
      if constexpr (kParts == 16) {             // two rows a warp
        rs_stage<kC, 16>(gk, lane);
        constexpr int kH = kC / 2;
        float* out = DvP + (warp * kT + cc) * HD + j + kH * (lane >> 4);
        if constexpr (kH == 2) {
          *reinterpret_cast<float2*>(out) = make_float2(gk[0], gk[1]);
        } else {
          *reinterpret_cast<float4*>(out) = make_float4(gk[0], gk[1], gk[2], gk[3]);
        }
      } else {                                  // four rows a warp, four columns
        rs_stage<4, 8>(gk, lane);
        rs_stage<2, 16>(gk, lane);
        DvP[(warp * kT + cc) * HD + j + 2 * ((lane >> 3) & 1) + ((lane >> 4) & 1)] = gk[0];
      }
    }
    if (cc % 4 == 0) {
      // the row's kParts lanes add the four steps' sums: a reduce-scatter of
      // the 16 slots over them, so the lane ends with 16 / kParts of them,
      // slots 8·bit0 + 4·bit1 + 2·bit2 (+ bit3 at kParts 16) onwards
      rs_stage<16, 1>(rows, lane);
      rs_stage<8, 2>(rows, lane);
      rs_stage<4, 4>(rows, lane);
      if constexpr (kParts == 16) rs_stage<2, 8>(rows, lane);
      constexpr int kKeep = 16 / kParts;
      const int first = 8 * (lane & 1) + 4 * ((lane >> 1) & 1) + 2 * ((lane >> 2) & 1) +
                        (kParts == 16 ? (lane >> 3) & 1 : 0);
#pragma unroll
      for (int e = 0; e < kKeep; ++e) {
        const int slot = first + e, step = cc + slot / 3;
        if (slot < 12 && (FULL || step < n))
          Rows[((slot % 3) * kT + step) * kRows + il] = rows[e];
      }
    }
  }
}

// The output warp's work on chunk c: dr, dk, dw of the block's rows, and
// dv's partial over them (the compute warps' partials in order; block 0 adds
// dy Σ u r k), which wkv6_bwd_dv_kernel sums over the P blocks.
template <int HD, typename T>
__device__ __forceinline__ void write_chunk(const BwdParams& p, const Stage<HD, T>& s,
                                            const float* Us, const float* buf, int c,
                                            int q, int row0, T* dr, T* dk, float* dw,
                                            float* dvp, int lane) {
  using Sh = Shape<HD, T>;
  constexpr int kRows = Sh::kRows;
  const float* VDy = buf;
  const float* URK = VDy + kT;
  const float* Rows = URK + kT;
  const float* DvP = Rows + 3 * kT * kRows;
  const int t0 = c * kT, n = min(kT, p.S - t0), hd = p.hd;
  for (int e = lane; e < n * kRows; e += 32) {
    const int cc = e / kRows, ii = e % kRows, gi = row0 + ii;
    if (gi >= hd) continue;
    const long long t = t0 + cc;
    const float uvd = Us[gi] * VDy[cc];
    st1(dr + t * p.dr_ss + gi, fmaf(uvd, f32(s.k[cc * HD + gi]), Rows[cc * kRows + ii]));
    st1(dk + t * p.dk_ss + gi, fmaf(uvd, f32(s.r[cc * HD + gi]), Rows[(kT + cc) * kRows + ii]));
    dw[t * p.dw_ss + gi] = Rows[(2 * kT + cc) * kRows + ii];
  }
  if (hd % 4 == 0) {                     // four columns a lane
    for (int e = lane; e < n * HD / 4; e += 32) {
      const int cc = e / (HD / 4), jj = 4 * (e % (HD / 4));
      if (jj >= hd) continue;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q == 0) {
        const float4 d = *reinterpret_cast<const float4*>(s.dy + cc * HD + jj);
        a = make_float4(URK[cc] * d.x, URK[cc] * d.y, URK[cc] * d.z, URK[cc] * d.w);
      }
#pragma unroll
      for (int wp = 0; wp < Sh::kWarps; ++wp) {
        const float4 x = *reinterpret_cast<const float4*>(DvP + (wp * kT + cc) * HD + jj);
        a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      }
      *reinterpret_cast<float4*>(dvp + (long long)(t0 + cc) * hd + jj) = a;
    }
  } else {
    for (int e = lane; e < n * HD; e += 32) {
      const int cc = e / HD, jj = e % HD;
      if (jj >= hd) continue;
      float a = q == 0 ? URK[cc] * s.dy[cc * HD + jj] : 0.f;
#pragma unroll
      for (int wp = 0; wp < Sh::kWarps; ++wp) a += DvP[(wp * kT + cc) * HD + jj];
      dvp[(long long)(t0 + cc) * hd + jj] = a;
    }
  }
}

template <int HD, typename T, bool ASYNC>
__global__ void __launch_bounds__(Shape<HD, T>::kThreads, 1)
wkv6_bwd_kernel(const BwdParams p) {
  using Sh = Shape<HD, T>;
  constexpr int kP = Sh::kP, kC = Sh::kCols, kParts = Sh::kParts, kRows = Sh::kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Us = reinterpret_cast<float*>(smem + 3 * Sh::kStageBytes);   // [HD]
  // the per-parity buffers: VDy [kT] v_t · dy_t, URK [kT] Σ_i u_i r_t[i]
  // k_t[i], Rows [3][kT][kRows] Σ_j S dy, Σ_j G v, Σ_j S G, DvP
  // [kWarps][kT][HD] Σ_i G k over a warp's rows
  auto buf = [&](int c) { return Us + HD + (c & 1) * Sh::kBufFloats; };
  auto stage = [&](int c) { return Stage<HD, T>(smem + (c % 3) * Sh::kStageBytes); };

  const int tid = threadIdx.x, lane = tid & 31;
  const int role = tid / 32 - Sh::kWarps;   // < 0 compute; 0 loads, 1 dots and du, 2 outputs
  const int il = tid / kParts, part = tid % kParts;   // compute threads
  const int q = blockIdx.x % kP, bh = blockIdx.x / kP, b = bh / p.H, h = bh % p.H;
  const int row0 = q * kRows, i = row0 + il, j = part * kC;
  const int hd = p.hd, S = p.S;
  const long long hd2 = (long long)hd * hd;
  const T* r = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* w = p.w + b * p.w_sb + h * p.w_sh;
  const float* dy = p.dy + b * p.dy_sb + h * p.dy_sh;
  const int nck = (S + kT - 1) / kT;
  const float* ckpt = p.ckpt + (long long)bh * nck * hd2;

  if (role == 0 && nck > 0)
    stage_chunk<HD, T, ASYNC>(p, r, k, v, w, dy, ckpt, nck - 1, row0, stage(nck - 1), lane);
  for (int e = tid; e < HD; e += Sh::kThreads)
    Us[e] = e < hd ? __ldg(p.u + h * p.u_sh + e) : 0.f;
  float G[kC];                           // G[i, j + c]: the gradient of the state
#pragma unroll
  for (int c = 0; c < kC; ++c)
    G[c] = (role < 0 && p.dsn != nullptr && i < hd && j + c < hd)
               ? __ldg(p.dsn + bh * hd2 + i * hd + j + c) : 0.f;
  float du = 0.f, du_c = 0.f;            // role 1, lane l < kRows: du of row row0 + l

  // iteration c0 sweeps chunk c0 while the helpers load chunk c0 - 1, take
  // chunk c0's dots and write chunk c0 + 1 out; one barrier an iteration
  for (int c0 = nck - 1; c0 >= -1; --c0) {
    if (ASYNC && role == 0) cp_async_wait_all();
    __syncthreads();                     // chunk c0 is staged, chunk c0 + 1 swept
    if (role < 0) {
      if (c0 >= 0) {
        const int n = min(kT, S - c0 * kT);
        float* bf = buf(c0);
        float* Rows = bf + 2 * kT;
        float* DvP = Rows + 3 * kT * kRows;
        if (n == kT)                     // no test per step: the steps interleave
          sweep_chunk<HD, T, true>(stage(c0), n, il, i, j, lane, tid / 32, G, Rows, DvP);
        else                             // the partial chunk, the last (walked first)
          sweep_chunk<HD, T, false>(stage(c0), n, il, i, j, lane, tid / 32, G, Rows, DvP);
      }
    } else if (role == 0) {
      if (c0 > 0)
        stage_chunk<HD, T, ASYNC>(p, r, k, v, w, dy, ckpt, c0 - 1, row0, stage(c0 - 1), lane);
    } else if (role == 1) {
      if (c0 >= 0) chunk_dots<HD, T>(stage(c0), lane, Us, buf(c0), buf(c0) + kT);
      const int c = c0 + 1;
      if (c < nck && lane < kRows) {     // du_i += r_i k_i (v·dy), last step first
        const Stage<HD, T> s = stage(c);
        const float* VDy = buf(c);
        const int gi = row0 + lane, n = min(kT, S - c * kT);
        float term[kT];
#pragma unroll
        for (int cc = 0; cc < kT; ++cc)
          term[cc] = f32(s.r[cc * HD + gi]) * f32(s.k[cc * HD + gi]) * VDy[cc];
#pragma unroll
        for (int cc = kT - 1; cc >= 0; --cc) {
          if (cc < n) {
            const float y = term[cc] - du_c;
            const float t = du + y;
            du_c = (t - du) - y;
            du = t;
          }
        }
      }
    } else if (c0 + 1 < nck) {
      write_chunk<HD, T>(p, stage(c0 + 1), Us, buf(c0 + 1), c0 + 1, q, row0,
                         static_cast<T*>(p.dr) + b * p.dr_sb + h * p.dr_sh,
                         static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh,
                         p.dw + b * p.dw_sb + h * p.dw_sh,
                         p.dvp + ((long long)bh * kP + q) * S * hd, lane);
    }
  }

  if (role < 0) {                        // ds0 = G_0
#pragma unroll
    for (int c = 0; c < kC; ++c)
      if (i < hd && j + c < hd) p.ds0[bh * hd2 + i * hd + j + c] = G[c];
  } else if (role == 1 && lane < kRows && row0 + lane < hd) {
    p.du[(long long)bh * hd + row0 + lane] = du;
  }
}

// dv = the sum of the P partials in order, rounded once to dv's type.
template <typename T>
__global__ void __launch_bounds__(256) wkv6_bwd_dv_kernel(const BwdParams p, int P) {
  const long long n = (long long)p.S * p.hd;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const float* dvp = p.dvp + (long long)bh * P * n;
  T* dv = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float a = 0.f;
    for (int q = 0; q < P; ++q) a += __ldg(dvp + q * n + e);
    const long long t = e / p.hd;
    st1(dv + t * p.dv_ss + (e - t * p.hd), a);
  }
}

template <int HD, typename T, bool ASYNC>
int launch(const BwdParams& p, int B, cudaStream_t st) {
  using Sh = Shape<HD, T>;
  static_assert(Sh::kSmemBytes <= 232448, "shared memory");
  if (p.dvp_floats < (long long)B * p.H * Sh::kP * p.S * p.hd) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      wkv6_bwd_kernel<HD, T, ASYNC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Sh::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const unsigned bhs = (unsigned)B * (unsigned)p.H;
  wkv6_bwd_kernel<HD, T, ASYNC><<<bhs * Sh::kP, Sh::kThreads, Sh::kSmemBytes, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.S == 0) return (int)err;
  const long long n = (long long)p.S * p.hd;
  const unsigned blocks = (unsigned)((n + 255) / 256 < 64 ? (n + 255) / 256 : 64);
  wkv6_bwd_dv_kernel<T><<<dim3(blocks, bhs), 256, 0, st>>>(p, Sh::kP);
  return (int)cudaGetLastError();
}

// 16-byte copies of every row: the pointer and each stride a multiple of 16
// bytes, the row whole (hd = HD)
bool rows16(const void* ptr, long long sb, long long sh, long long ss, int elem) {
  const long long g = 16 / elem;
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % g == 0 && sh % g == 0 &&
         ss % g == 0;
}

template <int HD, typename T>
int launch_w(const BwdParams& p, int B, cudaStream_t st) {
  const int et = (int)sizeof(T);
  const bool async = p.hd == HD && reinterpret_cast<uintptr_t>(p.ckpt) % 16 == 0 &&
                     rows16(p.r, p.r_sb, p.r_sh, p.r_ss, et) &&
                     rows16(p.k, p.k_sb, p.k_sh, p.k_ss, et) &&
                     rows16(p.v, p.v_sb, p.v_sh, p.v_ss, et) &&
                     rows16(p.w, p.w_sb, p.w_sh, p.w_ss, 4) &&
                     rows16(p.dy, p.dy_sb, p.dy_sh, p.dy_ss, 4);
  return async ? launch<HD, T, true>(p, B, st) : launch<HD, T, false>(p, B, st);
}

// blocks per (b, h) at head width hd: the kP of the kernel's width W, the
// smallest of 32, 64 and 128 that holds hd
int row_blocks(int hd) {
  return hd <= 32 ? Shape<32, float>::kP : hd <= 64 ? Shape<64, float>::kP
                                                     : Shape<128, float>::kP;
}

template <typename T>
int launch_hd(const BwdParams& p, int B, cudaStream_t st) {
  if (p.hd <= 32) return launch_w<32, T>(p, B, st);
  if (p.hd <= 64) return launch_w<64, T>(p, B, st);
  return launch_w<128, T>(p, B, st);
}

}  // namespace

extern "C" {

// The backward's plan at (B, H, S, hd): returns the device kernels one call
// of wkv6_bwd_launch launches (wkv6_bwd_kernel and, at S > 0,
// wkv6_bwd_dv_kernel) and writes to *dvp_floats the fp32 scratch it takes
// as dvp, B·H·P·S·hd for the kernel's P blocks a head (row_blocks); -1 for
// a shape the launch refuses (hd outside 1..kMaxHd, a negative size, B·H
// outside 1..65,535).
int wkv6_bwd_plan(int B, int H, int S, int hd, long long* dvp_floats) {
  if (B <= 0 || H <= 0 || S < 0 || hd <= 0 || hd > kMaxHd || (long long)B * H > 65535)
    return -1;
  *dvp_floats = (long long)B * H * row_blocks(hd) * S * hd;
  return S > 0 ? 2 : 1;
}

// r, k, v (bf16 if rkv_bf16, else fp32), w, dy and dr, dk, dv (r's type), dw:
// strides of (batch, head, step), the last dimension contiguous; u: of
// head. ckpt (B,H,ceil(S/every),hd,hd), ds_n (null: zero) and ds0
// (B,H,hd,hd), du (B,H,hd) contiguous fp32. dvp holds dvp_floats fp32, at
// least what wkv6_bwd_plan gives. Returns a cudaError_t (0 = launched;
// cudaErrorInvalidValue for every other than 16, a shape the plan refuses
// or too small a dvp).
int wkv6_bwd_launch(const void* r, const void* k, const void* v, const float* w,
                    const float* u, const float* ckpt, const float* dy, const float* dsn,
                    void* dr, void* dk, void* dv, float* dw, float* du, float* ds0,
                    float* dvp, long long dvp_floats,
                    int every, int B, int H, int S, int hd, int rkv_bf16,
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
  if (every != kT || B <= 0 || H <= 0 || S < 0 || hd <= 0 || hd > kMaxHd ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.r = r; p.k = k; p.v = v; p.w = w; p.u = u; p.ckpt = ckpt; p.dy = dy; p.dsn = dsn;
  p.dr = dr; p.dk = dk; p.dv = dv; p.dw = dw; p.du = du; p.ds0 = ds0;
  p.dvp = dvp; p.dvp_floats = dvp_floats;
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
  if (rkv_bf16) return launch_hd<__nv_bfloat16>(p, B, st);
  return launch_hd<float>(p, B, st);
}

}  // extern "C"
