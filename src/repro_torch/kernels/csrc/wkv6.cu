// RWKV6 ("Finch") WKV recurrence for Hopper (sm_90a), plain CUDA C++, fp32.
//
// Replaces the Pallas TPU kernel repro/kernels/wkv6.py (wkv6 / _wkv_kernel).
// Per (batch, head) the hd x hd state S is carried through the sequence:
//
//   y_t     = (S_t + u ⊙ (k_t ⊗ v_t))ᵀ r_t        (state before the update)
//   S_{t+1} = diag(w_t) S_t + k_t ⊗ v_t
//
//   r, k, v, w, y (B,H,S,hd), u (H,hd), s0 and s_n (B,H,hd,hd), all fp32.
//   Every tensor but s_n comes by strides with its last dimension contiguous,
//   so the model's (B,S,H,hd) activations are read, and y written, in place
//   through permuted views. s_n is contiguous.
//
// Design. One block per (b, h); the time loop runs inside the block. Thread
// (j, g) owns column j of the state and the kRows rows g*kRows .. of it, in
// registers, so the state never leaves the chip between steps. Time steps
// are staged kChunk at a time in shared memory (r_t, k_t, v_t, w_t), so a
// chunk costs two barriers, not two per step. Each thread adds its rows'
// share of y_t[j] = sum_i r_i (S_ij + u_i k_i v_j) to a shared partial; after
// the chunk the kGroups partials of each column are summed and written.
// Columns and rows past hd (hd below the template width) hold zeros and are
// never stored. S = 0 copies s0 to s_n.
//
// Bound on the H100: at the engine's shape (1,32,1,64) the 4·(5·B·H·S·hd +
// 2·B·H·hd² + H·hd) bytes (0.33 µs at 3.35 TB/s), dominated by the state's
// read and write; at the prefill shape (1,32,2048,64) bytes (25 µs) and the
// 6·B·H·S·hd² fp32 operations (24 µs at 67 TFLOP/s) are close. This first
// version sits far above both at long S: B·H = 32 blocks for 132 SMs, each
// carrying an S-step dependent chain. A chunked tensor-core formulation
// (repro/models/rwkv6.py::wkv_scan_chunked) is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kGroups = 4;               // row groups sharing one column
constexpr int kMaxHd = 128;

struct Params {
  const float* r;
  const float* k;
  const float* v;
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
};

template <int HD>
__global__ void __launch_bounds__(HD * kGroups) wkv6_kernel(Params p) {
  constexpr int kThreads = HD * kGroups;
  constexpr int kRows = HD / kGroups;             // state rows per thread
  constexpr int kChunk = HD >= 128 ? 8 : 16;      // time steps per staging
  __shared__ float Rs[kChunk][HD], Ks[kChunk][HD], Vs[kChunk][HD], Ws[kChunk][HD];
  __shared__ float Part[kChunk][kGroups][HD];

  const int tid = threadIdx.x;
  const int j = tid % HD, g = tid / HD;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int hd = p.hd, S = p.S;
  const float* r = p.r + b * p.r_sb + h * p.r_sh;
  const float* k = p.k + b * p.k_sb + h * p.k_sh;
  const float* v = p.v + b * p.v_sb + h * p.v_sh;
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

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
    for (int e = tid; e < kChunk * HD; e += kThreads) {
      const int c = e / HD, d = e % HD;
      const bool in = c < n && d < hd;
      const long long t = t0 + c;
      Rs[c][d] = in ? r[t * p.r_ss + d] : 0.f;
      Ks[c][d] = in ? k[t * p.k_ss + d] : 0.f;
      Vs[c][d] = in ? v[t * p.v_ss + d] : 0.f;
      Ws[c][d] = in ? w[t * p.w_ss + d] : 0.f;
    }
    __syncthreads();                 // the chunk is staged; Part is free
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

}  // namespace

extern "C" {

// r, k, v, w, y: strides of (batch, head, step); u: of head; s0: of (batch,
// head, row); the last dimension of each is contiguous. s_n is contiguous
// (B,H,hd,hd). Returns a cudaError_t (0 = launched; cudaErrorInvalidValue
// for hd outside 1..kMaxHd or a negative size).
int wkv6_launch(const float* r, const float* k, const float* v, const float* w,
                const float* u, const float* s0, float* y, float* sn,
                int B, int H, int S, int hd,
                long long r_sb, long long r_sh, long long r_ss,
                long long k_sb, long long k_sh, long long k_ss,
                long long v_sb, long long v_sh, long long v_ss,
                long long w_sb, long long w_sh, long long w_ss,
                long long y_sb, long long y_sh, long long y_ss,
                long long u_sh, long long s_sb, long long s_sh, long long s_si,
                void* stream) {
  if (B <= 0 || H <= 0 || S < 0 || hd <= 0 || hd > kMaxHd)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.r = r; p.k = k; p.v = v; p.w = w; p.u = u; p.s0 = s0; p.y = y; p.sn = sn;
  p.H = H; p.S = S; p.hd = hd;
  p.r_sb = r_sb; p.r_sh = r_sh; p.r_ss = r_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.w_sb = w_sb; p.w_sh = w_sh; p.w_ss = w_ss;
  p.y_sb = y_sb; p.y_sh = y_sh; p.y_ss = y_ss;
  p.u_sh = u_sh; p.s_sb = s_sb; p.s_sh = s_sh; p.s_si = s_si;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)B * (unsigned)H);
  if (hd <= 32)
    wkv6_kernel<32><<<grid, 32 * kGroups, 0, st>>>(p);
  else if (hd <= 64)
    wkv6_kernel<64><<<grid, 64 * kGroups, 0, st>>>(p);
  else
    wkv6_kernel<128><<<grid, 128 * kGroups, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
