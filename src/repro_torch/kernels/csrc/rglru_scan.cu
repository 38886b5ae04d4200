// RG-LRU diagonal linear recurrence for Hopper (sm_90a), plain CUDA C++, fp32.
//
// Replaces the Pallas TPU kernel repro/kernels/rglru.py (rglru_scan /
// _rglru_kernel). Per (batch, channel):
//
//   h = h0[b, d];  for t < S:  h = a[b, t, d] * h + b[b, t, d];  y[b, t, d] = h
//   hn[b, d] = h
//
//   a, b, y (B,S,D); h0 and hn (B,D); all fp32. a, b, y and h0 come by
//   strides with the channel dimension contiguous, so the model's tensors
//   are read and written in place; hn is contiguous.
//
// Design. One thread per channel, blocks of kThreads channels over
// (d-block, batch), so every load and store of a time step is coalesced
// along D. a_t and b_t do not depend on h: they are loaded kAhead steps
// ahead into registers (the next chunk's loads are issued before the
// current chunk's chain runs), so only the multiply-add chain is serial.
// The product and the sum are rounded separately (__fmul_rn, __fadd_rn),
// as the plain version `a_t * h + b_t` rounds them; the compiler would
// otherwise contract them into one FMA. Any D (the Pallas kernel's block_d
// and its divisibility assert are TPU tiling), any S >= 0 (S = 0 copies h0
// to hn), any B up to the grid's 65,535 rows.
//
// Bound on the H100: bytes, 4·(3·B·S·D + 2·B·D) at 3.35 TB/s (2·B·S·D
// fp32 operations are far below the 67 TFLOP/s line). At the engine's step
// (1,1,2560) that is 51,200 bytes, 0.015 µs, so launch latency decides; at
// the model phase's prefill (1,2560,2560) 78.7 MB, 23 µs. There, batch 1
// gives 10 blocks for 132 SMs, each walking a 2,560-step chain, so this
// first version sits far above the bound; a chunked two-pass scan
// (per-chunk products and carries, then a fix-up) is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // channels per block
constexpr int kAhead = 8;       // time steps loaded ahead of the chain

struct Params {
  const float* __restrict__ a;
  const float* __restrict__ b;
  const float* __restrict__ h0;
  float* __restrict__ y;
  float* __restrict__ hn;
  int S, D;
  long long a_sb, a_ss, b_sb, b_ss, y_sb, y_ss, h_sb;
};

__device__ __forceinline__ void load_chunk(const Params& p, const float* a,
                                           const float* b, int t0,
                                           float (&at)[kAhead], float (&bt)[kAhead]) {
#pragma unroll
  for (int c = 0; c < kAhead; ++c) {
    const int t = t0 + c;
    at[c] = t < p.S ? __ldg(a + t * p.a_ss) : 0.f;
    bt[c] = t < p.S ? __ldg(b + t * p.b_ss) : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads) rglru_kernel(const Params p) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int bi = blockIdx.y;
  if (d >= p.D) return;
  const float* a = p.a + bi * p.a_sb + d;
  const float* b = p.b + bi * p.b_sb + d;
  float* y = p.y + bi * p.y_sb + d;
  float h = p.h0[bi * p.h_sb + d];

  float an[kAhead], bn[kAhead];
  load_chunk(p, a, b, 0, an, bn);
  for (int t0 = 0; t0 < p.S; t0 += kAhead) {
    float at[kAhead], bt[kAhead];
#pragma unroll
    for (int c = 0; c < kAhead; ++c) { at[c] = an[c]; bt[c] = bn[c]; }
    if (t0 + kAhead < p.S) load_chunk(p, a, b, t0 + kAhead, an, bn);
#pragma unroll
    for (int c = 0; c < kAhead; ++c) {
      if (t0 + c < p.S) {
        h = __fadd_rn(__fmul_rn(at[c], h), bt[c]);
        y[(long long)(t0 + c) * p.y_ss] = h;
      }
    }
  }
  p.hn[(long long)bi * p.D + d] = h;
}

}  // namespace

extern "C" {

// a, b, y: strides of (batch, step); h0: of batch; the channel dimension of
// each is contiguous. hn is contiguous (B,D). Returns a cudaError_t
// (0 = launched; cudaErrorInvalidValue for B outside 1..65535, S < 0 or
// D <= 0).
int rglru_scan_launch(const float* a, const float* b, const float* h0, float* y,
                 float* hn, int B, int S, int D,
                 long long a_sb, long long a_ss, long long b_sb, long long b_ss,
                 long long y_sb, long long y_ss, long long h_sb, void* stream) {
  if (B <= 0 || B > 65535 || S < 0 || D <= 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.a = a; p.b = b; p.h0 = h0; p.y = y; p.hn = hn;
  p.S = S; p.D = D;
  p.a_sb = a_sb; p.a_ss = a_ss; p.b_sb = b_sb; p.b_ss = b_ss;
  p.y_sb = y_sb; p.y_ss = y_ss; p.h_sb = h_sb;
  const dim3 grid((unsigned)((D + kThreads - 1) / kThreads), (unsigned)B);
  rglru_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
