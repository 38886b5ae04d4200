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
//
// The Pallas kernel walks W in order inside one grid row per (batch,
// kv_head); on the H100 that is B*KV blocks, 1 to 4 of 132 SMs at batch 1.
// Here W is cut into nsplit <= 16 chunks (flash-decoding), one block per
// (chunk, kv_head or 16-row group of its query heads, batch), and the blocks
// of a chunk's group form one thread-block cluster (Hopper), which merges
// the chunks in the same launch through distributed shared memory: each
// block sends its (m, l) to every block of the cluster and each element of
// its unnormalised acc to the block that merges that element; after one
// cluster barrier each block writes its share of the outputs,
//   M = max m_c,  out = sum_c acc_c e^(m_c - M) / sum_c l_c e^(m_c - M).
// There is no scratch in device memory and no second launch. A cluster lies
// in one GPC, so the card holds fewer clusters of 16 blocks than its SMs
// suggest; decode_attention_occupancy tells the host how many clusters of a
// plan it runs at once, launching nothing.
//
// Semantics, the reference's on every input:
//  * masked slots score -1e30; a 16-slot tile with no valid slot is skipped
//    and loads nothing (its weight would be e^(-1e30 - m) = 0), and a chunk
//    without a valid slot reports l = 0 and weighs 0;
//  * with no valid slot anywhere every score is -1e30, so the reference gives
//    the mean of V over all W slots: the merging blocks see l = 0 from every
//    chunk and compute that mean themselves (a rare path, not fast);
//  * slots past W never count; any W >= 1, any hd, any G = H/KV, any strides
//    with a contiguous head dimension.
//
// Bound on the H100: memory, and at the serving shapes latency. A slot costs
// 4*G*hd operations for 4*hd bytes of K and V, G = 8-10 operations per byte
// against the card's balance of 295. At yi-6b's step (4 kv heads x 4,096
// slots of 128, 2,568 valid) the call must move 5.3 MB, 1.6 us at 3.35 TB/s;
// at recurrentgemma-2b's (one kv head, 1,024 slots of 256, 584 valid) 0.6 MB,
// 0.18 us: below the fixed cost of any launch. What a call takes is a chain
// of dependent steps (valid, then K/V, then the products, then the merge),
// each a memory round trip or a barrier, with one or two warps on each of
// an SM's four schedulers to hide them. The design keeps that chain short:
// one launch, no round trip through device memory for the merge, every load
// of a step started before the first is used, and no instruction stream
// longer than the copies it waits on.
//
// Two routes behind the one entry, decode_attention_launch:
//
//  * bf16, hd <= 256 -> decode_mma_kernel<HDP> (hd padded with zeros to
//    HDP = 64, 128 or 256), both products on the tensor cores with
//    mma.sync.m16n8k16 (bf16 in, fp32 accumulate). A block takes one chunk
//    and one group of 16 query rows of a kv head (G <= 16 in one group,
//    zero-padded to 16; G > 16 in ceil(G/16) groups along the grid's y,
//    each reading the chunk's K/V). Its warps (up to 8) take the chunk's
//    16-slot tiles in turn, each warp on its own ring of up to 3 shared-
//    memory stages, so a warp waits on no other until the chunk is done:
//      - valid comes in for the warp's own tiles only, one 16-byte load per
//        lane for four slots, as a 16-bit mask per tile; tiles whose mask is
//        0 are never loaded;
//      - K and V tiles stay bf16 in shared memory (rows of HDP + 8 values, so
//        ldmatrix reads them without bank conflicts) and arrive by 16-byte
//        cp.async.cg, all of a warp's first stages at once;
//      - the 16 query rows are the A fragment, held in registers for the
//        whole chunk; S = Q K^T over two 8-slot n-tiles per k-step (ldmatrix
//        of K, even and odd k-steps in two accumulator chains), an online
//        softmax in registers (max over the quad, exp2 with the scale folded
//        in, a running l), P rounded to bf16 as the A fragment of O += P V
//        (ldmatrix.trans of V), as SDPA and FlashAttention round it;
//      - the warps' (m, l, O) are summed through shared memory into the
//        block's partial as it is sent to the merging blocks.
//    A base pointer or stride that does not allow 16-byte copies (an odd hd,
//    a view one element off) fills the same stages element by element.
//    Why not wgmma: it takes 64-row tiles, of which G = 8-10 rows would use
//    a sixth; mma.sync's 16 rows serve this work at any rate it needs.
//  * fp32, and bf16 at hd > 256 -> decode_partial_kernel<T>, fp32 FMA on the
//    CUDA cores (the fp32 model phases' 5e-4 and the kernel's 2e-5 need fp32
//    products): 64-slot tiles staged in shared memory as fp32, G query heads
//    per block; the same chunks, tile skipping, clusters and merge.
//
// ptxas -v (sm_90a, nvcc 12.9): decode_mma_kernel<64|128|256> 126, 167 and
// 254 registers, decode_partial_kernel<bf16|float> 63 and 48; 16-byte
// stack frames or none, no spill stores or loads, no static shared memory
// (the dynamic size is what launch_mma and launch_simt compute).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;       // the reference's mask value
constexpr int kMaxDevices = 64;
constexpr long long kMaxSmem = 232448;  // shared memory a block may use
constexpr int kMaxCluster = 16;         // chunks of W: blocks of one cluster
constexpr int kBK = 16;                 // cache slots per tile of decode_mma_kernel
constexpr int kRows = 16;               // query rows per block of decode_mma_kernel
constexpr int kWarps = 8;               // warps per block of decode_mma_kernel, at most
constexpr int kStages = 3;              // K/V tiles in flight per warp, at most
constexpr int kSimtWarps = 8;
constexpr int kSimtThreads = kSimtWarps * 32;
constexpr int kSimtBK = 64;             // cache slots per tile of decode_partial_kernel

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* valid;
  void* o;
  int KV, G, W, hd, nsplit, chunk, ngroups;
  int nwarps, tpw, nstages;       // decode_mma_kernel: warps, tiles per warp, ring stages
  int vec_q, vec_kv, vec_valid;   // 16-byte loads allowed
  long long q_sb, q_sh;
  long long k_sb, k_sh, k_sw;
  long long v_sb, v_sh, v_sw;
  long long o_sb, o_sh;
  float scale;
};

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

// 2^x on the special-function unit; subnormal results flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// e^x for m in natural units (decode_partial_kernel), 2^x in log2 units
// (decode_mma_kernel)
template <bool kLog2>
__device__ __forceinline__ float xp(float x) { return kLog2 ? ex2(x) : expf(x); }

// Sets a kernel's dynamic shared memory limit, and allows clusters of up to
// 16 blocks, once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = bytes;
  return err;
}

// --------------------------------------------------------------------------
// the merge, across the blocks of a cluster
// --------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// every thread of the cluster's blocks: writes to shared memory before it
// are seen by reads of any block's shared memory after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the same barrier in two halves: arrive when a block starts, wait before
// its first access to another block's shared memory (every block of the
// cluster has started then)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// the address in block `rank`'s shared memory of local shared address `addr`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_dsmem2(uint32_t addr, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" :: "r"(addr), "f"(a), "f"(b)
               : "memory");
}
__device__ __forceinline__ void st_dsmem4(uint32_t addr, float4 x) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w) : "memory");
}
__device__ __forceinline__ void st_dsmem(uint32_t addr, float x) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" :: "r"(addr), "f"(x) : "memory");
}

// How the rows x hd outputs of a group are dealt to the nsplit blocks of
// its cluster: elements of vw floats (4 where hd allows), per of them to a
// block in order. Each block receives, in its `recv` buffer, the (m, l) of
// every row from every block (ml floats, rounded to 4) and every block's
// values of its own elements.
struct Slice {
  int vw, hv, n, per, ml;
};
__host__ __device__ __forceinline__ Slice slice_of(int rows, int hd, int nsplit) {
  Slice sl;
  sl.vw = hd % 4 == 0 ? 4 : 1;
  sl.hv = hd / sl.vw;
  sl.n = rows * sl.hv;
  sl.per = (sl.n + nsplit - 1) / nsplit;
  sl.ml = (2 * nsplit * rows + 3) & ~3;
  return sl;
}
__host__ __device__ __forceinline__ long long recv_bytes(int rows, int hd, int nsplit) {
  const Slice sl = slice_of(rows, hd, nsplit);
  return 4LL * ((sl.ml + (long long)nsplit * sl.per * sl.vw + 3) & ~3LL);   // 16-byte multiple
}
__host__ __device__ __forceinline__ long long merge_bytes(int nsplit, int rows) {
  return 4LL * (nsplit * rows + rows);
}

// This block's (m, l) of every row into the recv buffer of every block of
// the cluster (at row `rank`); l = 0 for a chunk without a valid slot.
__device__ __forceinline__ void push_ml(const float* m, const float* l, int rows, int ns,
                                        uint32_t recv) {
  const int rank = (int)cluster_rank();
#pragma unroll 1
  for (int i = threadIdx.x; i < ns * rows; i += blockDim.x) {
    const int j = i / rows, r = i - j * rows;
    st_dsmem2(map_rank(recv + 8u * (uint32_t)(rank * rows + r), j), m[r], l[r]);
  }
}

// Element e (vw floats at row r, column d) of this block's partial into the
// recv buffer of the block that merges it.
__device__ __forceinline__ void push_acc(const Slice& sl, int e, float4 x, uint32_t recv) {
  const int q = e / sl.per, idx = e - q * sl.per;
  const uint32_t dst = recv + 4u * (uint32_t)(sl.ml + ((int)cluster_rank() * sl.per + idx) * sl.vw);
  if (sl.vw == 4) st_dsmem4(map_rank(dst, q), x);
  else st_dsmem(map_rank(dst, q), x.x);
}

// After the cluster barrier: rows g0 .. g0 + rows - 1 of kv head kvh, this
// block's elements, from what the nsplit blocks sent to `recv`: with M the
// largest m_j of the blocks that saw a valid slot, the e^(m_j - M)-weighted
// sum of their acc over their weighted l; or, when no chunk saw a valid
// slot, the mean of V over all W slots (what the reference's all -1e30
// scores give). `buf` holds merge_bytes(nsplit, rows).
template <typename T, bool kLog2>
__device__ void merge_received(const Params& p, int b, int kvh, int g0, int rows,
                               const float* recv, float* buf) {
  const int ns = p.nsplit, tid = threadIdx.x, nth = blockDim.x;
  const Slice sl = slice_of(rows, p.hd, ns);
  const float* acc = recv + sl.ml;                             // [block][element]
  float* sW = buf;                        // ns x rows: each block's weight
  float* sInv = sW + ns * rows;           // rows: 1 / L, 0 if no chunk saw a valid slot
  // M, L and the blocks' weights of each row, 16 lanes a row (j < ns <= 16)
#pragma unroll 1
  for (int r0 = 0; r0 < rows; r0 += nth / 16) {
    const int r = r0 + tid / 16, j = tid & 15;
    const bool on = r < rows && j < ns;
    const float mj = on ? recv[2 * (j * rows + r)] : 0.f;
    const float lj = on ? recv[2 * (j * rows + r) + 1] : 0.f;
    float m = lj > 0.f ? mj : -INFINITY;
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float w = lj > 0.f ? xp<kLog2>(mj - m) : 0.f;
    float l = w * lj;
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (on) sW[j * rows + r] = w;
    if (r < rows && j == 0) sInv[r] = l > 0.f ? 1.f / l : 0.f;
  }
  __syncthreads();
  T* out = static_cast<T*>(p.o) + b * p.o_sb + (long long)(kvh * p.G + g0) * p.o_sh;
  const int lo = (int)cluster_rank() * sl.per, hi = min(sl.n, lo + sl.per);
#pragma unroll 1
  for (int e = lo + tid; e < hi; e += nth) {
    const int r = e / sl.hv, d = sl.vw * (e - r * sl.hv), idx = e - lo;
    T* dst = out + (long long)r * p.o_sh + d;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    const float inv = sInv[r];
    if (inv == 0.f) {                     // no valid slot anywhere
      const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh + d;
#pragma unroll 1
      for (int w = 0; w < p.W; ++w)
        for (int i = 0; i < sl.vw; ++i) a[i] += to_f(v[(long long)w * p.v_sw + i]);
      for (int i = 0; i < sl.vw; ++i) dst[i] = from_f<T>(a[i] / (float)p.W);
      continue;
    }
    // every block's value loaded before any is summed (past ns the last
    // block's again, at weight 0); a block without a valid slot sent no
    // acc and weighs 0
    if (sl.vw == 4) {
      float4 x[kMaxCluster];
#pragma unroll
      for (int j = 0; j < kMaxCluster; ++j)
        x[j] = *reinterpret_cast<const float4*>(acc + (min(j, ns - 1) * sl.per + idx) * 4);
#pragma unroll
      for (int j = 0; j < kMaxCluster; ++j) {
        const float w = j < ns ? sW[j * rows + r] : 0.f;
        if (w > 0.f) {
          a[0] = fmaf(w, x[j].x, a[0]);
          a[1] = fmaf(w, x[j].y, a[1]);
          a[2] = fmaf(w, x[j].z, a[2]);
          a[3] = fmaf(w, x[j].w, a[3]);
        }
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < ns; ++j) {
        const float w = sW[j * rows + r];
        if (w > 0.f) a[0] = fmaf(w, acc[j * sl.per + idx], a[0]);
      }
    }
    for (int i = 0; i < sl.vw; ++i) dst[i] = from_f<T>(a[i] * inv);
  }
}

// --------------------------------------------------------------------------
// fp32 (and bf16 at hd > 256): CUDA-core FMA
// --------------------------------------------------------------------------

// floats of decode_partial_kernel's own arrays, rounded to 4 (recv follows)
__host__ __device__ __forceinline__ int simt_floats(int G, int hd) {
  const int kst = hd | 1;
  return (2 * G * hd + kSimtBK * kst + kSimtBK * hd + G * kSimtBK + 3 * G + 3) & ~3;
}
long long simt_smem_bytes(int G, int hd, int nsplit) {
  return 4LL * simt_floats(G, hd) + recv_bytes(G, hd, nsplit) + merge_bytes(nsplit, G);
}

template <typename T>
__global__ void __launch_bounds__(kSimtThreads) decode_partial_kernel(const Params p) {
  extern __shared__ __align__(16) float smem_f[];
  const int hd = p.hd, G = p.G;
  const int kst = hd | 1;                 // odd stride: column reads hit 32 banks
  float* Qs = smem_f;                     // G x hd
  float* Acc = Qs + G * hd;               // G x hd
  float* Ks = Acc + G * hd;               // kSimtBK x kst
  float* Vs = Ks + kSimtBK * kst;         // kSimtBK x hd
  float* Ss = Vs + kSimtBK * hd;          // G x kSimtBK scores, then probabilities
  float* Ms = Ss + G * kSimtBK;           // G running max
  float* Ls = Ms + G;                     // G running sum
  float* As = Ls + G;                     // G rescale factor of the current tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const int* valid = p.valid;
  const int w_begin = split * p.chunk;
  const int w_end = min(p.W, w_begin + p.chunk);

  cluster_arrive();
  for (int idx = tid; idx < G * hd; idx += kSimtThreads) {
    const int g = idx / hd, d = idx - g * hd;
    Qs[idx] = to_f(q[(long long)(kvh * G + g) * p.q_sh + d]);
    Acc[idx] = 0.f;
  }
  for (int g = tid; g < G; g += kSimtThreads) {
    Ms[g] = kNegInf;
    Ls[g] = 0.f;
  }

  for (int w0 = w_begin; w0 < w_end; w0 += kSimtBK) {
    int mine = 0;
    for (int c = tid; c < kSimtBK; c += kSimtThreads)
      mine |= (w0 + c < w_end) && valid[w0 + c] > 0;
    // barrier: the previous tile's reads of Vs/Ss are done
    if (!__syncthreads_or(mine)) continue;

    for (int idx = tid; idx < kSimtBK * hd; idx += kSimtThreads) {
      const int c = idx / hd, d = idx - c * hd;
      float kx = 0.f, vx = 0.f;
      if (w0 + c < w_end) {
        kx = to_f(k[(long long)(w0 + c) * p.k_sw + d]);
        vx = to_f(v[(long long)(w0 + c) * p.v_sw + d]);
      }
      Ks[c * kst + d] = kx;
      Vs[c * hd + d] = vx;
    }
    __syncthreads();

    for (int idx = tid; idx < G * kSimtBK; idx += kSimtThreads) {
      const int g = idx / kSimtBK, c = idx - g * kSimtBK;
      float x;
      if (w0 + c >= w_end) {
        x = -INFINITY;           // past the chunk: not a slot of this block
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

    for (int g = warp; g < G; g += kSimtWarps) {
      float* srow = Ss + g * kSimtBK;
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

    const int nc = min(kSimtBK, w_end - w0);
    for (int idx = tid; idx < G * hd; idx += kSimtThreads) {
      const int g = idx / hd, d = idx - g * hd;
      const float* prow = Ss + g * kSimtBK;
      float a = Acc[idx] * As[g];
      for (int c = 0; c < nc; ++c) a = fmaf(prow[c], Vs[c * hd + d], a);
      Acc[idx] = a;
    }
  }
  __syncthreads();

  // the chunk's partial (Ms, Ls, Acc; Ls = 0 if no tile had a valid slot)
  // to the blocks that merge it; then each block merges its elements
  float* recv = smem_f + simt_floats(G, hd);
  const uint32_t rv = smem_u32(recv);
  const Slice sl = slice_of(G, hd, p.nsplit);
  cluster_wait();
  push_ml(Ms, Ls, G, p.nsplit, rv);
  if (Ls[0] > 0.f) {
#pragma unroll 1
    for (int e = tid; e < sl.n; e += kSimtThreads) {
      const int r = e / sl.hv, d = sl.vw * (e - r * sl.hv);
      const float* src = Acc + r * hd + d;
      push_acc(sl, e, sl.vw == 4 ? *reinterpret_cast<const float4*>(src)
                                 : make_float4(src[0], 0.f, 0.f, 0.f), rv);
    }
  }
  cluster_sync();                       // every block's sends have landed
  merge_received<T, false>(p, b, kvh, 0, G, recv, recv + recv_bytes(G, hd, p.nsplit) / 4);
}

// --------------------------------------------------------------------------
// bf16: tensor cores (mma.sync.m16n8k16)
// --------------------------------------------------------------------------

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
// waits until at most n (0-3) of this thread's copy groups are pending
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n <= 0) cp_async_wait<0>();
  else if (n == 1) cp_async_wait<1>();
  else if (n == 2) cp_async_wait<2>();
  else cp_async_wait<3>();
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
// D (16 x 8, fp32) += A (16 x 16, bf16, row-major) * B (16 x 8, bf16, col-major)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// Bits 0-3: slots s0 .. s0 + 3 are valid and below w_end (one 16-byte load
// where the slots and the pointer allow it).
__device__ __forceinline__ unsigned valid_bits4(const Params& p, int s0, int w_end) {
  if (p.vec_valid && s0 + 4 <= w_end) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p.valid + s0));
    return (unsigned)((x.x > 0) | (x.y > 0) << 1 | (x.z > 0) << 2 | (x.w > 0) << 3);
  }
  unsigned bits = 0;
  #pragma unroll 1
  for (int i = 0; i < 4; ++i)
    if (s0 + i < w_end && __ldg(p.valid + s0 + i) > 0) bits |= 1u << i;
  return bits;
}

// the first tile from j on that holds a valid slot (n if none)
__device__ __forceinline__ int next_tile(const uint16_t* tmask, int j, int n) {
  while (j < n && tmask[j] == 0) ++j;
  return j;
}

// The block's query rows (rows of them, from q) into sQ, zero past them and
// past hd up to HDP.
template <int HDP>
__device__ __forceinline__ void load_q(const Params& p, __nv_bfloat16* sQ,
                                       const __nv_bfloat16* q, int rows, int tid, int nth) {
  constexpr int LD = HDP + 8;
  const int hd = p.hd;
  if (p.vec_q) {
    constexpr int nc = HDP / 8;
    #pragma unroll 1
    for (int i = tid; i < kRows * nc; i += nth) {
      const int r = i / nc, c = i - r * nc;
      const bool ok = r < rows && c * 8 < hd;
      cp_async16(smem_u32(sQ + r * LD + c * 8), ok ? q + (long long)r * p.q_sh + c * 8 : q,
                 ok ? 16 : 0);
    }
  } else {
    #pragma unroll 1
    for (int i = tid; i < kRows * HDP; i += nth) {
      const int r = i / HDP, d = i - r * HDP;
      sQ[r * LD + d] = r < rows && d < hd ? q[(long long)r * p.q_sh + d] : __float2bfloat16(0.f);
    }
  }
}

// Slots w0 .. w0 + 15 of K and V into one stage (K rows, then V rows); zero
// at and past w_end. With 16-byte copies lane (lr, lc) copies column chunk
// lc of rows lr, lr + rs, ... (rs = 32 / chunks per row; lr >= rs: idle).
template <int HDP>
__device__ __forceinline__ void load_tile(const Params& p, __nv_bfloat16* sK,
                                          const __nv_bfloat16* k, const __nv_bfloat16* v,
                                          int w0, int w_end, int lane, int lr, int lc, int rs) {
  constexpr int LD = HDP + 8;
  __nv_bfloat16* sV = sK + kBK * LD;
  const int hd = p.hd;
  if (p.vec_kv) {
    if (lr >= rs) return;
    uint32_t dst = smem_u32(sK + lr * LD + lc * 8);
    const __nv_bfloat16* kp = k + (long long)(w0 + lr) * p.k_sw + lc * 8;
    const __nv_bfloat16* vp = v + (long long)(w0 + lr) * p.v_sw + lc * 8;
    const long long kst = rs * p.k_sw, vst = rs * p.v_sw;
    #pragma unroll 1
    for (int r = lr; r < kBK; r += rs, kp += kst, vp += vst, dst += rs * LD * 2) {
      const bool ok = w0 + r < w_end;
      cp_async16(dst, ok ? kp : k, ok ? 16 : 0);
      cp_async16(dst + kBK * LD * 2, ok ? vp : v, ok ? 16 : 0);
    }
  } else {
    #pragma unroll 1
    for (int i = lane; i < kBK * hd; i += 32) {
      const int r = i / hd, d = i - r * hd;
      __nv_bfloat16 kx = __float2bfloat16(0.f), vx = kx;
      if (w0 + r < w_end) {
        kx = k[(long long)(w0 + r) * p.k_sw + d];
        vx = v[(long long)(w0 + r) * p.v_sw + d];
      }
      sK[r * LD + d] = kx;
      sV[r * LD + d] = vx;
    }
  }
}

// Lane t holds rows t/4 and t/4 + 8 of the 16-row group, and of each 8-slot
// (or 8-column) n-tile the columns 2*(t%4) and that + 1: registers 0, 1 on
// the first row, 2, 3 on the second.
template <int HDP>
__global__ void __launch_bounds__(kWarps * 32) decode_mma_kernel(const Params p) {
  constexpr int LD = HDP + 8;
  constexpr int KS = HDP / 16;            // k-steps of S, column pairs of O
  constexpr int STAGE = 2 * kBK * LD;     // bf16 per stage: K, then V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = p.nwarps;
  const int split = blockIdx.x, kvh = blockIdx.y / p.ngroups;
  const int grp = blockIdx.y - kvh * p.ngroups, b = blockIdx.z;
  const int g0 = grp * kRows, rows = min(kRows, p.G - g0);
  const int hd = p.hd;
  const int w_begin = split * p.chunk, w_end = min(p.W, w_begin + p.chunk);
  const int ntiles = w_end > w_begin ? (w_end - w_begin + kBK - 1) / kBK : 0;
  const int my_tiles = warp < ntiles ? (ntiles - warp + nw - 1) / nw : 0;   // tiles warp, warp + nw, ...

  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  uint16_t* tmask = reinterpret_cast<uint16_t*>(smem_raw + kRows * LD * 2) + warp * p.tpw;
  float* recv = reinterpret_cast<float*>(smem_raw + kRows * LD * 2 +
                                         ((nw * p.tpw * 2 + 15) & ~15));
  unsigned char* body = reinterpret_cast<unsigned char*>(recv) +
                        recv_bytes(min(kRows, p.G), p.hd, p.nsplit);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(body) + warp * p.nstages * STAGE;
  float* fbuf = reinterpret_cast<float*>(body);    // after the tiles: merge scratch

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb +
                           (long long)(kvh * p.G + g0) * p.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  cluster_arrive();
  load_q<HDP>(p, sQ, q, rows, tid, nw * 32);
  cp_async_commit();

  // valid bits of the warp's tiles: lane l reads slots 4*(l%4) .. + 3 of
  // tile j0 + l/4, the quad ORs its nibbles into the tile's 16-bit mask
  #pragma unroll 1
  for (int j0 = 0; j0 < my_tiles; j0 += 8) {
    const int j = j0 + (lane >> 2), qd = lane & 3;
    unsigned bits = 0;
    if (j < my_tiles) bits = valid_bits4(p, w_begin + (warp + j * nw) * kBK + 4 * qd, w_end) << (4 * qd);
    bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
    bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
    if (qd == 0 && j < my_tiles) tmask[j] = (uint16_t)bits;
  }
  // K columns hd .. HDP meet Q's zeros in S but are never copied: zero them
  if (hd < HDP) {
    const int pad = HDP - hd;
    #pragma unroll 1
    for (int i = lane; i < p.nstages * kBK * pad; i += 32) {
      const int s = i / (kBK * pad), rem = i - s * kBK * pad;
      const int r = rem / pad, c = hd + rem - r * pad;
      ring[s * STAGE + r * LD + c] = __float2bfloat16(0.f);
    }
  }
  __syncwarp();

  // the first nstages tiles with a valid slot in flight, one copy group each;
  // lane (lr, lc) copies 16-byte column chunk lc of rows lr, lr + rs, ...
  constexpr int NCP = HDP / 8;            // chunks of a row when hd == HDP
  const int nc = hd == HDP ? NCP : hd >> 3;
  const int rs = hd == HDP ? 32 / NCP : nc > 0 ? 32 / nc : 0;
  const int lr = hd == HDP ? lane / NCP : nc > 0 ? lane / nc : 0;
  const int lc = lane - lr * nc;
  int j_load = next_tile(tmask, 0, my_tiles);
  #pragma unroll 1
  for (int s = 0; s < p.nstages; ++s) {
    if (j_load < my_tiles) {
      load_tile<HDP>(p, ring + s * STAGE, k, v, w_begin + (warp + j_load * nw) * kBK, w_end,
                     lane, lr, lc, rs);
      j_load = next_tile(tmask, j_load + 1, my_tiles);
    }
    cp_async_commit();
  }

  cp_async_wait_upto(p.nstages);          // Q's group, older than the stages'
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldsm_x4(smem_u32(sQ + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + ks * 16 + (lane >> 4) * 8),
            qf[ks]);

  float o[2 * KS][4];
#pragma unroll
  for (int nt = 0; nt < 2 * KS; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;   // rows t/4, t/4 + 8 (log2 units)
  const float sl2 = p.scale * 1.4426950408889634f;            // hd^-0.5 * log2(e)
  const int t2 = 2 * (lane & 3);
  // ldmatrix row addresses: K as (slot, column) for S's B, V transposed for O's B
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
  const int v_off = kBK * LD + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
  int n = 0;
  for (int j = next_tile(tmask, 0, my_tiles); j < my_tiles;
       j = next_tile(tmask, j + 1, my_tiles), ++n) {
    const int st = n % p.nstages;
    cp_async_wait_upto(p.nstages - 1);    // tile n's group has landed
    __syncwarp();
    const __nv_bfloat16* stage = ring + st * STAGE;
    const uint32_t aK = smem_u32(stage + k_off), aV = smem_u32(stage + v_off);

    // slots 0-7 and 8-15, even and odd k-steps in separate chains
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float s2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {    // hd is zero-padded to HDP: no guard
      uint32_t kb[4];
      ldsm_x4(aK + ks * 32, kb);
      float (&acc)[2][4] = ks & 1 ? s2 : s;
      mma16816(acc[0], qf[ks], kb[0], kb[1]);
      mma16816(acc[1], qf[ks], kb[2], kb[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[h][e] += s2[h][e];

    const unsigned bits = tmask[j];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[h][e] = (bits >> (8 * h + t2 + (e & 1))) & 1u ? s[h][e] * sl2 : -INFINITY;
    float mx0 = fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1]));
    float mx1 = fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3]));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // the tile holds a valid slot, so both maxima are finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);     // 0 on the first tile
    m0 = mn0;
    m1 = mn1;
    float pr[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      pr[h][0] = ex2(s[h][0] - mn0);
      pr[h][1] = ex2(s[h][1] - mn0);
      pr[h][2] = ex2(s[h][2] - mn1);
      pr[h][3] = ex2(s[h][3] - mn1);
    }
    l0 = l0 * a0 + ((pr[0][0] + pr[0][1]) + (pr[1][0] + pr[1][1]));
    l1 = l1 * a1 + ((pr[0][2] + pr[0][3]) + (pr[1][2] + pr[1][3]));
    if (n > 0) {                          // O is 0 before the warp's first tile
#pragma unroll
      for (int nt = 0; nt < 2 * KS; ++nt) {
        o[nt][0] *= a0;
        o[nt][1] *= a0;
        o[nt][2] *= a1;
        o[nt][3] *= a1;
      }
    }
    const uint32_t pa[4] = {pack_bf16(pr[0][0], pr[0][1]), pack_bf16(pr[0][2], pr[0][3]),
                            pack_bf16(pr[1][0], pr[1][1]), pack_bf16(pr[1][2], pr[1][3])};
#pragma unroll
    for (int np = 0; np < KS; ++np) {    // columns past hd are never stored
      uint32_t vb[4];
      ldsm_x4_t(aV + np * 32, vb);
      mma16816(o[2 * np], pa, vb[0], vb[1]);
      mma16816(o[2 * np + 1], pa, vb[2], vb[3]);
    }
    __syncwarp();                         // every lane is done with the stage: refill it
    if (j_load < my_tiles) {
      load_tile<HDP>(p, ring + st * STAGE, k, v, w_begin + (warp + j_load * nw) * kBK, w_end,
                     lane, lr, lc, rs);
      j_load = next_tile(tmask, j_load + 1, my_tiles);
    }
    cp_async_commit();
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  // the warps' (m, l, O) through shared memory
  cp_async_wait<0>();
  __syncthreads();                        // every warp is done with its ring
  // rows of sO are so_ld floats, so_ld % 32 == 8: a warp's 8-byte stores of
  // its fragments (8 rows x 8 columns) hit every bank once per half-warp
  const int so_ld = ((hd + 31) & ~31) + 8;
  float* sO = fbuf;                       // nw x kRows x so_ld
  float* sM = sO + nw * kRows * so_ld;    // nw x kRows
  float* sL = sM + nw * kRows;            // nw x kRows
  float* sBM = sL + nw * kRows;           // kRows: the block's M and L
  float* sBL = sBM + kRows;
  float* sWt = sBL + kRows;               // nw x kRows: each warp's weight
  const int g = lane >> 2;
  if ((lane & 3) == 0) {
    sM[warp * kRows + g] = m0;
    sM[warp * kRows + g + 8] = m1;
    sL[warp * kRows + g] = l0;
    sL[warp * kRows + g + 8] = l1;
  }
  float* o0 = sO + (warp * kRows + g) * so_ld + t2;
  float* o1 = o0 + 8 * so_ld;
#pragma unroll
  for (int nt = 0; nt < 2 * KS; ++nt) {
    if (nt * 8 < hd) {                    // columns past hd land in the row's padding
      *reinterpret_cast<float2*>(o0 + nt * 8) = make_float2(o[nt][0], o[nt][1]);
      *reinterpret_cast<float2*>(o1 + nt * 8) = make_float2(o[nt][2], o[nt][3]);
    }
  }
  __syncthreads();
  // the block's partial: per row M = max m_w, L, and the warps' O weighed by
  // e^(m_w - M) (0 for a warp without tiles) summed into warp 0's rows; L = 0
  // if the chunk holds no valid slot
  if (tid < kRows) {
    float M = -INFINITY, L = 0.f, mw[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mw[w] = w < nw ? sM[w * kRows + tid] : -INFINITY;
      M = fmaxf(M, mw[w]);
    }
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = mw[w] > -INFINITY ? ex2(mw[w] - M) : 0.f;
      if (w < nw) {
        sWt[w * kRows + tid] = wt;
        L = fmaf(wt, sL[w * kRows + tid], L);
      }
    }
    sBM[tid] = M;
    sBL[tid] = L;
  }
  // the block's (M, L) to every block of the cluster, and each element of
  // its partial, O summed over the warps, to the block that merges it
  const uint32_t rv = smem_u32(recv);
  const Slice sl = slice_of(rows, hd, p.nsplit);
  const bool any = __syncthreads_or(m0 > -INFINITY);
  cluster_wait();
  push_ml(sBM, sBL, rows, p.nsplit, rv);
  if (any) {
    const int nth = nw * 32, dr = nth / sl.hv, dc = nth - dr * sl.hv;
    int r = tid / sl.hv, c = tid - r * sl.hv;
#pragma unroll 1
    for (int e = tid; e < sl.n; e += nth, r += dr, c += dc) {   // element e at (r, c)
      if (c >= sl.hv) {
        c -= sl.hv;
        ++r;
      }
      const float* src = sO + r * so_ld + sl.vw * c;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (sl.vw == 4) {
        float4 x[kWarps];                 // every warp's value loaded before any is summed
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          if (w < nw) x[w] = *reinterpret_cast<const float4*>(src + w * kRows * so_ld);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          if (w < nw) {
            const float wt = sWt[w * kRows + r];
            a.x = fmaf(wt, x[w].x, a.x);
            a.y = fmaf(wt, x[w].y, a.y);
            a.z = fmaf(wt, x[w].z, a.z);
            a.w = fmaf(wt, x[w].w, a.w);
          }
        }
      } else {
#pragma unroll 1
        for (int w = 0; w < nw; ++w) a.x = fmaf(sWt[w * kRows + r], src[w * kRows * so_ld], a.x);
      }
      push_acc(sl, e, a, rv);
    }
  }
  cluster_sync();                         // every block's sends have landed
  merge_received<__nv_bfloat16, true>(p, b, kvh, g0, rows, recv, sWt + nw * kRows);
}

long long lmax(long long a, long long b) { return a > b ? a : b; }

// Launches `kernel` with the grid's x (the chunks) as one cluster; with
// `occ`, launches nothing and sets occ[0] to the grid's clusters and occ[1]
// to how many of them the device holds at once.
template <typename Kernel>
cudaError_t launch_cluster(Kernel kernel, const Params& p, dim3 grid, int threads,
                           long long smem, int* allowed, cudaStream_t stream, int* occ) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, (int)smem, allowed);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (occ) {
    occ[0] = (int)(grid.y * grid.z);
    return cudaOccupancyMaxActiveClusters(&occ[1], (const void*)kernel, &cfg);
  }
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_simt(const Params& p, int B, cudaStream_t stream, int* occ) {
  static int allowed[kMaxDevices];
  return launch_cluster(decode_partial_kernel<T>, p, dim3(p.nsplit, p.KV, B), kSimtThreads,
                        simt_smem_bytes(p.G, p.hd, p.nsplit), allowed, stream, occ);
}

template <int HDP>
cudaError_t launch_mma(Params& p, int B, cudaStream_t stream, int* occ) {
  static int allowed[kMaxDevices];
  const int tiles = p.chunk / kBK;
  p.nwarps = tiles < kWarps ? tiles : kWarps;
  p.tpw = (tiles + p.nwarps - 1) / p.nwarps;
  const long long ld = HDP + 8, so_ld = ((p.hd + 31) & ~31) + 8;
  const long long head = kRows * ld * 2 + ((p.nwarps * p.tpw * 2 + 15) & ~15) +
                         recv_bytes(p.G < kRows ? p.G : kRows, p.hd, p.nsplit);
  const long long stage = 2LL * kBK * ld * 2;
  const long long tail = 4LL * p.nwarps * kRows * (so_ld + 3) + 8LL * kRows +
                         merge_bytes(p.nsplit, kRows);
  // the ring's stages per warp: up to kStages, as many as shared memory holds
  p.nstages = p.tpw < kStages ? p.tpw : kStages;
  while (p.nstages > 1 && head + p.nwarps * p.nstages * stage > kMaxSmem) --p.nstages;
  const long long smem = head + lmax(p.nwarps * p.nstages * stage, tail);
  return launch_cluster(decode_mma_kernel<HDP>, p, dim3(p.nsplit, p.KV * p.ngroups, B),
                        p.nwarps * 32, smem, allowed, stream, occ);
}

// A stride allows 16-byte copies if it is a positive multiple of 8 elements
// or its dimension has one entry (then it is never applied).
bool aligned8(long long stride, int n) { return n == 1 || (stride > 0 && stride % 8 == 0); }

// dtype: 0 fp32, 1 bf16. W in nsplit chunks of chunk slots (a multiple of
// kBK; chunk * nsplit >= W), one cluster of nsplit <= kMaxCluster blocks.
// With `occ`, launches nothing and gives the plan's occupancy (launch_cluster).
cudaError_t run(int dtype, const void* q, const void* k, const void* v, const int* valid,
                void* o, int B, int H, int KV, int W, int hd, int nsplit, int chunk,
                long long q_sb, long long q_sh, long long k_sb, long long k_sh,
                long long k_sw, long long v_sb, long long v_sh, long long v_sw,
                long long o_sb, long long o_sh, cudaStream_t st, int* occ) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || W <= 0 || nsplit <= 0 ||
      nsplit > kMaxCluster || chunk <= 0 || chunk % kBK != 0 ||
      (long long)chunk * nsplit < W)
    return cudaErrorInvalidValue;
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.valid = valid; p.o = o;
  p.KV = KV; p.G = H / KV; p.W = W; p.hd = hd; p.nsplit = nsplit; p.chunk = chunk;
  p.ngroups = (p.G + kRows - 1) / kRows;
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sw = k_sw;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sw = v_sw;
  p.o_sb = o_sb; p.o_sh = o_sh;
  p.scale = (float)(1.0 / sqrt((double)hd));   // hd ** -0.5, as the reference
  if (dtype == 0) return launch_simt<float>(p, B, st, occ);
  if (dtype != 1) return cudaErrorInvalidValue;
  if (hd > 256) return launch_simt<__nv_bfloat16>(p, B, st, occ);
  p.vec_q = hd % 8 == 0 && (uintptr_t)q % 16 == 0 && aligned8(q_sb, B) && aligned8(q_sh, H);
  p.vec_kv = hd % 8 == 0 && (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0 &&
             aligned8(k_sb, B) && aligned8(k_sh, KV) && aligned8(k_sw, W) &&
             aligned8(v_sb, B) && aligned8(v_sh, KV) && aligned8(v_sw, W);
  p.vec_valid = (uintptr_t)valid % 16 == 0;
  if (hd <= 64) return launch_mma<64>(p, B, st, occ);
  if (hd <= 128) return launch_mma<128>(p, B, st, occ);
  return launch_mma<256>(p, B, st, occ);
}

}  // namespace

extern "C" {

// Launches the call (see run). Returns a cudaError_t (0 = launched;
// cudaErrorInvalidValue also when a block would need more shared memory
// than it has).
int decode_attention_launch(int dtype, const void* q, const void* k, const void* v,
                            const int* valid, void* o, int B, int H, int KV, int W, int hd,
                            int nsplit, int chunk, long long q_sb, long long q_sh,
                            long long k_sb, long long k_sh, long long k_sw,
                            long long v_sb, long long v_sh, long long v_sw,
                            long long o_sb, long long o_sh, void* stream) {
  return (int)run(dtype, q, k, v, valid, o, B, H, KV, W, hd, nsplit, chunk, q_sb, q_sh,
                  k_sb, k_sh, k_sw, v_sb, v_sh, v_sw, o_sb, o_sh,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// The occupancy of a plan on the current device, launching nothing:
// occ[0] the clusters of the call's grid, occ[1] how many clusters of its
// kernel, block and shared memory size the device holds at once (a cluster
// lies in one GPC). Returns a cudaError_t.
int decode_attention_occupancy(int dtype, int B, int H, int KV, int W, int hd, int nsplit,
                               int chunk, int* occ) {
  return (int)run(dtype, nullptr, nullptr, nullptr, nullptr, nullptr, B, H, KV, W, hd,
                  nsplit, chunk, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, nullptr, occ);
}

}  // extern "C"
