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
// 4,096; yi-6b: 32 heads of 128 on 4, 4,096 tokens; recurrentgemma-2b: 10
// heads of 256 on 1, 8,192 tokens, window 2,048) that is about 3,000,
// 2,300 and 2,000 flops per byte that must move (q, k, v, o, dO in; dq, dk,
// dv out), far above the card's 295, so operations bound it: 989 TFLOP/s
// for bf16 on the tensor cores; for fp32 the tensor cores' 495 TFLOP/s of
// TF32 over the three TF32 products each fp32 product takes, 165 TFLOP/s.
// Two kernels without atomics recompute S and dP in both, seven products;
// the single kernel that adds dQ by atomics does five but gives other bits
// from run to run.
//
// Routes, chosen from the dtype alone by the caller (flash_attention.
// bwd_route), which passes the route to the entry; both run on the tensor
// cores at every hd up to 256:
//
//  * bf16, any hd: the tensor cores, wgmma with fp32 accumulation, two
//    warpgroups a block, the forward's 128-byte swizzle and descriptors
//    (hopper.cuh). P and dS are rounded to bf16 before the products that
//    take them, as FlashAttention-2 and -3 round them.
//  . hd <= 128 (danube hd 80, yi-6b and qwen2-vl-2b 128, the enc-dec 64):
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
//      in registers, each rounded to bf16 as the A operand of dV += P^T dO
//      and dK += dS^T Q, Q and dO through the MN-major descriptor. lse and D
//      of the next round's rows go to shared memory during the current one.
//      Blocks of the first keys run first. The block's keys follow the mask
//      (the caller's rule, flash_attention.bwd_keys, passes them to the
//      entry):
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
//  . 128 < hd <= 256 (recurrentgemma-2b's hd 256, the 100M twin's 192):
//    the wide kernels, tiles at HDP = 256 (32 KB a 64-row tile). The
//    narrow design does not fit there: fp32 dK and dV of 64 keys x 256
//    columns in one warpgroup are 2 x 128 registers a thread beside S and
//    dP (at most 255), and a 128-row dQ block leaves shared memory for one
//    K/V slot. So each warpgroup owns half of hd's columns of every
//    accumulator (m64n128, 64 registers), and the two products over hd of a
//    tile are split by matrix: warpgroup 0 takes the scores, warpgroup 1
//    dP. Each hands the other, in fp32 through shared memory (16 KB), the
//    half of its accumulator that the other finishes; each finishes P and
//    dS for 32 of the tile's 64 columns and stores them as bf16 in the
//    128-byte swizzle; after a barrier both take the staged tiles as the
//    shared-memory A operand of their m64n128 products (B through the
//    MN-major descriptor at their first column block). Two barriers a tile.
//    - flash_bwd_dq_wide_kernel: 64 packed query rows (the G heads times
//      64/G positions: at recurrentgemma-2b's G = 10, 6 positions and 60
//      rows, 4 of 64 idle), Q and dO resident by cp.async (64 KB), 64-key
//      K/V tiles by TMA through a ring of 2 slots (128 KB), issued by one
//      thread a tile ahead; dS staged (8 KB); dQ[:, half] += dS K[:, half].
//      Writes D to dsum. Last rows first.
//    - flash_bwd_dkdv_wide_kernel: 64 keys of one kv head (recurrentgemma-
//      2b's 8,192 keys: 128 blocks, one wave on 132 SMs), K and V resident
//      by TMA (64 KB), the 64-row Q/dO tiles of the G heads whose band
//      reaches the keys through a ring of 2 slots (128 KB), both warpgroups
//      on every tile; P^T and dS^T staged (2 x 8 KB); dV[:, half] += P^T
//      dO[:, half] and dK[:, half] += dS^T Q[:, half]. 225 KB of shared
//      memory. Empty-band rows, GQA's sum over the G heads inside the block
//      and the first keys first as flash_bwd_dkdv_mma_kernel.
//    One instantiation serves hd 129-256: the TMA unit and cp.async zero-
//    fill columns past hd inside a block they load, the column blocks they
//    do not load are zeroed once, and every product runs over 256 columns.
//  * fp32, any hd: split-TF32 products on the tensor cores (mma.sync
//    m16n8k8, fp32 accumulation): flash_bwd_dq_tf32_kernel, then
//    flash_bwd_dkdv_tf32_kernel. One TF32 product (10 mantissa bits) misses
//    the 2e-5 kernel tolerance by two orders; so each operand x is split in
//    registers, as its fragment is loaded, into big = tf32(x) and small =
//    tf32(x - big) (cvt.rna: the tensor cores would truncate a plain fp32
//    register), and every product, the two recomputed ones (S, dP)
//    included, is big.small + small.big, then big.big, accumulated in fp32:
//    165 TFLOP/s of fp32-accurate products against the CUDA cores' 67. wgmma takes TF32 only K-major, and three of the
//    products read an operand along its rows (K in dQ += dS K, Q and dO in
//    dK and dV); mma.sync fragments are loaded from shared memory in any
//    layout. Tiles are stored row-major with rows of hd padded to HDP (64,
//    80, 128, 192 or 256, zero-filled) + 4 floats, so the K-major fragments
//    come by ldmatrix (8 rows x 4 fp32 a matrix) and the transposed ones by
//    32-bit loads, a key or row pair (2 tig, 2 tig + 1) in the places of k
//    = tig, tig + 4 of a k-step (A takes dS, P^T or dS^T from shared
//    memory in the same order), both without bank conflicts.
//    - flash_bwd_dq_tf32_kernel: 16, 32 or 64 positions of one query head,
//      Q and dO resident by cp.async, 32-key K/V tiles by cp.async, the next
//      in flight while one is multiplied. Each warp owns 16 rows; past hd
//      128 two warps split a tile's keys (S, dP) and hd's columns (dQ),
//      whose 16 x 256 accumulator alone would be 128 registers a thread.
//      dS goes through shared memory. Writes D to dsum. Last rows first.
//    - flash_bwd_dkdv_tf32_kernel: 16, 32 or 64 keys of one kv head, K and
//      V resident, the 32-row Q/dO tiles of the G heads whose band reaches
//      them by cp.async, the next in flight; lse and D of a tile's rows in
//      shared memory. Each warp owns 16 keys; past hd 80 two warps split a
//      tile's rows and hd's columns. P^T and dS^T go through shared
//      memory. Empty-band rows, GQA's sum over the G heads inside the block
//      and the first keys first as the bf16 kernels.
//    The caller chooses both blocks from the shape (flash_attention.
//    bwd_tf32_blocks), the largest whose grid fills the card's 132 SMs (the
//    100M twin's (4,4,4,256,256,192): 16 positions and 16 keys, 256 blocks
//    a kernel); 32 at most past hd 192, where Q and dO of 64 rows (133 KB)
//    and two stages of K and V (133 KB) would not fit in 227 KB.
//  Every route takes lse from the forward. The entry refuses a route that
//  is not its dtype's.
#include <limits.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kNegInf = -1e30f;      // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxGroup = 64;          // query heads per kv head

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
  int H, KV, G, Sq, Sk, hd;
  int bq;            // positions of a query head a dq block (the bf16 route packs G heads' bq)
  int bk;            // keys a dK/dV block (split-TF32 route)
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

// lse (+inf for a row past Sq or whose band is empty: P = 0) and D of query
// row `row` of head h, for the dk/dv kernels' tile of that row
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

// --------------------------------------------------------------------------
// fp32 route: split-TF32 products on the tensor cores (mma.sync m16n8k8)
// --------------------------------------------------------------------------
namespace tf32 {

constexpr int kTile = 32;              // keys a K/V tile (dq), rows a Q/dO tile (dk/dv)
constexpr int kLS = kTile + 8;         // row stride of the staged dS, P^T, dS^T (floats)
constexpr int kMaxThreads = 256;

// A tile of HDP columns is stored with rows of LD = HDP + 4 floats (4 mod
// 8): the 8 rows of an ldmatrix phase and the 2 x 4 rows x 8 columns of a
// transposed fragment load fall in 32 different banks. WQ (dq) and WK
// (dk/dv) warps split each 16 rows' accumulator columns (HQ, HK of them)
// and a tile's keys or rows (NQ, NK) between them.
template <int HDP>
struct Cfg {
  static constexpr int LD = HDP + 4;
  static constexpr int WQ = HDP > 128 ? 2 : 1;
  static constexpr int WK = HDP > 80 ? 2 : 1;
  static constexpr int HQ = HDP / WQ, HK = HDP / WK;
  static constexpr int NQ = kTile / WQ, NK = kTile / WK;
  // positions a dQ block and keys a dK/dV block at most: 8 warps, and shared
  // memory (Q and dO of 64 rows at hd 256 alone are 133 KB)
  static constexpr int kMaxRows = HDP <= 128 ? 128 : (HDP <= 192 ? 64 : 32);
  static constexpr int kMaxKeys = HDP <= 80 ? 128 : (HDP <= 192 ? 64 : 32);
  static size_t dq_smem(int rows) {    // Q, dO, two stages of K and V, dS
    return sizeof(float) * ((size_t)2 * rows * LD + 4 * kTile * LD + (size_t)rows * kLS);
  }
  static size_t dkdv_smem(int keys) {  // K, V, two stages of Q and dO, P^T, dS^T
    return sizeof(float) * ((size_t)2 * keys * LD + 4 * kTile * LD + (size_t)2 * keys * kLS);
  }
};

// Rows row0 .. row0 + n - 1 of an (S, hd) fp32 matrix at src (row stride ss)
// into a tile of row stride LD by 16-byte cp.async, zero past S and hd (not
// committed).
template <int HDP>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long ss, int row0,
                                          int n, int S, int hd) {
  constexpr int kChunks = HDP / 4;
  for (int i = threadIdx.x; i < n * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool ok = row0 + r < S && c * 4 < hd;
    cp_async16(smem_u32(dst + r * Cfg<HDP>::LD + c * 4),
               ok ? src + (long long)(row0 + r) * ss + c * 4 : src,
               ok ? min(16, 4 * (hd - c * 4)) : 0);
  }
}

// acc (16 x 8 tiles, C fragments) of row `row` (this thread's) and the one
// 8 below, those below nrows, times mul into out (rows of hd floats), from
// column col0
template <int NT>
__device__ __forceinline__ void store_acc(float* out, const float (&acc)[NT][4], float mul,
                                          int row, int nrows, int hd, int col0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (row + 8 * hh >= nrows) continue;
    float* o = out + (long long)(row + 8 * hh) * hd;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int d = col0 + 8 * j + 2 * (lane & 3);
      const float x0 = acc[j][2 * hh] * mul, x1 = acc[j][2 * hh + 1] * mul;
      if (hd % 2 == 0 && d + 1 < hd) {
        *reinterpret_cast<float2*>(o + d) = make_float2(x0, x1);
      } else {
        if (d < hd) o[d] = x0;
        if (d + 1 < hd) o[d + 1] = x1;
      }
    }
  }
}

// s = A B^T and dp = A2 B2^T over hd (S and dP in the dq kernel, S^T and
// dP^T in the dk/dv kernel) for this warp's 16 rows and NS columns: A, A2
// the ldmatrix addresses of the warp's 16 rows of the resident tiles (Q and
// dO, or K and V), B, B2 those of its NS rows of the streamed tile. Each 32
// columns of hd (four k-steps) are summed from zero on the tensor cores,
// then added in fp32 on the CUDA cores, as tile_product does.
template <int HDP, int NS>
__device__ __forceinline__ void scores(float (&s)[NS / 8][4], float (&dp)[NS / 8][4], uint32_t a,
                                       uint32_t a2, uint32_t b, uint32_t b2) {
  constexpr int LD = Cfg<HDP>::LD;
#pragma unroll
  for (int j = 0; j < NS / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll 1
  for (int kc = 0; kc < HDP / 8; kc += 4) {
    float ts[NS / 8][4], tp[NS / 8][4];
#pragma unroll
    for (int j = 0; j < NS / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) ts[j][i] = tp[j][i] = 0.f;
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      const int kk = kc + kq;
      if (HDP % 32 != 0 && kk >= HDP / 8) break;
      uint32_t r[4], xb[4], xs[4], yb[4], ys[4];
      ldsm4(r, a + kk * 32);
      split_regs(r, xb, xs);
      ldsm4(r, a2 + kk * 32);
      split_regs(r, yb, ys);
#pragma unroll
      for (int j = 0; j < NS / 16; ++j) {      // two 8-column n-tiles an ldmatrix
        uint32_t bb[4], bs[4], cb[4], cs[4];
        ldsm4(r, b + j * 16 * LD * 4 + kk * 32);
        split_regs(r, bb, bs);
        ldsm4(r, b2 + j * 16 * LD * 4 + kk * 32);
        split_regs(r, cb, cs);
        mma3(ts[2 * j], xb, xs, bb, bs);
        mma3(ts[2 * j + 1], xb, xs, bb + 2, bs + 2);
        mma3(tp[2 * j], yb, ys, cb, cs);
        mma3(tp[2 * j + 1], yb, ys, cb + 2, cs + 2);
      }
    }
#pragma unroll
    for (int j = 0; j < NS / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] += ts[j][i];
        dp[j][i] += tp[j][i];
      }
  }
}

// out[:, HC columns] += A B over a tile's 32 keys (dq) or rows (dk/dv): A
// the staged 16 x 32 tile (dS, P^T or dS^T) at this thread's pair `a`
// (row gid, columns 2 tig, 2 tig + 1), B the 32 x HC tile at `bt` (row 2
// tig, column gid of this warp's columns). For each 8-column n-tile the
// four k-steps of 8 are summed from zero on the tensor cores, then added to
// out on the CUDA cores (fp32, round to nearest): mma.sync adds by
// truncation, and the bias of a chain over thousands of keys or rows would
// miss the tolerance.
template <int HC, int LD>
__device__ __forceinline__ void tile_product(float (&out)[HC / 8][4], const float* a,
                                             const float* bt) {
  uint32_t ab[kTile / 8][4], as[kTile / 8][4];
#pragma unroll
  for (int kk = 0; kk < kTile / 8; ++kk) {
    const float2 x0 = *reinterpret_cast<const float2*>(a + 8 * kk);
    const float2 x1 = *reinterpret_cast<const float2*>(a + 8 * kk + 8 * kLS);
    split(x0.x, ab[kk][0], as[kk][0]);
    split(x1.x, ab[kk][1], as[kk][1]);
    split(x0.y, ab[kk][2], as[kk][2]);
    split(x1.y, ab[kk][3], as[kk][3]);
  }
#pragma unroll
  for (int j = 0; j < HC / 8; ++j) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kTile / 8; ++kk) {
      uint32_t bb[2], bs[2];
      split(bt[8 * kk * LD + 8 * j], bb[0], bs[0]);
      split(bt[8 * kk * LD + 8 * j + LD], bb[1], bs[1]);
      mma3(acc, ab[kk], as[kk], bb, bs);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) out[j][i] += acc[i];
  }
}

// dQ and D: `rows` (p.bq: 16, 32, 64 or 128) positions of query head h. Warp w
// owns rows 16 (w / WQ) .. + 15 of the block: S and dP of NQ keys of each
// tile, dQ of HQ columns. Per 32-key tile (K/V by cp.async, the next tile in
// flight while this one is multiplied): S = Q K^T and dP = dO V^T (Q, dO, K,
// V fragments by ldmatrix), P and dS = P (dP - D) in registers, dS staged in
// shared memory, dQ += dS K (K read transposed, a key pair 2 tig, 2 tig + 1
// in the places of k = tig, tig + 4 of the k-step, in A as in B). The last
// rows run first: under a causal mask they see the most keys.
template <int HDP>
__global__ void __launch_bounds__(kMaxThreads, 1) flash_bwd_dq_tf32_kernel(const BwdParams p) {
  using C = Cfg<HDP>;
  constexpr int LD = C::LD, W = C::WQ, HC = C::HQ, NS = C::NQ;
  extern __shared__ float4 smem4[];
  float* const Qs = reinterpret_cast<float*>(smem4);
  const int rows = p.bq;
  float* const Gs = Qs + rows * LD;          // dO
  float* const KVs = Gs + rows * LD;         // stage s: K at KVs + 2 s kTile LD, then V
  float* const dS = KVs + 4 * kTile * LD;    // rows x kLS
  __shared__ float Ls[128], Ds[128];
  __shared__ int krange[2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * rows, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.G;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dO = static_cast<const float*>(p.dout) + b * p.d_sb + h * p.d_sh;
  const float* o = static_cast<const float*>(p.o) + b * p.o_sb + h * p.o_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  if (tid == 0) {
    krange[0] = INT_MAX;
    krange[1] = -1;
  }
  load_rows<HDP>(Qs, q, p.q_ss, q0, rows, p.Sq, p.hd);
  load_rows<HDP>(Gs, dO, p.d_ss, q0, rows, p.Sq, p.hd);
  cp_async_commit();
  __syncthreads();                     // krange set

  // D = rowsum(dO * O) and lse (+inf where the row sees no key: P = 0), a
  // warp a row; the keys of the live rows' bands into krange
  for (int r = warp; r < rows; r += nwarps) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < p.Sq) {
      const float* grow = dO + (long long)row * p.d_ss;
      const float* orow = o + (long long)row * p.o_ss;
      for (int d = lane; d < p.hd; d += 32) acc = fmaf(grow[d], orow[d], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      int lo, hi;
      band(p, p.q_offset + row, lo, hi);
      const bool live = row < p.Sq && lo <= hi;
      const long long srow = ((long long)b * p.H + h) * p.Sq + row;
      Ls[r] = live ? p.lse[srow] : INFINITY;
      Ds[r] = acc;
      if (row < p.Sq) p.dsum[srow] = acc;
      if (live) {
        atomicMin(&krange[0], lo);
        atomicMax(&krange[1], hi);
      }
    }
  }
  __syncthreads();

  // the keys of the live rows' bands; a row with no key has no dQ
  const int kstart = krange[0], kend = krange[1] + 1;
  const int kt0 = kstart < kend ? (kstart / kTile) * kTile : 0;
  const int ntiles = kstart < kend ? (kend - kt0 + kTile - 1) / kTile : 0;
  auto fetch = [&](int n) {            // K/V tile n into stage n & 1
    float* dst = KVs + (n & 1) * 2 * kTile * LD;
    load_rows<HDP>(dst, k, p.k_ss, kt0 + n * kTile, kTile, p.Sk, p.hd);
    load_rows<HDP>(dst + kTile * LD, v, p.v_ss, kt0 + n * kTile, kTile, p.Sk, p.hd);
    cp_async_commit();
  };
  if (ntiles > 0) fetch(0);

  const int rg = warp / W, wc = warp % W, r0 = 16 * rg;
  int pos[2];
  float lse[2], D[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + gid + 8 * hh;
    pos[hh] = p.q_offset + q0 + r;
    lse[hh] = Ls[r];
    D[hh] = Ds[r];
  }
  const int qmin = p.q_offset + q0, qmax = p.q_offset + min(q0 + rows, p.Sq) - 1;
  const float sl2 = p.sl2;
  // ldmatrix: Q/dO rows r0 + t % 8 (+ 8 for t / 8 odd), columns 4 (t / 16);
  // K/V keys wc NS + t % 8 (+ 8 for t >= 16), columns 4 (t / 8 % 2)
  const uint32_t sQ = smem_u32(Qs + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                               4 * (lane >> 4));
  const uint32_t sG = sQ + rows * LD * 4;
  const uint32_t boff = ((wc * NS + (lane & 7) + 8 * (lane >> 4)) * LD + 4 * ((lane >> 3) & 1)) * 4;
  const float* dsr = dS + (r0 + gid) * kLS + 2 * tig;

  float dq[HC / 8][4];
#pragma unroll
  for (int j = 0; j < HC / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();                   // tile t in; tile t - 1's reads of its stage and dS done
    if (t + 1 < ntiles) fetch(t + 1);
    const int kt = kt0 + t * kTile;
    const float* Ks = KVs + (t & 1) * 2 * kTile * LD;
    const uint32_t sK = smem_u32(Ks) + boff, sV = sK + kTile * LD * 4;

    // S = Q K^T, dP = dO V^T over hd
    float s[NS / 8][4], dp[NS / 8][4];
    scores<HDP, NS>(s, dp, sQ, sG, sK, sV);

    // P = 2^(s sl2 - lse), masked in tiles that reach past Sk or the
    // block's band; dS = P (dP - D), staged
    const bool edge = kt + kTile > p.Sk || (p.causal && kt + kTile - 1 > qmin) ||
                      (p.has_window && kt <= qmax - p.window);
#pragma unroll
    for (int j = 0; j < NS / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hh = i >> 1;
        float pr = ex2(fmaf(s[j][i], sl2, -lse[hh]));
        if (edge) {
          const int c = kt + wc * NS + 8 * j + 2 * tig + (i & 1);
          if (c >= p.Sk || masked(p, c, pos[hh])) pr = 0.f;
        }
        s[j][i] = pr * (dp[j][i] - D[hh]);
      }
      float* d0 = dS + (r0 + gid) * kLS + wc * NS + 8 * j + 2 * tig;
      *reinterpret_cast<float2*>(d0) = make_float2(s[j][0], s[j][1]);
      *reinterpret_cast<float2*>(d0 + 8 * kLS) = make_float2(s[j][2], s[j][3]);
    }
    sync_group<W>(rg);

    // dQ[:, wc HC ..] += dS K
    tile_product<HC, LD>(dq, dsr, Ks + 2 * tig * LD + wc * HC + gid);
  }

  cp_async_wait<0>();                  // no copy outlives the block
  store_acc(static_cast<float*>(p.dq) + (((long long)b * p.H + h) * p.Sq + q0) * p.hd, dq,
            p.scale, r0 + gid, min(rows, p.Sq - q0), p.hd, wc * HC);
}

// dK and dV: `keys` (p.bk: 16, 32, 64 or 128) keys of kv head kvh over the
// 32-row Q/dO tiles (head g, rows) of the G heads whose band reaches them,
// the farthest rows first, each by cp.async, the next one in
// flight while this one is multiplied; lse and D of a tile's rows staged in
// shared memory. Warp w owns keys 16 (w / WK) .. + 15: S^T = K Q^T and dP^T
// = V dO^T of NK rows of each tile, P^T and dS^T in registers, staged; dV
// += P^T dO and dK += dS^T Q of HK columns (dO and Q read transposed, as K
// in the dq kernel). GQA's sum over the G heads stays in the block; the
// first keys run first.
template <int HDP>
__global__ void __launch_bounds__(kMaxThreads, 1)
    flash_bwd_dkdv_tf32_kernel(const BwdParams p) {
  using C = Cfg<HDP>;
  constexpr int LD = C::LD, W = C::WK, HC = C::HK, NS = C::NK;
  extern __shared__ float4 smem4[];
  float* const Ks = reinterpret_cast<float*>(smem4);
  const int keys = p.bk;
  float* const Vs = Ks + keys * LD;
  float* const QO = Vs + keys * LD;          // stage s: Q at QO + 2 s kTile LD, then dO
  float* const Pt = QO + 4 * kTile * LD;     // keys x kLS: P^T
  float* const dSt = Pt + keys * kLS;        // dS^T
  __shared__ float Ls[2][kTile], Ds[2][kTile];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int kvh = blockIdx.x % p.KV, k0 = (blockIdx.x / p.KV) * keys, b = blockIdx.y;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb;
  const float* dO = static_cast<const float*>(p.dout) + b * p.d_sb;
  const int klast = min(k0 + keys, p.Sk) - 1;
  int ibeg, iend;
  row_range(p, k0, klast, ibeg, iend);
  const int nqt = iend > ibeg ? (iend - ibeg + kTile - 1) / kTile : 0;
  const int ntiles = p.G * nqt;

  load_rows<HDP>(Ks, static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh, p.k_ss, k0,
                 keys, p.Sk, p.hd);
  load_rows<HDP>(Vs, static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh, p.v_ss, k0,
                 keys, p.Sk, p.hd);
  cp_async_commit();
  // tile u: the G heads' rows from ibeg + (nqt - 1 - u / G) 32, far rows
  // first: under a causal mask a key's largest terms come from the rows
  // nearest it, so adding them last keeps the running sums small while most
  // of the terms are added
  auto rows_of = [&](int u) { return ibeg + (nqt - 1 - u / p.G) * kTile; };
  auto fetch = [&](int u) {            // Q/dO tile u into stage u & 1
    const int it = rows_of(u);
    const long long h = kvh * p.G + u % p.G;
    float* dst = QO + (u & 1) * 2 * kTile * LD;
    load_rows<HDP>(dst, q + h * p.q_sh, p.q_ss, it, kTile, p.Sq, p.hd);
    load_rows<HDP>(dst + kTile * LD, dO + h * p.d_sh, p.d_ss, it, kTile, p.Sq, p.hd);
    cp_async_commit();
  };
  auto stats = [&](int u, float& l, float& d) {   // row tid of tile u (tid < kTile)
    l = INFINITY;
    d = 0.f;
    if (u < ntiles) row_stats(p, b, kvh * p.G + u % p.G, rows_of(u) + tid, l, d);
  };
  if (ntiles > 0) fetch(0);
  if (tid < kTile) stats(0, Ls[0][tid], Ds[0][tid]);

  const int kg = warp / W, wc = warp % W, c0 = 16 * kg;
  const int key[2] = {k0 + c0 + gid, k0 + c0 + gid + 8};
  const float sl2 = p.sl2;
  // ldmatrix: K/V keys c0 + t % 8 (+ 8 for t / 8 odd), columns 4 (t / 16);
  // Q/dO rows wc NS + t % 8 (+ 8 for t >= 16), columns 4 (t / 8 % 2)
  const uint32_t sK = smem_u32(Ks + (c0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                               4 * (lane >> 4));
  const uint32_t sV = sK + keys * LD * 4;
  const uint32_t boff = ((wc * NS + (lane & 7) + 8 * (lane >> 4)) * LD + 4 * ((lane >> 3) & 1)) * 4;
  const int pr0 = (c0 + gid) * kLS + 2 * tig;      // this thread's P^T / dS^T pairs

  float dk[HC / 8][4], dv[HC / 8][4];
#pragma unroll
  for (int j = 0; j < HC / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[j][i] = dv[j][i] = 0.f;

  for (int u = 0; u < ntiles; ++u) {
    cp_async_wait<0>();
    __syncthreads();                   // tile u (and K/V) in, its lse and D staged; tile u - 1
                                       // done with its stage, P^T, dS^T
    if (u + 1 < ntiles) fetch(u + 1);
    float nl = 0.f, nd = 0.f;          // the next tile's lse and D, stored after this tile
    const bool next = tid < kTile && u + 1 < ntiles;
    if (next) stats(u + 1, nl, nd);
    const int buf = u & 1, it = rows_of(u);
    // does the band reach the block's keys from the tile's rows, and does it
    // cover all of them (else mask)?
    const int pmin = p.q_offset + it, pmax = p.q_offset + min(it + kTile, p.Sq) - 1;
    const bool active = (!p.causal || k0 <= pmax) && (!p.has_window || klast > pmin - p.window);
    const bool edge = (p.causal && klast > pmin) || (p.has_window && k0 <= pmax - p.window);
    if (active) {                      // the same in every thread
      const float* Qt = QO + buf * 2 * kTile * LD;
      const float* Ot = Qt + kTile * LD;
      const uint32_t sQt = smem_u32(Qt) + boff, sOt = sQt + kTile * LD * 4;

      // S^T = K Q^T, dP^T = V dO^T over hd
      float s[NS / 8][4], dp[NS / 8][4];
      scores<HDP, NS>(s, dp, sK, sV, sQt, sOt);

      // P^T = 2^(s sl2 - lse), dS^T = P^T (dP^T - D); the columns are the
      // tile's rows; both staged
      const float* L = Ls[buf];
      const float* Dr = Ds[buf];
#pragma unroll
      for (int j = 0; j < NS / 8; ++j) {
        float pt[4], dst[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = wc * NS + 8 * j + 2 * tig + (i & 1);
          float pr = ex2(fmaf(s[j][i], sl2, -L[c]));
          if (edge && masked(p, key[i >> 1], p.q_offset + it + c)) pr = 0.f;
          pt[i] = pr;
          dst[i] = pr * (dp[j][i] - Dr[c]);
        }
        const int at = (c0 + gid) * kLS + wc * NS + 8 * j + 2 * tig;
        *reinterpret_cast<float2*>(Pt + at) = make_float2(pt[0], pt[1]);
        *reinterpret_cast<float2*>(Pt + at + 8 * kLS) = make_float2(pt[2], pt[3]);
        *reinterpret_cast<float2*>(dSt + at) = make_float2(dst[0], dst[1]);
        *reinterpret_cast<float2*>(dSt + at + 8 * kLS) = make_float2(dst[2], dst[3]);
      }
      sync_group<W>(kg);

      // dV[:, wc HC ..] += P^T dO, then dK[:, wc HC ..] += dS^T Q
      const int bo = 2 * tig * LD + wc * HC + gid;
      tile_product<HC, LD>(dv, Pt + pr0, Ot + bo);
      tile_product<HC, LD>(dk, dSt + pr0, Qt + bo);
    }
    if (next) {
      Ls[buf ^ 1][tid] = nl;
      Ds[buf ^ 1][tid] = nd;
    }
  }

  // rows whose band is empty: dV_j += the sum of their dO over the group / Sk
  int ie0, ie1;
  empty_rows(p, ie0, ie1);
  if (ie0 > 0 || ie1 < p.Sq) {
    float* es = QO;                    // HDP column sums, in the stages' memory
    cp_async_wait<0>();
    __syncthreads();                   // the last tile's reads are done
    for (int d = tid; d < HDP; d += blockDim.x) {
      float e = 0.f;
      if (d < p.hd) {
        for (int g = 0; g < p.G; ++g) {
          const float* gh = dO + (long long)(kvh * p.G + g) * p.d_sh + d;
          for (int part = 0; part < 2; ++part) {     // rows [0, ie0), then [ie1, Sq)
            const int rend = part ? p.Sq : ie0;
            for (int r = part ? ie1 : 0; r < rend; ++r) e += gh[(long long)r * p.d_ss];
          }
        }
      }
      es[d] = e;
    }
    __syncthreads();
    const float inv = 1.f / (float)p.Sk;
#pragma unroll
    for (int j = 0; j < HC / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dv[j][i] = fmaf(es[wc * HC + 8 * j + 2 * tig + (i & 1)], inv, dv[j][i]);
  }

  // dK (times scale) and dV of this warp's keys and columns
  cp_async_wait<0>();                  // no copy outlives the block
  const long long base = ((long long)b * p.KV + kvh) * p.Sk + k0;
  const int nk = min(keys, p.Sk - k0);
  store_acc(static_cast<float*>(p.dk) + base * p.hd, dk, p.scale, c0 + gid, nk, p.hd, wc * HC);
  store_acc(static_cast<float*>(p.dv) + base * p.hd, dv, 1.f, c0 + gid, nk, p.hd, wc * HC);
}

}  // namespace tf32

// --------------------------------------------------------------------------
// bf16 route: wgmma on the tensor cores (hd <= 128, then the wide kernels)
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

// The dq kernels' rows: Q and dO rows of the block (the G heads x bq
// positions packed in ROWS rows) by cp.async into sQ and sO, ROWS x HDP in
// the 128-byte swizzle, zero past Sq, G and hd (committed, not waited for);
// then, kThreads / ROWS threads a row, each row's lse (+inf where it sees no
// key: P = 0) into Ls and D = rowsum(dO * O) into Ds and dsum, and the
// keys of the live rows' bands into krange, which thread 0 has set.
template <int ROWS, int HDP>
__device__ __forceinline__ void stage_rows(const BwdParams& p, int q0, int kvh, int b,
                                           uint32_t sQ, uint32_t sO, float* Ls, float* Ds,
                                           int* krange) {
  constexpr int kPer = kThreads / ROWS;
  const int tid = threadIdx.x;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb;
  const __nv_bfloat16* dO = static_cast<const __nv_bfloat16*>(p.dout) + b * p.d_sb;
  for (int idx = tid; idx < ROWS * (HDP / 8); idx += kThreads) {
    const int r = idx / (HDP / 8), c = idx - r * (HDP / 8);
    const int g = r / p.bq, i = r - g * p.bq;
    const bool ok = g < p.G && q0 + i < p.Sq && c * 8 < p.hd;
    const int bytes = ok ? min(16, 2 * (p.hd - c * 8)) : 0;
    const long long h = kvh * p.G + g, row = q0 + i;
    cp_async16(sQ + swz(r, c, ROWS), ok ? q + h * p.q_sh + row * p.q_ss + c * 8 : q, bytes);
    cp_async16(sO + swz(r, c, ROWS), ok ? dO + h * p.d_sh + row * p.d_ss + c * 8 : dO, bytes);
  }
  cp_async_commit();
  __syncthreads();                     // krange set (and the caller's barriers initialised)

  const int r = tid / kPer, part = tid % kPer;
  const int g = r / p.bq, i = r - g * p.bq;
  const bool valid = g < p.G && q0 + i < p.Sq;
  const long long h = kvh * p.G + g, row = q0 + i;
  float acc = 0.f;
  if (valid) {
    const __nv_bfloat16* orow = static_cast<const __nv_bfloat16*>(p.o) + b * p.o_sb +
                                h * p.o_sh + row * p.o_ss;
    const __nv_bfloat16* grow = dO + h * p.d_sh + row * p.d_ss;
    for (int d = part; d < p.hd; d += kPer)
      acc = fmaf(__bfloat162float(grow[d]), __bfloat162float(orow[d]), acc);
  }
#pragma unroll
  for (int o = 1; o < kPer; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (part == 0) {
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

// Row h (0: the thread's first, 1: the one 8 below) of a warpgroup's
// accumulator, its columns from col0, times `mul` into `row` (hd entries)
// in bf16.
template <int N>
__device__ __forceinline__ void store_row(__nv_bfloat16* row, const float (&acc)[N], int h,
                                          float mul, int hd, int lane, int col0) {
  const bool pairs = hd % 2 == 0;
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    const int d = col0 + n * 8 + (lane & 3) * 2;
    const float x0 = acc[4 * n + 2 * h] * mul, x1 = acc[4 * n + 2 * h + 1] * mul;
    if (pairs && d + 1 < hd) {
      *reinterpret_cast<__nv_bfloat162*>(row + d) = __floats2bfloat162_rn(x0, x1);
    } else {
      if (d < hd) row[d] = __float2bfloat16(x0);
      if (d + 1 < hd) row[d + 1] = __float2bfloat16(x1);
    }
  }
}

// A dq kernel's accumulator rows (packed rows r0 and r0 + 8 of the block at
// q0), its columns from col0, times scale into dq (B, H, Sq, hd).
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N], const BwdParams& p, int b,
                                           int kvh, int q0, int r0, int lane, int col0 = 0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const int g = r / p.bq, qi = r - g * p.bq;
    if (g < p.G && q0 + qi < p.Sq)
      store_row(static_cast<__nv_bfloat16*>(p.dq) +
                    (((long long)b * p.H + kvh * p.G + g) * p.Sq + q0 + qi) * p.hd,
                acc, h, p.scale, p.hd, lane, col0);
  }
}

// The dk/dv kernels' empty-band rows: this thread's share of the sum of dO's
// column tid % HDP over the G heads' rows [0, ie0) and [ie1, Sq), the rows
// split among the kThreads / HDP groups of threads; 0 past hd.
template <int HDP>
__device__ __forceinline__ float empty_col_sum(const BwdParams& p, int b, int kvh, int ie0,
                                               int ie1) {
  constexpr int kParts = kThreads / HDP;
  const int d = threadIdx.x % HDP, grp = threadIdx.x / HDP;
  float e = 0.f;
  if (d < p.hd) {
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
  return e;
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

  stage_rows<kRows, HDP>(p, q0, kvh, b, sQ, sO, Ls, Ds, krange);
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

  store_rows(dq, p, b, kvh, q0, wg * 64 + (warp & 3) * 16 + (lane >> 2), lane);
}

// A warpgroup's accumulator rows (keys key0 and key1 of this thread), the
// columns from col0, times `mul` into out (B, KV, Sk, hd) in bf16.
template <int N>
__device__ __forceinline__ void store_keys(__nv_bfloat16* out, const float (&acc)[N], float mul,
                                           const BwdParams& p, int b, int kvh, int key0,
                                           int key1, int lane, int col0 = 0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = h ? key1 : key0;
    if (key < p.Sk)
      store_row(out + (((long long)b * p.KV + kvh) * p.Sk + key) * p.hd, acc, h, mul, p.hd,
                lane, col0);
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
  const float e = empty ? empty_col_sum<HDP>(p, b, kvh, ie0, ie1) : 0.f;
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

// --------------------------------------------------------------------------
// bf16 at 128 < hd <= 256: the wide kernels (see the note at the top)
// --------------------------------------------------------------------------
namespace wide {

constexpr int kRows = 64;              // dq kernel: packed query rows per block
constexpr int kT = 64 * 256 * 2;       // a 64-row tile at HDP 256: 4 column blocks
constexpr int kBlk = 64 * 128;         // one 64-column block of a 64-row tile
constexpr int kSlots = 2;              // ring slots: a K and a V tile, or a Q and a dO tile
constexpr int kStage = 64 * 64 * 2;    // a staged 64 x 64 bf16 tile: dS, P^T or dS^T
constexpr int kX = 32 * 128 * 4;       // the fp32 exchange: 32 values of each of 128 threads
// dq: Q, dO, the ring, dS, the exchange; dk/dv: K, V, the ring, P^T, dS^T,
// the exchange (the 1024 bytes align the swizzle's atoms)
constexpr int kDqSmem = 2 * kT + kSlots * 2 * kT + kStage + kX + 1024;
constexpr int kDkdvSmem = 2 * kT + kSlots * 2 * kT + 2 * kStage + kX + 1024;

// Zeroes column blocks ncb..3 of n consecutive 64-row tiles at `tiles`: no
// load writes them, and the products over hd read them.
__device__ __forceinline__ void zero_past_hd(unsigned char* tiles, int n, int ncb) {
  const int per = (4 - ncb) * kBlk / 16;      // 16-byte chunks a tile
  for (int i = threadIdx.x; i < n * per; i += blockDim.x) {
    const int tile = i / per, c = i - tile * per;
    *reinterpret_cast<uint4*>(tiles + tile * kT + ncb * kBlk + c * 16) = make_uint4(0, 0, 0, 0);
  }
}

// (x0, x1) in bf16 at row r, columns c and c + 1 (c even) of a staged 64 x
// 64 tile in the 128-byte swizzle
__device__ __forceinline__ void put_pair(unsigned char* tile, int r, int c, float x0, float x1) {
  *reinterpret_cast<uint32_t*>(tile + swz(r, c >> 3, 64) + (c & 7) * 2) = pack_bf16(x0, x1);
}

// dQ and D: 64 packed query rows of one kv head's group, the G heads x bq
// positions.
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wide_kernel(const BwdParams p, const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  unsigned char* base = smem_raw + pad;
  const uint32_t sQ = raw + pad;
  const uint32_t sO = sQ + kT;                        // dO
  const uint32_t sKV = sO + kT;                       // slot s: K, then V
  const uint32_t sDS = sKV + kSlots * 2 * kT;
  unsigned char* dS = base + (sDS - sQ);
  float* X = reinterpret_cast<float*>(dS + kStage);
  __shared__ __align__(8) uint64_t full[kSlots];
  __shared__ float Ls[kRows], Ds[kRows];
  __shared__ int krange[2];
  const uint32_t sFull = static_cast<uint32_t>(__cvta_generic_to_shared(full));

  // the last rows first: under a causal mask they see the most keys
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int t = tid & 127;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * p.bq, kvh = blockIdx.y, b = blockIdx.z;
  const int ncb = (p.hd + 63) / 64;
  if (tid == 0) {
    for (int s = 0; s < kSlots; ++s) mbar_init(sFull + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    krange[0] = INT_MAX;
    krange[1] = -1;
  }
  zero_past_hd(base + 2 * kT, 2 * kSlots, ncb);

  stage_rows<kRows, 256>(p, q0, kvh, b, sQ, sO, Ls, Ds, krange);
  cp_async_wait<0>();
  fence_proxy_async();                 // cp.async and the zeroed blocks before wgmma reads
  __syncthreads();

  // the keys of the live rows' bands; a row with no key has no dQ
  const int kstart = krange[0], kend = krange[1] + 1;
  const int kt0 = kstart < kend ? (kstart / kBK) * kBK : 0;
  const int ntiles = kstart < kend ? (kend - kt0 + kBK - 1) / kBK : 0;
  const int box = ncb * kBlk;          // bytes of a 64-row tile's boxes
  auto issue = [&](int n) {            // K/V tile n into its slot (one thread)
    const uint32_t dst = sKV + (n % kSlots) * 2 * kT, bar = sFull + 8 * (n % kSlots);
    mbar_expect(bar, 2 * box);
    tma_rows(&tk, p.kdim, dst, bar, ncb, kBK, kt0 + n * kBK, kvh, b);
    tma_rows(&tv, p.vdim, dst + kT, bar, ncb, kBK, kt0 + n * kBK, kvh, b);
  };
  if (tid == 0 && ntiles > 0) issue(0);

  // this thread's two rows (the same in both warpgroups)
  const int r0 = (warp & 3) * 16 + (lane >> 2);
  int pos[2];
  float lse[2], D[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    pos[h] = p.q_offset + q0 + (r - (r / p.bq) * p.bq);
    lse[h] = Ls[r];
    D[h] = Ds[r];
  }
  const int qmin = p.q_offset + q0;
  const int qmax = p.q_offset + min(q0 + p.bq, p.Sq) - 1;
  const float sl2 = p.sl2;
  const uint64_t da = sw128_desc(wg ? sO : sQ, 16, 1024);   // Q (S) or dO (dP)
  const uint64_t dsa = sw128_desc(sDS, 16, 1024);

  float dq[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq[i] = 0.f;

  for (int n = 0; n < ntiles; ++n) {
    __syncthreads();                   // tile n - 1 done: its slot, dS and the exchange are free
    if (tid == 0 && n + 1 < ntiles) issue(n + 1);
    mbar_wait(sFull + 8 * (n % kSlots), (n / kSlots) & 1);
    const int kt = kt0 + n * kBK;
    const uint32_t sK = sKV + (n % kSlots) * 2 * kT;

    // warpgroup 0: S = Q K^T; warpgroup 1: dP = dO V^T; over hd in steps of 16
    float x[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = 0.f;
    const uint64_t db = sw128_desc(wg ? sK + kT : sK, 16, 1024);
    fence_regs(x);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t off = ((j >> 2) * kBlk + (j & 3) * 32) >> 4;
      SS<64>::mma(x, da + off, db + off);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(x);

    // warpgroup 0 finishes keys 0-31 and hands its S of keys 32-63 to
    // warpgroup 1, which hands its dP of keys 0-31 back
    if (wg == 0) {
#pragma unroll
      for (int i = 16; i < 32; ++i) X[i * 128 + t] = x[i];
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) X[i * 128 + t] = x[i];
    }
    __syncthreads();

    // P = 2^(s sl2 - lse), masked in tiles that reach past Sk or the
    // block's band; dS = P (dP - D), staged in bf16
    const bool edge = kt + kBK > p.Sk || (p.causal && kt + kBK - 1 > qmin) ||
                      (p.has_window && kt <= qmax - p.window);
    auto ds_of = [&](int i, float s, float dp) {
      const int h = (i >> 1) & 1;
      float pr = ex2(fmaf(s, sl2, -lse[h]));
      if (edge) {
        const int c = kt + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
        if (c >= p.Sk || masked(p, c, pos[h])) pr = 0.f;
      }
      return pr * (dp - D[h]);
    };
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 16; i += 2)
        put_pair(dS, r0 + 8 * ((i >> 1) & 1), (i >> 2) * 8 + (lane & 3) * 2,
                 ds_of(i, x[i], X[i * 128 + t]), ds_of(i + 1, x[i + 1], X[(i + 1) * 128 + t]));
    } else {
#pragma unroll
      for (int i = 16; i < 32; i += 2)
        put_pair(dS, r0 + 8 * ((i >> 1) & 1), (i >> 2) * 8 + (lane & 3) * 2,
                 ds_of(i, X[i * 128 + t], x[i]), ds_of(i + 1, X[(i + 1) * 128 + t], x[i + 1]));
    }
    fence_proxy_async();               // the staged dS before wgmma reads
    __syncthreads();

    // dQ[:, this warpgroup's 128 columns] += dS K; K is MN-major here: 8-key
    // groups 1024 bytes apart, 64-column blocks kBlk apart
    const uint64_t kb = sw128_desc(sK + wg * 2 * kBlk, kBlk, 1024);
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_ss_n128_mn(dq, dsa + ((kk * 32) >> 4), kb + ((kk * 16 * 128) >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
  }

  store_rows(dq, p, b, kvh, q0, r0, lane, wg * 128);
}

// dK and dV: 64 keys of one kv head, over the sequence of 64-row tiles
// (head g, query tile) of the rows whose band reaches them (tile u in ring
// slot u % kSlots, issued by one thread a tile ahead). Blocks run the first
// keys first: under a causal mask they see the most rows.
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_wide_kernel(const BwdParams p, const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tdo,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  unsigned char* base = smem_raw + pad;
  const uint32_t sK = raw + pad;
  const uint32_t sV = sK + kT;
  const uint32_t sQO = sV + kT;        // slot s: Q, then dO
  const uint32_t sPt = sQO + kSlots * 2 * kT;
  const uint32_t sDSt = sPt + kStage;
  unsigned char* Pt = base + (sPt - sK);
  unsigned char* dSt = Pt + kStage;
  float* X = reinterpret_cast<float*>(dSt + kStage);
  __shared__ __align__(8) uint64_t full[kSlots + 1];   // the ring, then K/V
  __shared__ float Ls[2][kBQ], Ds[2][kBQ];             // [tile & 1][row]
  const uint32_t sFull = static_cast<uint32_t>(__cvta_generic_to_shared(full));
  const uint32_t sKVbar = sFull + 8 * kSlots;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int t = tid & 127;
  const int kvh = blockIdx.x % p.KV, k0 = (blockIdx.x / p.KV) * 64, b = blockIdx.y;
  const int ncb = (p.hd + 63) / 64;
  const int klast = min(k0 + 64, p.Sk) - 1;
  int ibeg, iend;
  row_range(p, k0, klast, ibeg, iend);
  const int nqt = iend > ibeg ? (iend - ibeg + kBQ - 1) / kBQ : 0;
  const int ntiles = p.G * nqt;        // tile u: head kvh G + u / nqt, rows from
                                       // ibeg + (u % nqt) kBQ
  const int box = ncb * kBlk;          // bytes of a 64-row tile's boxes

  auto issue = [&](int u) {            // tile u into its slot (one thread)
    const int h = kvh * p.G + u / nqt, it = ibeg + (u % nqt) * kBQ;
    const uint32_t dst = sQO + (u % kSlots) * 2 * kT, bar = sFull + 8 * (u % kSlots);
    mbar_expect(bar, 2 * box);
    tma_rows(&tq, p.qdim, dst, bar, ncb, kBQ, it, h, b);
    tma_rows(&tdo, p.ddim, dst + kT, bar, ncb, kBQ, it, h, b);
  };
  // lse and D of row tid of tile u (threads below kBQ)
  auto stats = [&](int u, float& l, float& d) {
    l = INFINITY;
    d = 0.f;
    if (u < ntiles) {
      const int g = u / nqt;
      row_stats(p, b, kvh * p.G + g, ibeg + (u - g * nqt) * kBQ + tid, l, d);
    }
  };

  zero_past_hd(base, 2 + 2 * kSlots, ncb);   // K, V and the ring's tiles
  if (tid == 0) {
    for (int s = 0; s <= kSlots; ++s) mbar_init(sFull + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(sKVbar, 2 * box);
    tma_rows(&tk, p.kdim, sK, sKVbar, ncb, 64, k0, kvh, b);
    tma_rows(&tv, p.vdim, sV, sKVbar, ncb, 64, k0, kvh, b);
    for (int u = 0; u < kSlots && u < ntiles; ++u) issue(u);
  }
  if (tid < kBQ) stats(0, Ls[0][tid], Ds[0][tid]);

  // this thread's two keys (the same in both warpgroups)
  const int kr = (warp & 3) * 16 + (lane >> 2);
  const int key[2] = {k0 + kr, k0 + kr + 8};
  const float sl2 = p.sl2;
  const uint64_t da = sw128_desc(wg ? sV : sK, 16, 1024);   // K (S^T) or V (dP^T)
  const uint64_t pa = sw128_desc(sPt, 16, 1024), dsa = sw128_desc(sDSt, 16, 1024);

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  fence_proxy_async();                 // the zeroed blocks before wgmma reads
  __syncthreads();                     // barriers initialised, tile 0's lse and D in
  mbar_wait(sKVbar, 0);

  for (int u = 0; u < ntiles; ++u) {
    __syncthreads();                   // tile u - 1 done: its slot, the staged tiles and
                                       // the exchange are free; lse, D of tile u in
    if (tid == 0 && u > 0 && u + 1 < ntiles) issue(u + 1);
    // the next tile's lse and D, stored after this tile's products
    float nl = 0.f, nd = 0.f;
    const bool next = tid < kBQ && u + 1 < ntiles;
    if (next) stats(u + 1, nl, nd);
    const int buf = u & 1;

    // does the band reach the block's keys from the tile's rows, and does
    // it cover all of them (else mask)?
    const int g = u / nqt, it = ibeg + (u - g * nqt) * kBQ;
    const int pmin = p.q_offset + it, pmax = p.q_offset + min(it + kBQ, p.Sq) - 1;
    const bool active = (!p.causal || k0 <= pmax) && (!p.has_window || klast > pmin - p.window);
    const bool edge = (p.causal && klast > pmin) || (p.has_window && k0 <= pmax - p.window);
    mbar_wait(sFull + 8 * (u % kSlots), (u / kSlots) & 1);
    if (active) {                      // the same in every thread
      const uint32_t sQt = sQO + (u % kSlots) * 2 * kT;
      const uint32_t sOt = sQt + kT;
      const float* L = Ls[buf];
      const float* Dr = Ds[buf];
      // warpgroup 0: S^T = K Q^T; warpgroup 1: dP^T = V dO^T; over hd in
      // steps of 16
      float x[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] = 0.f;
      const uint64_t db = sw128_desc(wg ? sOt : sQt, 16, 1024);
      fence_regs(x);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint32_t off = ((j >> 2) * kBlk + (j & 3) * 32) >> 4;
        SS<64>::mma(x, da + off, db + off);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);

      // warpgroup 0 finishes the tile's rows 0-31 and hands its S^T of rows
      // 32-63 to warpgroup 1, which hands its dP^T of rows 0-31 back
      if (wg == 0) {
#pragma unroll
        for (int i = 16; i < 32; ++i) X[i * 128 + t] = x[i];
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) X[i * 128 + t] = x[i];
      }
      __syncthreads();

      // P^T = 2^(s sl2 - lse) and dS^T = P^T (dP^T - D); the columns are the
      // tile's rows; both staged in bf16
      auto finish = [&](int i, float s, float dp, float& pr, float& ds) {
        const int c = (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
        pr = ex2(fmaf(s, sl2, -L[c]));
        if (edge && masked(p, key[(i >> 1) & 1], p.q_offset + it + c)) pr = 0.f;
        ds = pr * (dp - Dr[c]);
      };
      float p0, p1, d0, d1;
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < 16; i += 2) {
          finish(i, x[i], X[i * 128 + t], p0, d0);
          finish(i + 1, x[i + 1], X[(i + 1) * 128 + t], p1, d1);
          const int r = kr + 8 * ((i >> 1) & 1), c = (i >> 2) * 8 + (lane & 3) * 2;
          put_pair(Pt, r, c, p0, p1);
          put_pair(dSt, r, c, d0, d1);
        }
      } else {
#pragma unroll
        for (int i = 16; i < 32; i += 2) {
          finish(i, X[i * 128 + t], x[i], p0, d0);
          finish(i + 1, X[(i + 1) * 128 + t], x[i + 1], p1, d1);
          const int r = kr + 8 * ((i >> 1) & 1), c = (i >> 2) * 8 + (lane & 3) * 2;
          put_pair(Pt, r, c, p0, p1);
          put_pair(dSt, r, c, d0, d1);
        }
      }
      fence_proxy_async();             // the staged tiles before wgmma reads
      __syncthreads();

      // dV[:, half] += P^T dO[:, half], dK[:, half] += dS^T Q[:, half]; dO
      // and Q are MN-major here: 8-row groups 1024 bytes apart, 64-column
      // blocks kBlk apart
      const uint64_t ob = sw128_desc(sOt + wg * 2 * kBlk, kBlk, 1024);
      const uint64_t qb = sw128_desc(sQt + wg * 2 * kBlk, kBlk, 1024);
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        wgmma_ss_n128_mn(dv, pa + ((kk * 32) >> 4), ob + ((kk * 16 * 128) >> 4));
        wgmma_ss_n128_mn(dk, dsa + ((kk * 32) >> 4), qb + ((kk * 16 * 128) >> 4));
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
  if (ie0 > 0 || ie1 < p.Sq) {
    const float e = empty_col_sum<256>(p, b, kvh, ie0, ie1);   // column tid, all rows
    __syncthreads();                   // the last tile's reads of the exchange are done
    X[tid] = e;
    __syncthreads();
    const float inv = 1.f / (float)p.Sk;
#pragma unroll
    for (int i = 0; i < 64; ++i)
      dv[i] = fmaf(X[wg * 128 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1)], inv, dv[i]);
  }

  // dK (times scale) and dV of this warpgroup's 128 columns
  store_keys(static_cast<__nv_bfloat16*>(p.dk), dk, p.scale, p, b, kvh, key[0], key[1], lane,
             wg * 128);
  store_keys(static_cast<__nv_bfloat16*>(p.dv), dv, 1.f, p, b, kvh, key[0], key[1], lane,
             wg * 128);
}

}  // namespace wide

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

// 128 < hd <= 256: the wide kernels, 64-key dK/dV blocks
cudaError_t launch_wide(const BwdParams& p, const CUtensorMap& tq, const CUtensorMap& tdo,
                        const CUtensorMap& tk, const CUtensorMap& tv, int B,
                        cudaStream_t stream) {
  static int allowed_dq[kMaxDevices], allowed_dkdv[kMaxDevices];
  cudaError_t err =
      allow_smem(tc::wide::flash_bwd_dq_wide_kernel, tc::wide::kDqSmem, allowed_dq);
  if (err != cudaSuccess) return err;
  err = allow_smem(tc::wide::flash_bwd_dkdv_wide_kernel, tc::wide::kDkdvSmem, allowed_dkdv);
  if (err != cudaSuccess) return err;
  const dim3 dq_grid((p.Sq + p.bq - 1) / p.bq, p.KV, B);
  tc::wide::flash_bwd_dq_wide_kernel<<<dq_grid, tc::kThreads, tc::wide::kDqSmem, stream>>>(
      p, tk, tv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // key blocks outer, kv heads inner: the first keys of every head first
  const dim3 grid(((p.Sk + 63) / 64) * p.KV, B);
  tc::wide::flash_bwd_dkdv_wide_kernel<<<grid, tc::kThreads, tc::wide::kDkdvSmem, stream>>>(
      p, tq, tdo, tk, tv);
  return cudaGetLastError();
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
  if (p.hd > 128) {
    p.bq = tc::wide::kRows / p.G;
    return launch_wide(p, tq, tdo, tk, tv, B, stream);
  }
  p.bq = tc::kRows / p.G;
  if (p.hd <= 64) return launch_mma<64, 64>(p, tq, tdo, tk, tv, B, keys, stream);
  if (p.hd <= 80) return launch_mma<128, 80>(p, tq, tdo, tk, tv, B, keys, stream);
  return launch_mma<128, 128>(p, tq, tdo, tk, tv, B, keys, stream);
}

template <int HDP>
cudaError_t launch_tf32(BwdParams& p, int B, int rows, int keys, cudaStream_t stream) {
  using C = tf32::Cfg<HDP>;
  static int allowed_dq[kMaxDevices], allowed_dkdv[kMaxDevices];
  if (rows > C::kMaxRows || keys > C::kMaxKeys) return cudaErrorInvalidValue;
  p.bq = rows;
  p.bk = keys;
  const int dq_smem = (int)C::dq_smem(rows), dkdv_smem = (int)C::dkdv_smem(keys);
  cudaError_t err = allow_smem(tf32::flash_bwd_dq_tf32_kernel<HDP>, dq_smem, allowed_dq);
  if (err != cudaSuccess) return err;
  err = allow_smem(tf32::flash_bwd_dkdv_tf32_kernel<HDP>, dkdv_smem, allowed_dkdv);
  if (err != cudaSuccess) return err;
  const dim3 dq_grid((p.Sq + rows - 1) / rows, p.H, B);
  tf32::flash_bwd_dq_tf32_kernel<HDP><<<dq_grid, 32 * (rows / 16) * C::WQ, dq_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // key blocks outer, kv heads inner: the first keys of every head first
  const dim3 dkdv_grid(((p.Sk + keys - 1) / keys) * p.KV, B);
  tf32::flash_bwd_dkdv_tf32_kernel<HDP>
      <<<dkdv_grid, 32 * (keys / 16) * C::WK, dkdv_smem, stream>>>(p);
  return cudaGetLastError();
}

// A stride allows 16-byte fp32 copies if it is a positive multiple of 4
// elements or its dimension has one entry.
inline bool aligned4(long long stride, int n) { return n == 1 || (stride > 0 && stride % 4 == 0); }

// The split-TF32 route: q, k, v and dout must start on 16 bytes and have
// strides of whole 16-byte chunks (the wrapper copies them so where they do
// not), for cp.async. hd is padded to HDP columns (zero-filled): 64, 80,
// 128, 192 or 256.
cudaError_t dispatch_tf32(BwdParams& p, int B, int rows, int keys, cudaStream_t stream) {
  const bool ok = (uintptr_t)p.q % 16 == 0 && (uintptr_t)p.k % 16 == 0 &&
                  (uintptr_t)p.v % 16 == 0 && (uintptr_t)p.dout % 16 == 0 &&
                  aligned4(p.q_sb, B) && aligned4(p.q_sh, p.H) && aligned4(p.q_ss, p.Sq) &&
                  aligned4(p.d_sb, B) && aligned4(p.d_sh, p.H) && aligned4(p.d_ss, p.Sq) &&
                  aligned4(p.k_sb, B) && aligned4(p.k_sh, p.KV) && aligned4(p.k_ss, p.Sk) &&
                  aligned4(p.v_sb, B) && aligned4(p.v_sh, p.KV) && aligned4(p.v_ss, p.Sk);
  const bool blocks = (rows == 16 || rows == 32 || rows == 64 || rows == 128) &&
                      (keys == 16 || keys == 32 || keys == 64 || keys == 128);
  if (!ok || !blocks) return cudaErrorInvalidValue;
  if (p.hd <= 64) return launch_tf32<64>(p, B, rows, keys, stream);
  if (p.hd <= 80) return launch_tf32<80>(p, B, rows, keys, stream);
  if (p.hd <= 128) return launch_tf32<128>(p, B, rows, keys, stream);
  if (p.hd <= 192) return launch_tf32<192>(p, B, rows, keys, stream);
  return launch_tf32<256>(p, B, rows, keys, stream);
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16. route: 1 the tensor cores in bf16 (bf16 only), 2
// the tensor cores in split-TF32 products (fp32 only), as the caller's rule
// (flash_attention.bwd_route) chooses it. keys: the dK/dV block, on route 1
// 64 or 128 at hd <= 128 and 64 above (flash_attention.bwd_keys), on route 2
// 16, 32 or 64 (32 at most past hd 192); rows: route 2's dQ block, positions
// of one head, 16, 32 or 64 (32 at most past hd 192), 0 on route 1
// (flash_attention.bwd_tf32_blocks chooses both). lse (B,H,Sq) fp32
// contiguous, from the forward's training entry; dq (B,H,Sq,hd), dk and dv
// (B,KV,Sk,hd) contiguous, dsum (B,H,Sq) fp32 contiguous scratch. Returns a
// cudaError_t (0 = launched).
int flash_attention_bwd_launch(int dtype, int route, int keys, int rows, const void* q,
                               const void* k, const void* v, const void* o, const void* dout,
                               void* dq, void* dk, void* dv, const void* lse, void* dsum, int B,
                               int H, int KV, int Sq, int Sk, int hd, long long q_sb,
                               long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                               long long k_ss, long long v_sb, long long v_sh, long long v_ss,
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
    if (dtype != 1 || rows != 0 || (keys != 64 && keys != 128) || (hd > 128 && keys != 64))
      return (int)cudaErrorInvalidValue;
    return (int)dispatch_mma(p, B, keys, st);
  }
  if (route != 2 || dtype != 0) return (int)cudaErrorInvalidValue;
  return (int)dispatch_tf32(p, B, rows, keys, st);
}

}  // extern "C"
