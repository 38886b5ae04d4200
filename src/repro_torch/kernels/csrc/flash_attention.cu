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
// Each entry has two routes chosen by dtype alone, both on the tensor cores:
//
//  * bf16 -> flash_mma_kernel<HDP>, wgmma with fp32 accumulation.
//  * fp32 -> flash_tf32_split_kernel, then flash_tf32_kernel<HDP>, mma.sync
//    in split-TF32 products: each
//    operand x as big = tf32(x) and small = tf32(x - big), each product as
//    big.small + small.big + big.big, and every 32 of a product's shared
//    dimension summed from zero on the tensor cores, then added in fp32.
//    One TF32 product (10 mantissa bits) misses the 2e-5 kernel tolerance
//    and the fp32 model phases' 5e-4; the split products hold them, as the
//    fp32 backward's (csrc/flash_attention_bwd.cu) do.
//
// Both routes give a block G = H/KV query heads that share one kv head,
// packed head-major into rows r = g*bq + i (bq = rows/G), as the Pallas kernel
// packs them, so each K/V tile is read once per group; the grid is
// (q-tile, kv_head, batch). Rows: 128 for bf16 (two warpgroups of 64); for
// fp32 the caller's (flash_attention.fwd_tf32_rows: a multiple of 16 and at
// least G, the largest whose grid has 128 blocks, at most 128, 64 past hd
// 128, 32 past hd 192). Where G exceeds the rows (past hd 192, G >
// 32) a block packs as many heads as it has rows, and the grid's second
// dimension takes each kv head's group in parts.
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
//    not depend on the block it lands in, however many rows the block has: a
//    cache hit's suffix rows equal the cold run's bit for bit (held in bf16
//    and fp32 at full width by cases.FLASH_IDENTITY). That is exact only
//    while every row of the block sees a key. A row whose band is empty
//    (causal with a window, at position q_offset + i >= Sk + window - 1)
//    scores -1e30 on every key, so the reference gives it the mean of V over
//    all Sk keys; a block that holds such a row therefore visits every tile.
//
// Bound on the H100 at the main path's shapes (yi-6b: 32 heads of 128 on 4 kv
// heads, 512 suffix queries against 2,560 keys; Griffin: 10 heads of 256 on
// one, 2,560 against 2,560, window 2,048): 900-1,400 flops per byte that must
// move, above the H100's balance point of 295, so operations bound both
// routes: 989 TFLOP/s in bf16 on the tensor cores; in fp32 the tensor cores'
// 495 TFLOP/s of TF32 over the three TF32 products an fp32 product takes,
// 165 TFLOP/s (the CUDA cores' fp32 FMA: 67).
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
// The fp32 route runs both products as mma.sync m16n8k8 on TF32 operands
// (wgmma takes TF32 only K-major, and V is read along its rows), a warp on
// 16 rows (two past hd 128, each on half of O's columns):
//  * each value is split once a call: flash_tf32_split_kernel writes big and
//    small copies of q, k and v into the caller's scratch, whatever the
//    inputs' strides, in the tiles' own layout (rows of hd padded to 64, 80,
//    128, 192 or 256, + 4 floats against bank conflicts; keys padded to a
//    tile), so no block splits a K/V tile that other blocks split too, and
//    a tile's copy is one contiguous block;
//  * flash_tf32_kernel then takes Q's copies once a block by cp.async and
//    each 32-key K and V tile's by bulk copies (cp.async.bulk, one thread,
//    completed on an mbarrier) into slots of their own: two slots where
//    shared memory holds them (every copy issued a tile ahead), else one
//    (V's issued under S, the next K's under PV). Q and K fragments come by
//    ldmatrix, V's by 32-bit loads;
//  * the softmax stays in fp32 on the CUDA cores, in the backward's base-2
//    units (2^(s sl2 - m) by one FMA and exp2f, not ex2.approx; lse = m +
//    log2 l rounded once), so that the backward's P = 2^(s sl2 - lse) sums
//    to 1 but for lse's rounding; P is the PV product's A operand in its
//    accumulator's registers, no shuffles: a key pair 2 tig, 2 tig + 1 in
//    the places of k = tig, tig + 4, V read in the same order.
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
  int pairs;     // output rows allow stores of 2 values (4 bytes bf16, 8 fp32)
  int rows;      // fp32 route: packed query rows a block (flash_attention.fwd_tf32_rows)
  int gb, nsub;  // fp32 route: query heads a block packs, blocks a kv head's group takes
  float* sp;     // fp32 route: scratch for the split copies of q, k and v
  int ld, skp;   // fp32 route: the copies' row (floats), Sk rounded up to a tile
  long long qn, kn;   // fp32 route: floats of one copy of q, of k (and of v)
  int nbuf;      // fp32 route: K/V slots
  float scale;
};

// --------------------------------------------------------------------------
// fp32 route: split-TF32 products on the tensor cores (mma.sync m16n8k8)
// --------------------------------------------------------------------------
namespace tf32 {

constexpr int kBK = 32;                // keys a K/V tile
constexpr int kLS = kBK + 8;           // row stride of the staged P (floats), W = 2
constexpr int kMaxThreads = 256;
constexpr int kSplitThreads = 256;
constexpr size_t kSmemMax = 232448 - 1024;   // a block's dynamic shared memory, less the static

// Tiles are row-major with rows of LD = HDP (64, 80, 128, 192 or 256) + 4
// floats (4 mod 8, as the backward's): the 8 rows of an ldmatrix phase and
// the 2 x 4 keys x 8 columns of a V fragment's 32-bit loads fall in 32
// different banks. W warps share 16 rows: each takes NS of a tile's keys in
// S and HC of hd's columns of O (past hd 128 two, whose 16 x 256 O alone
// would be 128 registers a thread). NC: S's 32-column sums. Rows a block at
// most: 8 warps, and shared memory (Q's two copies of 64 rows at hd 256
// alone are 133 KB).
template <int HDP>
struct Cfg {
  static constexpr int LD = HDP + 4;
  static constexpr int W = HDP > 128 ? 2 : 1;
  static constexpr int HC = HDP / W, NS = kBK / W, NC = (HDP + 31) / 32;
  static constexpr int kMaxRows = HDP <= 128 ? 128 : (HDP <= 192 ? 64 : 32);
  // Q big and small, nbuf slots of K and V big and small, P
  static size_t smem(int rows, int nbuf) {
    return sizeof(float) *
           ((size_t)2 * rows * LD + nbuf * 4 * kBK * LD + (W > 1 ? (size_t)rows * kLS : 0));
  }
};

// Every value of q, k and v split once a call: big = tf32(x) and small (the
// operands of split) into the scratch p.sp, row-major with rows of p.ld =
// HDP + 4 floats, the rows of the attention kernel's tiles (zero past hd),
// and k and v with p.skp = Sk rounded up to a tile (zero rows past Sk), so
// that a K or V tile is one contiguous copy: q's big then small copy, then
// k's, then v's. blockIdx.y: 0 q (B, H, Sq), 1 k, 2 v (B, KV, skp). The
// inputs come by strides, each thread a 4-column chunk.
__global__ void __launch_bounds__(kSplitThreads) flash_tf32_split_kernel(const Params p) {
  const int which = blockIdx.y;
  const int N = which == 0 ? p.KV * p.G : p.KV, S = which == 0 ? p.Sq : p.skp;
  const float* x = static_cast<const float*>(which == 0 ? p.q : which == 1 ? p.k : p.v);
  const long long sb = which == 0 ? p.q_sb : which == 1 ? p.k_sb : p.v_sb;
  const long long sh = which == 0 ? p.q_sh : which == 1 ? p.k_sh : p.v_sh;
  const long long ss = which == 0 ? p.q_ss : which == 1 ? p.k_ss : p.v_ss;
  const long long n = which == 0 ? p.qn : p.kn;
  float* big = p.sp + (which == 0 ? 0 : 2 * p.qn + (which - 1) * 2 * p.kn);
  const int ch = p.ld / 4;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n / 4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / ch;
    const int c = (int)(i - row * ch), s = (int)(row % S);
    const long long bh = row / S;
    const float* src = x + (bh / N) * sb + (bh % N) * sh + (long long)s * ss + 4 * c;
    const bool in = which == 0 || s < p.Sk;
    uint4 hb, hs;
    split(in && 4 * c < p.hd ? src[0] : 0.f, hb.x, hs.x);
    split(in && 4 * c + 1 < p.hd ? src[1] : 0.f, hb.y, hs.y);
    split(in && 4 * c + 2 < p.hd ? src[2] : 0.f, hb.z, hs.z);
    split(in && 4 * c + 3 < p.hd ? src[3] : 0.f, hb.w, hs.w);
    *reinterpret_cast<uint4*>(big + 4 * i) = hb;
    *reinterpret_cast<uint4*>(big + n + 4 * i) = hs;
  }
}

// bytes from global memory at src into shared memory at dst, one bulk copy
// (cp.async.bulk: both 16-byte aligned, a multiple of 16 bytes) completing
// on the mbarrier bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// p.rows packed query rows (a multiple of 16: p.gb heads of one kv head,
// head-major, times p.bq positions) over 32-key K/V tiles, every operand
// already split (flash_tf32_split_kernel). Warp w owns rows 16 (w / W) ..
// + 15: S of NS keys of each tile and O of HC columns. A thread holds rows
// gid and gid + 8 of its warp's 16, and of each 8-key (or 8-column) group
// the two at 2 tig, 2 tig + 1. A K or V tile's big and small copies come by
// two bulk copies, issued by one thread and completed on an mbarrier, into
// p.nbuf slots: two where shared memory holds them (each tile's copies
// issued a whole tile ahead), else one (V's issued under S, the next K's
// under PV). Per tile:
//  1. K's copies in; block barrier (every warp done with the previous tile);
//     the next copies issued;
//  2. S = Q K^T: each 32 columns of hd (four k-steps of three products) from
//     zero, then the NC sums added in order in fp32; the k-steps of the NC
//     sums interleave, so the tensor cores see NC independent chains (Q and
//     K fragments by ldmatrix);
//  3. the online softmax in fp32 on the CUDA cores (exp2f, the running max
//     of s sl2; at W = 2 the pair exchanges its maxima through shared
//     memory and stages P there);
//  4. V's copies in (one slot: block barrier, then the next K's issued);
//  5. O = alpha O + P V, the tile's 32 keys from zero, then added in fp32.
//     P is the A operand without shuffles: a key pair 2 tig, 2 tig + 1
//     takes the places of k = tig, tig + 4 of a k-step (in the registers of
//     S's accumulator at W = 1), and V's B fragment is read in that order
//     (keys 2 tig, 2 tig + 1 of column gid).
template <int HDP, bool kLse>
__global__ void __launch_bounds__(kMaxThreads, 1) flash_tf32_kernel(const Params p, float* lse) {
  using C = Cfg<HDP>;
  constexpr int LD = C::LD, W = C::W, HC = C::HC, NS = C::NS, NC = C::NC;
  constexpr int kTile = kBK * LD;                      // floats of one copy of a tile
  extern __shared__ float4 smem4[];
  const int rows = p.rows, nbuf = p.nbuf;
  float* const Qb = reinterpret_cast<float*>(smem4);   // rows x LD: tf32(q)
  float* const Qs = Qb + rows * LD;                    // the small parts
  float* const KV0 = Qs + rows * LD;                   // slot s: K big, K small, V big, V small
  float* const Ps = KV0 + nbuf * 4 * kTile;            // rows x kLS (W = 2)
  __shared__ float Xs[2][64];                          // W = 2: the pair's row maxima, then l
  __shared__ __align__(8) uint64_t bars[4];            // slot s: K's (2 s), V's (2 s + 1)
  const uint32_t sbar = smem_u32(bars);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * p.bq, b = blockIdx.z;
  const int kvh = blockIdx.y / p.nsub, g0 = (blockIdx.y - kvh * p.nsub) * p.gb;
  const int ng = min(p.gb, p.G - g0);                  // heads of this block
  // the split copies: q's rows of head kvh G + g0 on, k's and v's of kv head kvh
  const float* q = p.sp + ((long long)(b * p.KV + kvh) * p.G + g0) * p.Sq * LD;
  const float* k = p.sp + 2 * p.qn + (long long)(b * p.KV + kvh) * p.skp * LD;
  const float* v = k + 2 * p.kn;
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(sbar + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // Key range the block's rows can see, unless one of its rows sees none.
  int empty = 0;
  if (tid < rows) {
    const int g = tid / p.bq, i = tid - g * p.bq;
    if (g < ng && q0 + i < p.Sq) {
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
  // tile u's K (which 0) or V (1) copies into slot u % nbuf, by thread 0
  auto issue = [&](int u, int which) {
    const int slot = u % nbuf;
    const uint32_t bar = sbar + 8 * (2 * slot + which);
    const float* src = (which ? v : k) + (long long)(kt0 + u * kBK) * LD;
    const uint32_t dst = smem_u32(KV0 + (4 * slot + 2 * which) * kTile);
    mbar_expect(bar, 2 * kTile * 4);
    bulk_load(dst, src, kTile * 4, bar);
    bulk_load(dst + kTile * 4, src + p.kn, kTile * 4, bar);
  };
  if (tid == 0) {
    issue(0, 0);
    if (nbuf > 1) issue(0, 1);
  }
  // Q's rows (zero past Sq and the block's heads) by 16-byte cp.async
  {
    constexpr int kChunks = LD / 4;
    for (int idx = tid; idx < rows * kChunks; idx += blockDim.x) {
      const int r = idx / kChunks, c = idx - r * kChunks;
      const int g = r / p.bq, i = r - g * p.bq;
      const bool ok = g < ng && q0 + i < p.Sq;
      const float* from = ok ? q + ((long long)g * p.Sq + q0 + i) * LD + c * 4 : q;
      cp_async16(smem_u32(Qb + r * LD + c * 4), from, ok ? 16 : 0);
      cp_async16(smem_u32(Qs + r * LD + c * 4), ok ? from + p.qn : q, ok ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();                // the block sees it after the first barrier
  }

  const int rg = warp / W, wc = warp % W, r0 = 16 * rg;
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + gid + 8 * h;
    pos[h] = p.q_offset + q0 + (r - (r / p.bq) * p.bq);
  }
  const float sl2 = p.scale * kLog2e;  // the backward's: exp(x scale) = 2^(x sl2)
  // ldmatrix: Q rows r0 + t % 8 (+ 8 for t / 8 odd), columns 4 (t / 16);
  // K keys wc NS + t % 8 (+ 8 for t >= 16), columns 4 (t / 8 % 2), of slot 0
  const uint32_t aQ = smem_u32(Qb + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                               4 * (lane >> 4));
  const uint32_t aQs = aQ + rows * LD * 4;
  const uint32_t bK0 = smem_u32(KV0) +
                       ((wc * NS + (lane & 7) + 8 * (lane >> 4)) * LD + 4 * ((lane >> 3) & 1)) * 4;
  // V: keys 2 tig, 2 tig + 1 of column gid of this warp's columns, of slot 0
  const float* vb0 = KV0 + 2 * kTile + 2 * tig * LD + wc * HC + gid;

  float o[HC / 8][4];
#pragma unroll
  for (int j = 0; j < HC / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // m: running max of s sl2 (kNegInf while a row has seen only masked keys:
  // then those weigh 2^0 = 1, as the reference's -1e30 scores do); l: this
  // thread's part of the row sum
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const int kt = kt0 + t * kBK, slot = t % nbuf, phase = (t / nbuf) & 1;
    mbar_wait(sbar + 16 * slot, phase);
    __syncthreads();                   // K in (and Q); every warp done with tile t - 1
    if (tid == 0) {
      if (nbuf == 1) {
        issue(t, 1);
      } else if (t + 1 < ntiles) {     // into the slot tile t - 1 used
        issue(t + 1, 0);
        issue(t + 1, 1);
      }
    }
    const uint32_t bK = bK0 + slot * 4 * kTile * 4, bKs = bK + kTile * 4;
    const float* vb = vb0 + slot * 4 * kTile;
    const float* vs = vb + kTile;

    // S = Q K^T over hd: NC sums of 32 columns (four k-steps) from zero,
    // the k-steps of different sums interleaved, then added in order
    float ts[NC][NS / 8][4];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < NS / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) ts[c][j][i] = 0.f;
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int kk = 4 * c + kq;
        if (kk >= HDP / 8) continue;
        uint32_t ab[4], as[4];
        ldsm4(ab, aQ + kk * 32);
        ldsm4(as, aQs + kk * 32);
#pragma unroll
        for (int j = 0; j < NS / 16; ++j) {    // two 8-key n-tiles an ldmatrix
          uint32_t bb[4], bs[4];
          ldsm4(bb, bK + j * 16 * LD * 4 + kk * 32);
          ldsm4(bs, bKs + j * 16 * LD * 4 + kk * 32);
          mma3(ts[c][2 * j], ab, as, bb, bs);
          mma3(ts[c][2 * j + 1], ab, as, bb + 2, bs + 2);
        }
      }
    }
    float s[NS / 8][4];
#pragma unroll
    for (int j = 0; j < NS / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) s[j][i] += ts[c][j][i];
      }

    // The softmax in base 2, in the backward's units: the running max m of
    // s sl2 and p = 2^(s sl2 - m) by one FMA and exp2f, so that the
    // backward's P = 2^(s sl2 - lse) sums to 1 up to lse's rounding. Masks
    // only in tiles that reach past Sk or the block's band: keys past Sk are
    // no keys (`past`: p = 0), keys outside a row's band score the
    // reference's -1e30 (`band`: p = 1 while the row has seen no visible
    // key, else 0)
    const bool edge = kt + kBK > p.Sk || (p.causal && kt + kBK - 1 > qmin) ||
                      (p.has_window && kt <= qmax - p.window);
    uint32_t band = 0, past = 0;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1, bit = 4 * j + i;
        float y = s[j][i] * sl2;
        if (edge) {
          const int c = kt + wc * NS + 8 * j + 2 * tig + (i & 1);
          if (c >= p.Sk) {
            y = -INFINITY;
            past |= 1u << bit;
          } else if ((p.causal && c > pos[h]) || (p.has_window && c <= pos[h] - p.window)) {
            y = kNegInf;
            band |= 1u << bit;
          }
        }
        mx[h] = fmaxf(mx[h], y);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
    if constexpr (W > 1) {             // the max over both warps' keys
      if (tig == 0) {
        Xs[wc][r0 + gid] = mx[0];
        Xs[wc][r0 + gid + 8] = mx[1];
      }
      sync_group<W>(rg);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mx[h] = fmaxf(Xs[0][r0 + gid + 8 * h], Xs[1][r0 + gid + 8 * h]);
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m[h], mx[h]);
      alpha[h] = exp2f(m[h] - mn);
      m[h] = mn;
    }
#pragma unroll
    for (int j = 0; j < NS / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1, bit = 4 * j + i;
        float pr = exp2f(fmaf(s[j][i], sl2, -m[h]));
        if ((band | past) >> bit & 1) pr = (band >> bit & 1) && m[h] == kNegInf ? 1.f : 0.f;
        s[j][i] = pr;
        rs[h] += pr;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
    // a warp whose rows kept their maxima skips the rescale (x 1 is exact)
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < HC / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[j][i] *= alpha[i >> 1];
    }
    if constexpr (W > 1) {             // P of this warp's keys, for the pair
#pragma unroll
      for (int j = 0; j < NS / 8; ++j) {
        float* d0 = Ps + (r0 + gid) * kLS + wc * NS + 8 * j + 2 * tig;
        *reinterpret_cast<float2*>(d0) = make_float2(s[j][0], s[j][1]);
        *reinterpret_cast<float2*>(d0 + 8 * kLS) = make_float2(s[j][2], s[j][3]);
      }
    }

    mbar_wait(sbar + 16 * slot + 8, phase);
    if (nbuf == 1) {
      __syncthreads();                 // V in, P staged; every S done with K
      if (tid == 0 && t + 1 < ntiles) issue(t + 1, 0);
    } else if constexpr (W > 1) {
      sync_group<W>(rg);               // P staged
    }

    // P split as the A operand: k = tig, tig + 4 of k-step kk hold keys
    // 8 kk + 2 tig, 8 kk + 2 tig + 1 of rows gid, gid + 8
    uint32_t pb[kBK / 8][4], ps[kBK / 8][4];
    if constexpr (W == 1) {
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        split(s[kk][0], pb[kk][0], ps[kk][0]);
        split(s[kk][2], pb[kk][1], ps[kk][1]);
        split(s[kk][1], pb[kk][2], ps[kk][2]);
        split(s[kk][3], pb[kk][3], ps[kk][3]);
      }
    } else {
      const float* a = Ps + (r0 + gid) * kLS + 2 * tig;
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        const float2 x0 = *reinterpret_cast<const float2*>(a + 8 * kk);
        const float2 x1 = *reinterpret_cast<const float2*>(a + 8 * kk + 8 * kLS);
        split(x0.x, pb[kk][0], ps[kk][0]);
        split(x1.x, pb[kk][1], ps[kk][1]);
        split(x0.y, pb[kk][2], ps[kk][2]);
        split(x1.y, pb[kk][3], ps[kk][3]);
      }
    }
    // O[:, wc HC ..] += P V, each 8 columns' 32 keys from zero
#pragma unroll
    for (int j = 0; j < HC / 8; ++j) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        const int at = 8 * kk * LD + 8 * j;
        const uint32_t bb[2] = {__float_as_uint(vb[at]), __float_as_uint(vb[at + LD])};
        const uint32_t bs[2] = {__float_as_uint(vs[at]), __float_as_uint(vs[at + LD])};
        mma3(acc, pb[kk], ps[kk], bb, bs);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) o[j][i] += acc[i];
    }
  }

  // l over the quad, then (W = 2) over the pair: every S of the block is
  // done, so no warp reads a maximum from Xs any more
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  if constexpr (W > 1) {
    if (tig == 0) {
      Xs[wc][r0 + gid] = l[0];
      Xs[wc][r0 + gid + 8] = l[1];
    }
    sync_group<W>(rg);
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = Xs[0][r0 + gid + 8 * h] + Xs[1][r0 + gid + 8 * h];
  }
  float* out = static_cast<float*>(p.o);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + gid + 8 * h;
    const int g = r / p.bq, qi = r - g * p.bq;
    if (g < ng && q0 + qi < p.Sq) {
      const float den = fmaxf(l[h], 1e-20f);
      float* orow = out + b * p.o_sb + (long long)(kvh * p.G + g0 + g) * p.o_sh +
                    (long long)(q0 + qi) * p.o_ss;
#pragma unroll
      for (int j = 0; j < HC / 8; ++j) {
        const int d = wc * HC + 8 * j + 2 * tig;
        const float x0 = o[j][2 * h] / den, x1 = o[j][2 * h + 1] / den;
        if (p.pairs && d + 1 < p.hd) {
          *reinterpret_cast<float2*>(orow + d) = make_float2(x0, x1);
        } else {
          if (d < p.hd) orow[d] = x0;
          if (d + 1 < p.hd) orow[d + 1] = x1;
        }
      }
      // m + log2 l in double, rounded once (in fp32 the sum rounds again,
      // and at yi-6b's training shape that took one entry of the
      // backward's dV past TOL[fp32]); a row that saw no visible key gets
      // the mask value's
      if constexpr (kLse) {
        if (tig == 0 && wc == 0)
          lse[((long long)b * p.KV * p.G + kvh * p.G + g0 + g) * p.Sq + q0 + qi] =
              m[h] == kNegInf ? kNegInf * kLog2e : (float)((double)m[h] + log2((double)l[h]));
      }
    }
  }
}

}  // namespace tf32

// The split, then the attention, on the caller's stream: the scratch's rows
// and the slots follow HDP and the rows.
template <int HDP, bool kLse>
cudaError_t launch_tf32(Params p, float* lse, int B, cudaStream_t stream) {
  using C = tf32::Cfg<HDP>;
  static int allowed[kMaxDevices];
  if (p.rows > C::kMaxRows) return cudaErrorInvalidValue;
  p.ld = C::LD;
  p.qn = (long long)B * p.KV * p.G * p.Sq * C::LD;
  p.kn = (long long)B * p.KV * p.skp * C::LD;
  p.nbuf = C::smem(p.rows, 2) <= tf32::kSmemMax ? 2 : 1;
  const int smem = (int)C::smem(p.rows, p.nbuf);
  cudaError_t err = allow_smem(tf32::flash_tf32_kernel<HDP, kLse>, smem, allowed);
  if (err != cudaSuccess) return err;
  const long long blocks = ((p.qn > p.kn ? p.qn : p.kn) / 4 + tf32::kSplitThreads - 1) /
                           tf32::kSplitThreads;
  const dim3 split_grid((unsigned)(blocks < 4096 ? blocks : 4096), 3);
  tf32::flash_tf32_split_kernel<<<split_grid, tf32::kSplitThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + p.bq - 1) / p.bq, p.KV * p.nsub, B);
  tf32::flash_tf32_kernel<HDP, kLse><<<grid, 32 * (p.rows / 16) * C::W, smem, stream>>>(p, lse);
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
                 int q_offset, int causal, int has_window, int window, int rows,
                 void* scratch, void* stream) {
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
    if (rows < 16 || rows % 16 != 0) return (int)cudaErrorInvalidValue;
    p.rows = rows;
    p.gb = min(p.G, rows);
    p.nsub = (p.G + p.gb - 1) / p.gb;
    p.bq = rows / p.gb;
    p.sp = static_cast<float*>(scratch);
    p.skp = (Sk + tf32::kBK - 1) / tf32::kBK * tf32::kBK;
    p.pairs = hd % 2 == 0 && (uintptr_t)o % 8 == 0 && o_sb % 2 == 0 && o_sh % 2 == 0 &&
              o_ss % 2 == 0;
    if (hd <= 64) return (int)launch_tf32<64, kLse>(p, lse, B, st);
    if (hd <= 80) return (int)launch_tf32<80, kLse>(p, lse, B, st);
    if (hd <= 128) return (int)launch_tf32<128, kLse>(p, lse, B, st);
    if (hd <= 192) return (int)launch_tf32<192, kLse>(p, lse, B, st);
    return (int)launch_tf32<256, kLse>(p, lse, B, st);
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

// dtype: 0 fp32, 1 bf16. rows: the fp32 route's packed query rows a block (a
// multiple of 16, flash_attention.fwd_tf32_rows); scratch: its fp32 scratch
// for the split copies, 2 (B H Sq + 2 B KV skp) (HDP + 4) floats, skp = Sk
// rounded up to 32 (flash_attention.split_floats; the bf16 route takes
// neither). Returns a cudaError_t (0 = launched).
int flash_attention_launch(int dtype, const void* q, const void* k, const void* v,
                           void* o, int B, int H, int KV, int Sq, int Sk, int hd,
                           long long q_sb, long long q_sh, long long q_ss,
                           long long k_sb, long long k_sh, long long k_ss,
                           long long v_sb, long long v_sh, long long v_ss,
                           long long o_sb, long long o_sh, long long o_ss,
                           int q_offset, int causal, int has_window, int window, int rows,
                           void* scratch, void* stream) {
  return launch_entry<false>(dtype, q, k, v, o, nullptr, B, H, KV, Sq, Sk, hd, q_sb, q_sh,
                             q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                             q_offset, causal, has_window, window, rows, scratch, stream);
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
                                 int rows, void* scratch, void* stream) {
  return launch_entry<true>(dtype, q, k, v, o, static_cast<float*>(lse), B, H, KV, Sq, Sk, hd,
                            q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,
                            o_ss, q_offset, causal, has_window, window, rows, scratch, stream);
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
