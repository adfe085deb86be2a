// StruM-packed KV pages on Hopper (sm_90a): page decode and the sealed-page
// partial of paged attention.
//
// Replaces the TPU kernels
//   K11 strum_page_decode_launch                  <- strum_page_decode_pallas
//                                                    (src/repro/kernels/strum_decode.py)
//   K4  strum_paged_attention_split_launch        <- strum_paged_attention_pallas
//       (+ strum_attention_combine_launch, the merge of its KV splits)
//   K5  strum_paged_attention_launch(mode 1)      <- strum_paged_attention_pallas_maskfree
//                                                    (src/repro/kernels/strum_attention.py)
//
// Packed page layout (one [1, w] block per w cache positions of a feature
// channel; F = n_kv_heads * head_dim contiguous in every field):
//   mask  (n_pages, nb, mask_rows, F)  uint8, LSB-first, 1 = high
//   hi    (n_pages, nb, hi_rows, F)    int8, the n_high high values in order
//   lo    (n_pages, nb, lo_rows, F)    uint8, n_low q-bit fields, LSB-first
//   scale (n_pages, F)                 f32 per-page, per-channel scale
// A page holds nb * w cache positions.
//
// The shared decode (decode_column) is K1's (strum_matmul.cu), copied: walk
// the w mask bits LSB-first; a set bit takes the next hi byte, a clear one
// the next q-bit lo field (which may straddle two bytes when 8 % q != 0);
// lo decodes as DLIQ (sign-extend, << (8 - q)), MIP2Q ([sign | k] -> +-2^k)
// or sparsity (0).  The integer is multiplied by the channel's f32 scale in
// one rounding, so K11 equals its plain PyTorch version bit for bit.
//
// What bounds them: both read each packed byte once and do little
// arithmetic per byte, so they are bound by HBM bytes (K11 by the f32 values
// it writes, 4 / 0.875 times the packed bytes at the default codec).  The
// point of the packed pages is that attention reads 14/16 of the int8 bytes
// (mip2q, w = 16, p = .5) and never a decoded copy.
//
// K5 design (a simple version, not yet fast): one block per (slot, kv
// head, tile of up to kMaxRows query rows).  The block reads its slot's page
// ids itself and walks the pages in order, skipping ids < 0, pages at or
// after n_valid and ids past the pool (the TPU grid's page axis becomes this
// loop).  For each live page it (1) copies its head's packed lo bytes of K
// and V (columns [g*hd, (g+1)*hd) of every row) and their scales into shared
// memory with independent 4-byte loads; (2) decodes the (page_size, hd) K
// and V tiles there, one thread per block column; (3) computes the scores
// against the pre-scaled queries; (4)-(5) carries the online softmax (m, l,
// acc) in f32 shared memory.  A slot with nothing live returns m = -1e30,
// l = 0, acc = 0.
//
// K4 design (split-KV, flash-decoding): the serial page chain of one block
// per (slot, head) was the time (~6.5 us a page x 128 pages at OLMo-1B
// decode on an H100 SXM at 700 W, 118x the byte bound), so the grid is
// (KV split, kv head x row tile, slot).  Each split owns `pps`
// consecutive page slots of the table; warp 0 reads them, keeps the live
// ids in order (ballot + popcount) and a
// split with none writes the identity partial and returns.  A live page's
// head slice of K and V -- nb * (mask + hi + lo) rows of hd bytes at row
// stride F -- and its 2 x hd scales come in by 16-byte cp.async.cg into a
// two-stage shared-memory ring, so the next live page is in flight while
// the current one decodes.  Per page there are two block barriers: (1) the
// page has landed (and the last page's tiles are free), after which the next
// page's copy is issued; (2) the K and V tiles are decoded (256 threads, one
// per block column of K and V; a position's rank among the high / low set
// is the popcount of the lower mask bits, the block's bytes sit in four
// registers and lo codes decode through a table in shared memory).  Then
// each of 4 position groups of warps takes 4 positions of the page, 8 lanes
// per position, and within a group 2 warps split the tile's rows: scores by
// 8-lane __shfl_xor_sync sums over hd, the max and the sum of the softmax
// by __shfl_xor_sync across the 4 positions, and P.V into registers (a lane
// owns hd / 32 columns).  Every warp keeps its own online state (m, l, acc)
// for its rows; at the end the position groups are merged in order.  All
// arithmetic is f32 (q pre-scaled, decoded values int x scale): at R = 1 a
// tensor core buys nothing, and at R = 16 bf16 operands would not hold the
// 2e-5 tolerance.  With more than one split, each split writes its partial
// to scratch and split_combine_kernel merges the splits of every row in
// split-index order (never arrival order), so the result does not depend on
// block scheduling.  The second kernel was chosen over a last-arriving-block
// merge: it needs no zeroed counters kept between calls and no fences, and
// costs one launch per layer per lane run against ~2000 a tick.
// Alignment contract of the staging: hd % 16 == 0 and every field and scale
// pointer 16-byte aligned (then every row slice and scale slice is, since F
// = KV * hd); w % 8 == 0, w <= 64, page size nb * w <= 64, pages per split
// <= 32.  The launcher returns cudaErrorInvalidValue for anything else.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Method { kSparsity = 0, kDliq = 1, kMip2q = 2 };
enum Mode { kGeneral = 0, kMaskfree = 1 };

constexpr int kDecodeThreads = 256;
constexpr int kAttnThreads = 256;
constexpr int kMaxRows = 16;      // query rows per attention block
constexpr float kNegInf = -1e30f;

struct Codec {
  int nb, w, F, mask_rows, hi_rows, lo_rows, n_high, n_low, q, method;
};

struct Pool {
  const uint8_t* mask;
  const int8_t* hi;
  const uint8_t* lo;
  const float* scale;
};

// q-bit field j of one column's lo bytes; col points at lo row 0 of the
// block column, rows are `stride` bytes apart.
__device__ __forceinline__ int lo_field(const uint8_t* col, int rows, int stride,
                                        int j, int q) {
  const int bit = j * q;
  const int byte = bit >> 3;
  const int sh = bit & 7;
  unsigned v = col[(size_t)byte * stride];
  if (sh + q > 8 && byte + 1 < rows) v |= (unsigned)col[(size_t)(byte + 1) * stride] << 8;
  return (int)((v >> sh) & ((1u << q) - 1u));
}

__device__ __forceinline__ float decode_low(int c, int method, int q) {
  if (method == kDliq) {
    const int sb = 1 << (q - 1);
    return (float)(((c ^ sb) - sb) * (1 << (8 - q)));
  }
  if (method == kMip2q) {
    const int s = 1 - 2 * (c >> (q - 1));
    return (float)(s * (1 << (c & ((1 << (q - 1)) - 1))));
  }
  return 0.f;
}

// Decode one [1, w] block column into dst[pos * dstride], pos in [0, w),
// each value times the channel's scale s.  mcol / hcol / lcol point at row
// 0 of the column's mask / hi / lo bytes, rows `stride` bytes apart (F in
// the pool, hd once staged in shared memory).
template <int MODE>
__device__ __forceinline__ void decode_column(const uint8_t* mcol, const int8_t* hcol,
                                              const uint8_t* lcol, int stride,
                                              const Codec& c, float s, float* dst,
                                              int dstride) {
  if (MODE == kMaskfree) {  // K5: lo fields in position order, no mask/hi
    for (int pos = 0; pos < c.w; ++pos)
      dst[pos * dstride] = decode_low(lo_field(lcol, c.lo_rows, stride, pos, c.q),
                                      c.method, c.q) * s;
    return;
  }
  int hc = 0, lc = 0;  // ranks among the high / low positions seen so far
  for (int byte = 0; byte < c.mask_rows; ++byte) {
    const unsigned bits = mcol[(size_t)byte * stride];
    for (int j = 0; j < 8; ++j) {
      const int pos = byte * 8 + j;
      if (pos >= c.w) break;
      float v = 0.f;
      if ((bits >> j) & 1u) {
        if (hc < c.n_high) v = (float)hcol[(size_t)hc * stride];
        ++hc;
      } else {
        if (c.method != kSparsity && lc < c.n_low)
          v = decode_low(lo_field(lcol, c.lo_rows, stride, lc, c.q), c.method, c.q);
        ++lc;
      }
      dst[pos * dstride] = v * s;
    }
  }
}

// K11: one thread per (page, block, channel); out (P, nb * w, F) f32.
__global__ void __launch_bounds__(kDecodeThreads)
page_decode_kernel(Pool pool, Codec c, int P, float* out) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)P * c.nb * c.F;
  if (idx >= total) return;
  const int f = (int)(idx % c.F);
  const size_t blk = idx / c.F;  // page * nb + block
  float* dst = out + blk * c.w * c.F + f;
  decode_column<kGeneral>(pool.mask + blk * c.mask_rows * c.F + f,
                          pool.hi + blk * c.hi_rows * c.F + f,
                          pool.lo + blk * c.lo_rows * c.F + f, c.F, c,
                          pool.scale[(blk / c.nb) * c.F + f], dst, c.F);
}

struct AttnArgs {
  const float* q;       // (B, KV, R, hd) f32, pre-scaled by 1/sqrt(hd)
  Pool k, v;
  const int* page_ids;  // (B, P), -1 = unassigned
  const int* n_valid;   // (B,)
  float* acc;           // (B, KV, R, hd)
  float* m;             // (B, KV, R)
  float* l;             // (B, KV, R)
  int KV, R, hd, P, n_pages, rows;  // rows: query rows per block
  Codec c;
};

// Copy `rows` rows of hd bytes (row stride F in the pool) into shared memory
// (row stride hd) with 4-byte loads, all independent so their latencies
// overlap.  The launcher has checked hd % 4 == 0 and 4-byte-aligned fields.
__device__ __forceinline__ void stage_rows(const uint8_t* g, int rows, int F, int hd,
                                           uint8_t* s) {
  const int wpr = hd >> 2, n = rows * wpr;
  uint32_t* s32 = reinterpret_cast<uint32_t*>(s);
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / wpr;
    s32[i] = *reinterpret_cast<const uint32_t*>(g + (size_t)r * F + 4 * (i - r * wpr));
  }
}

template <int MODE>
__global__ void __launch_bounds__(kAttnThreads) paged_attention_kernel(AttnArgs a) {
  extern __shared__ float smem[];
  const Codec& c = a.c;
  const int ps = c.nb * c.w;
  const int hd = a.hd;
  const int RT = a.rows;
  const int rows_kv = c.nb * (c.mask_rows + c.hi_rows + c.lo_rows);  // staged rows
  const int KS = hd + 1;              // K row stride: conflict-free score reads
  float* Kt = smem;                   // [ps][KS] decoded K tile of one page
  float* Vt = Kt + ps * KS;           // [ps][hd]
  float* Qs = Vt + ps * hd;           // [RT][hd]
  float* Acc = Qs + RT * hd;          // [RT][hd]
  float* S = Acc + RT * hd;           // [RT][ps] scores, then probabilities
  float* Mr = S + RT * ps;            // [RT]
  float* Lr = Mr + RT;                // [RT]
  float* Corr = Lr + RT;              // [RT]
  float* Sc = Corr + RT;              // [2][hd] K and V scales of the page
  uint8_t* Pk = reinterpret_cast<uint8_t*>(Sc + 2 * hd);  // [rows_kv][hd] K bytes
  uint8_t* Pv = Pk + rows_kv * hd;                        // [rows_kv][hd] V bytes

  const int t = threadIdx.x;
  const int b = blockIdx.x, g = blockIdx.y, r0 = blockIdx.z * RT;
  const int rows = min(RT, a.R - r0);
  const size_t head = (size_t)b * a.KV + g;

  for (int idx = t; idx < RT * hd; idx += blockDim.x) {
    const int r = idx / hd;
    Qs[idx] = r < rows ? a.q[(head * a.R + r0 + r) * hd + idx % hd] : 0.f;
    Acc[idx] = 0.f;
  }
  for (int r = t; r < RT; r += blockDim.x) {
    Mr[r] = kNegInf;
    Lr[r] = 0.f;
  }

  const int nv = a.n_valid[b];
  const int cols = c.nb * hd;  // block columns of one tile
  const int pairs = RT * ps;   // scores of one page
  int split = 1;               // threads per score: fill the block, at most a warp
  while (split < 32 && pairs * split * 2 <= (int)blockDim.x) split *= 2;
  const int items = (pairs * split + 31) / 32 * 32;
  const size_t col0 = (size_t)g * hd;
  for (int p = 0; p < a.P; ++p) {
    const int pid = a.page_ids[(size_t)b * a.P + p];
    if (pid < 0 || pid >= a.n_pages || p >= nv) continue;  // uniform per block
    // 1. this head's packed bytes of the page, K and V, into shared memory
    const size_t blk0 = (size_t)pid * c.nb;
    for (int kv = 0; kv < 2; ++kv) {
      const Pool& pool = kv ? a.v : a.k;
      uint8_t* dst = kv ? Pv : Pk;
      if (MODE == kGeneral) {
        stage_rows(pool.mask + blk0 * c.mask_rows * c.F + col0, c.nb * c.mask_rows, c.F,
                   hd, dst);
        dst += c.nb * c.mask_rows * hd;
        stage_rows(reinterpret_cast<const uint8_t*>(pool.hi) + blk0 * c.hi_rows * c.F + col0,
                   c.nb * c.hi_rows, c.F, hd, dst);
        dst += c.nb * c.hi_rows * hd;
      }
      stage_rows(pool.lo + blk0 * c.lo_rows * c.F + col0, c.nb * c.lo_rows, c.F, hd, dst);
      for (int d = t; d < hd; d += blockDim.x) Sc[kv * hd + d] = pool.scale[pid * (size_t)c.F + col0 + d];
    }
    __syncthreads();
    // 2. decode the K and V tiles from shared memory, one thread per column
    for (int idx = t; idx < 2 * cols; idx += blockDim.x) {
      const int kv = idx >= cols;
      const int rem = idx - kv * cols;
      const int blk = rem / hd, d = rem % hd;
      const uint8_t* base = kv ? Pv : Pk;
      const uint8_t* mcol = base + (blk * c.mask_rows) * hd + d;
      const uint8_t* hbase = base + (MODE == kGeneral ? c.nb * c.mask_rows * hd : 0);
      const int8_t* hcol = reinterpret_cast<const int8_t*>(hbase + (blk * c.hi_rows) * hd + d);
      const uint8_t* lbase = MODE == kGeneral ? hbase + c.nb * c.hi_rows * hd : base;
      const uint8_t* lcol = lbase + (blk * c.lo_rows) * hd + d;
      const int ds = kv ? hd : KS;
      decode_column<MODE>(mcol, hcol, lcol, hd, c, Sc[kv * hd + d],
                          (kv ? Vt : Kt) + (blk * c.w) * ds + d, ds);
    }
    __syncthreads();
    // 3. scores: `split` neighbouring threads per (row, position), each a
    // strided share of the head dim, summed by shuffles; every lane of a
    // warp takes part in the shuffles (items rounded up to whole warps)
    for (int i = t; i < items; i += blockDim.x) {
      const int pr = i / split, part = i % split;
      float s = 0.f;
      if (pr < pairs) {
        const float* qr = Qs + (pr / ps) * hd;
        const float* kr = Kt + (pr % ps) * KS;
        for (int d = part; d < hd; d += split) s += qr[d] * kr[d];
      }
      for (int o = split >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (pr < pairs && part == 0) S[pr] = s;
    }
    __syncthreads();
    // 4. online softmax, one thread per row
    for (int r = t; r < RT; r += blockDim.x) {
      float* sr = S + r * ps;
      const float m_prev = Mr[r];
      float m_new = m_prev;
      for (int tt = 0; tt < ps; ++tt) m_new = fmaxf(m_new, sr[tt]);
      float sum = 0.f;
      for (int tt = 0; tt < ps; ++tt) {
        const float e = expf(sr[tt] - m_new);
        sr[tt] = e;
        sum += e;
      }
      const float corr = expf(m_prev - m_new);  // 0 on the first live page
      Lr[r] = Lr[r] * corr + sum;
      Mr[r] = m_new;
      Corr[r] = corr;
    }
    __syncthreads();
    // 5. rescale and accumulate p . V
    for (int idx = t; idx < RT * hd; idx += blockDim.x) {
      const int r = idx / hd, d = idx % hd;
      const float* pr = S + r * ps;
      float s = 0.f;
      for (int tt = 0; tt < ps; ++tt) s += pr[tt] * Vt[tt * hd + d];
      Acc[idx] = Acc[idx] * Corr[r] + s;
    }
    __syncthreads();
  }

  __syncthreads();
  for (int idx = t; idx < rows * hd; idx += blockDim.x)
    a.acc[(head * a.R + r0) * hd + idx] = Acc[idx];
  for (int r = t; r < rows; r += blockDim.x) {
    a.m[head * a.R + r0 + r] = Mr[r];
    a.l[head * a.R + r0 + r] = Lr[r];
  }
}

Codec make_codec(int nb, int w, int F, int mask_rows, int hi_rows, int lo_rows,
                 int n_low, int q, int method) {
  Codec c;
  c.nb = nb; c.w = w; c.F = F;
  c.mask_rows = mask_rows; c.hi_rows = hi_rows; c.lo_rows = lo_rows;
  c.n_high = w - n_low; c.n_low = n_low; c.q = q; c.method = method;
  return c;
}

template <int MODE>
cudaError_t launch_attention(const AttnArgs& a, int B, cudaStream_t stream) {
  const int ps = a.c.nb * a.c.w;
  const size_t floats = (size_t)ps * (a.hd + 1) + (size_t)ps * a.hd + 2 * (size_t)a.rows * a.hd +
                        (size_t)a.rows * ps + 3 * (size_t)a.rows + 2 * (size_t)a.hd;
  const size_t rows_kv = (size_t)a.c.nb * (a.c.mask_rows + a.c.hi_rows + a.c.lo_rows);
  const size_t smem = floats * sizeof(float) + 2 * rows_kv * a.hd;
  auto kernel = paged_attention_kernel<MODE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(B, a.KV, (a.R + a.rows - 1) / a.rows);
  kernel<<<grid, kAttnThreads, smem, stream>>>(a);
  return cudaGetLastError();
}


// ------------------------------------------------ K4: split-KV attention --

constexpr int kSplitThreads = 256;
constexpr int kPosGroups = 4;   // warps that share a page's positions, 4 each
constexpr int kRowSets = kSplitThreads / 32 / kPosGroups;  // warps that share them by row
constexpr int kMaxSplitPages = 32;   // page slots per split (one warp ballot)
constexpr int kMaxPageSize = 64;     // positions of one page (nb * w)

struct SplitArgs {
  const float* q;       // (B, KV, R, hd) f32, pre-scaled by 1/sqrt(hd)
  Pool k, v;
  const int* page_ids;  // (B, P), -1 = unassigned
  const int* n_valid;   // (B,)
  float* acc;           // (S, B, KV, R, hd): one partial per split
  float* m;             // (S, B, KV, R)
  float* l;             // (S, B, KV, R)
  int B, KV, R, hd, P, n_pages, pps, tiles;  // pps: page slots per split
  Codec c;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copies of page `pid`'s head slice: for K then V, the nb*mask,
// nb*hi and nb*lo rows of hd bytes (row stride F in the pool, hd here), then
// the K and V scales (hd f32 each) after both.
__device__ __forceinline__ void stage_page(const SplitArgs& a, int pid, size_t col0,
                                           uint8_t* dst) {
  const Codec& c = a.c;
  const int hd = a.hd, vpr = hd >> 4;
  const int fr[3] = {c.nb * c.mask_rows, c.nb * c.hi_rows, c.nb * c.lo_rows};
  const int rows_kv = fr[0] + fr[1] + fr[2];
  const int n_rows = 2 * rows_kv * vpr, n_scale = 2 * (hd >> 2);
  float* sc = reinterpret_cast<float*>(dst + 2 * (size_t)rows_kv * hd);
  for (int i = threadIdx.x; i < n_rows + n_scale; i += blockDim.x) {
    if (i < n_rows) {
      const int row = i / vpr, vec = i - row * vpr;
      const int kv = row >= rows_kv;
      const Pool& pool = kv ? a.v : a.k;
      int r = row - kv * rows_kv, f = 0;
      while (r >= fr[f]) r -= fr[f++];  // f: 0 mask, 1 hi, 2 lo
      const uint8_t* base = f == 0 ? pool.mask
                            : f == 1 ? reinterpret_cast<const uint8_t*>(pool.hi)
                                     : pool.lo;
      cp_async16(dst + (size_t)row * hd + 16 * vec,
                 base + ((size_t)pid * fr[f] + r) * c.F + col0 + 16 * vec);
    } else {
      const int j = i - n_rows, per = hd >> 2;
      const int kv = j >= per, vec = j - kv * per;
      const Pool& pool = kv ? a.v : a.k;
      cp_async16(sc + kv * hd + 4 * vec, pool.scale + (size_t)pid * c.F + col0 + 4 * vec);
    }
  }
}

// One position of a [1, w] block held in registers: m the mask bits, h0/h1
// the hi bytes (rank order), l the lo fields, lut the decoded lo codes.  A
// position's rank among the high (low) set is the popcount of the set
// (clear) mask bits below it; both candidates are formed and one selected.
__device__ __forceinline__ float reg_value(uint32_t m, uint32_t h0, uint32_t h1, uint32_t l,
                                           const float* lut, int pos, int lmax, int q,
                                           uint32_t qmask) {
  const int rh = __popc(m & ((1u << pos) - 1u));
  const int rl = pos - rh;
  const float hv = (float)(int8_t)__byte_perm(h0, h1, (unsigned)(rh & 7));
  const float lv = lut[(l >> (min(rl, lmax) * q)) & qmask];
  return (m >> pos) & 1u ? hv : lv;
}

// Decode one staged [1, w] block column into dst[pos * dstride] (value x
// scale s).  Rows are `stride` bytes apart; the hi and lo fields have at
// least one row.  The common codecs (w <= 32, <= 8 hi and <= 4 lo rows)
// read the block's bytes once into registers, fully unrolled at w = 16,
// and decode lo codes through `lut`; the others read per position and
// select between both candidates, so lanes with different masks do not
// diverge.
__device__ __forceinline__ void decode_ranked(const uint8_t* mcol, const int8_t* hcol,
                                              const uint8_t* lcol, int stride,
                                              const Codec& c, const float* lut, float s,
                                              float* dst, int dstride) {
  const int lmax = c.method != kSparsity && c.n_low > 0 ? c.n_low - 1 : 0;  // lo row 0 exists
  if (c.w <= 32 && c.hi_rows <= 8 && c.lo_rows <= 4) {
    uint32_t m = 0, h0 = 0, h1 = 0, l = 0;
    for (int r = 0; r < c.mask_rows; ++r) m |= (uint32_t)mcol[(size_t)r * stride] << (8 * r);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r >= c.hi_rows) break;
      const uint32_t b = (uint8_t)hcol[(size_t)r * stride];
      if (r < 4) h0 |= b << (8 * r);
      else h1 |= b << (8 * (r - 4));
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (r >= c.lo_rows) break;
      l |= (uint32_t)lcol[(size_t)r * stride] << (8 * r);
    }
    const uint32_t qmask = c.method == kSparsity ? 0u : (1u << c.q) - 1u;
    if (c.w == 16) {
#pragma unroll
      for (int pos = 0; pos < 16; ++pos)
        dst[pos * dstride] = reg_value(m, h0, h1, l, lut, pos, lmax, c.q, qmask) * s;
      return;
    }
    for (int pos = 0; pos < c.w; ++pos)
      dst[pos * dstride] = reg_value(m, h0, h1, l, lut, pos, lmax, c.q, qmask) * s;
    return;
  }
  unsigned long long bits = 0;
  for (int byte = 0; byte < c.mask_rows; ++byte)
    bits |= (unsigned long long)mcol[(size_t)byte * stride] << (8 * byte);
  const int hmax = c.n_high > 0 ? c.n_high - 1 : 0;
  for (int pos = 0; pos < c.w; ++pos) {
    const int rh = __popcll(bits & ((1ull << pos) - 1ull));
    const int rl = pos - rh;
    const bool high = (bits >> pos) & 1ull;
    const float hv = (float)hcol[(size_t)min(rh, hmax) * stride];
    const float lv = decode_low(lo_field(lcol, c.lo_rows, stride, min(rl, lmax), c.q),
                                c.method, c.q);
    const float v = high ? (rh < c.n_high ? hv : 0.f) : (rl < c.n_low ? lv : 0.f);
    dst[pos * dstride] = v * s;
  }
}

// RT: query rows of the block's tile; CPL: head-dim columns per lane (hd <=
// 32 * CPL).  Grid (split, kv head * tiles, slot), kSplitThreads threads:
// warp w takes positions 4 (w % kPosGroups) + 16 j of each page and rows
// w / kPosGroups + kRowSets i of the tile.
template <int RT, int CPL>
__global__ void __launch_bounds__(kSplitThreads) paged_attention_split_kernel(SplitArgs a) {
  constexpr int RW = (RT + kRowSets - 1) / kRowSets;  // rows a warp carries
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int live[kMaxSplitPages];
  __shared__ int n_live;
  __shared__ float lut[256];  // lo code -> value (2^q <= 256 codes)
  const Codec& c = a.c;
  const int hd = a.hd, ps = c.nb * c.w;
  const int rows_kv = c.nb * (c.mask_rows + c.hi_rows + c.lo_rows);
  const int stage_bytes = 2 * rows_kv * hd + 8 * hd;  // K, V bytes + scales
  const int KS = hd + 8;  // K row stride: the 4 positions of a warp hit 4 bank groups
  uint8_t* ring = smem_raw;                                           // [2][stage_bytes]
  float* Kt = reinterpret_cast<float*>(smem_raw + 2 * (size_t)stage_bytes);  // [ps][KS]
  float* Vt = Kt + ps * KS;                                           // [ps][hd]
  float* Qs = Vt + ps * hd;                                           // [RT][hd]

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int pg = warp % kPosGroups, rs = warp / kPosGroups;
  const int split = blockIdx.x, b = blockIdx.z;
  const int g = blockIdx.y / a.tiles, r0 = (blockIdx.y % a.tiles) * RT;
  const int rows = min(RT, a.R - r0);
  const size_t head = (size_t)b * a.KV + g;
  const size_t prow = ((size_t)split * a.B * a.KV + head) * a.R + r0;  // partial row 0

  if (warp == 0) {  // the split's live pages, in table order
    const int p0 = split * a.pps, p1 = min(a.P, p0 + a.pps);
    const int p = p0 + lane, nv = a.n_valid[b];
    int pid = -1;
    if (p < p1) pid = a.page_ids[(size_t)b * a.P + p];
    const bool ok = p < p1 && pid >= 0 && pid < a.n_pages && p < nv;
    const unsigned bal = __ballot_sync(0xffffffffu, ok);
    if (ok) live[__popc(bal & ((1u << lane) - 1u))] = pid;
    if (lane == 0) n_live = __popc(bal);
  }
  if (c.method != kSparsity)
    for (int code = t; code < (1 << c.q); code += blockDim.x) lut[code] = decode_low(code, c.method, c.q);
  else if (t == 0)
    lut[0] = 0.f;
  for (int idx = t; idx < RT * hd; idx += blockDim.x) {
    const int r = idx / hd;
    Qs[idx] = r < rows ? a.q[(head * a.R + r0 + r) * hd + idx % hd] : 0.f;
  }
  __syncthreads();
  const int nl = n_live;
  if (nl == 0) {  // identity partial
    for (int idx = t; idx < rows * hd; idx += blockDim.x) a.acc[prow * hd + idx] = 0.f;
    for (int r = t; r < rows; r += blockDim.x) {
      a.m[prow + r] = kNegInf;
      a.l[prow + r] = 0.f;
    }
    return;
  }

  const size_t col0 = (size_t)g * hd;
  stage_page(a, live[0], col0, ring);
  cp_async_commit();

  float m_r[RW], l_r[RW], acc[RW][CPL];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) acc[i][cc] = 0.f;
  }
  const int cols = c.nb * hd;
  const int tl = lane >> 3, part = lane & 7;
  for (int i = 0; i < nl; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // (1) page i landed; every warp is done with page i - 1's tiles
    if (i + 1 < nl) stage_page(a, live[i + 1], col0, ring + ((i + 1) & 1) * stage_bytes);
    cp_async_commit();
    const uint8_t* st = ring + (i & 1) * stage_bytes;
    const float* sc = reinterpret_cast<const float*>(st + 2 * (size_t)rows_kv * hd);
    for (int idx = t; idx < 2 * cols; idx += blockDim.x) {
      const int kv = idx >= cols;
      const int rem = idx - kv * cols;
      const int blk = rem / hd, d = rem - blk * hd;
      const uint8_t* base = st + (size_t)kv * rows_kv * hd;
      const uint8_t* hbase = base + c.nb * c.mask_rows * hd;
      const uint8_t* lbase = hbase + c.nb * c.hi_rows * hd;
      const int ds = kv ? hd : KS;
      decode_ranked(base + blk * c.mask_rows * hd + d,
                    reinterpret_cast<const int8_t*>(hbase + blk * c.hi_rows * hd + d),
                    lbase + blk * c.lo_rows * hd + d, hd, c, lut, sc[kv * hd + d],
                    (kv ? Vt : Kt) + (blk * c.w) * ds + d, ds);
    }
    __syncthreads();  // (2) K and V tiles decoded
    for (int t0 = 4 * pg; t0 < ps; t0 += 4 * kPosGroups) {  // uniform per warp
      const int tt = t0 + tl;
      const bool valid = tt < ps;
      const float* kr = Kt + (valid ? tt : t0) * KS;
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int r = rs + kRowSets * i;
        if (r >= rows) break;
        const float* qr = Qs + r * hd;
        float s = 0.f;
        for (int d = part; d < hd; d += 8) s += qr[d] * kr[d];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s = valid ? s : kNegInf;
        float mx = fmaxf(s, __shfl_xor_sync(0xffffffffu, s, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m_r[i], mx);
        const float p = valid ? expf(s - m_new) : 0.f;
        float sum = p + __shfl_xor_sync(0xffffffffu, p, 8);
        sum += __shfl_xor_sync(0xffffffffu, sum, 16);
        const float corr = expf(m_r[i] - m_new);  // 0 on the warp's first live key
        l_r[i] = l_r[i] * corr + sum;
        m_r[i] = m_new;
        float pj[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) pj[j] = __shfl_sync(0xffffffffu, p, 8 * j);
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) {
          const int d = lane + 32 * cc;
          if (d < hd) {
            float pv = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (t0 + j < ps) pv += pj[j] * Vt[(t0 + j) * hd + d];
            acc[i][cc] = acc[i][cc] * corr + pv;
          }
        }
      }
    }
  }

  // merge the position groups' states of every row in group order; the
  // merge scratch overlays the ring and the tiles (no copy is in flight:
  // the last group was empty)
  cp_async_wait<0>();
  __syncthreads();
  float* Wm = reinterpret_cast<float*>(smem_raw);  // [groups][RT]
  float* Wl = Wm + kPosGroups * RT;                // [groups][RT]
  float* Wa = Wl + kPosGroups * RT;                // [groups][RT][hd]
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = rs + kRowSets * i;
    if (r >= rows) break;
    if (lane == 0) {
      Wm[pg * RT + r] = m_r[i];
      Wl[pg * RT + r] = l_r[i];
    }
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) {
      const int d = lane + 32 * cc;
      if (d < hd) Wa[(pg * RT + r) * hd + d] = acc[i][cc];
    }
  }
  __syncthreads();
  for (int idx = t; idx < rows * hd; idx += blockDim.x) {
    const int r = idx / hd, d = idx - r * hd;
    float M = kNegInf;
    for (int w = 0; w < kPosGroups; ++w) M = fmaxf(M, Wm[w * RT + r]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < kPosGroups; ++w) {
      const float e = expf(Wm[w * RT + r] - M);
      L += Wl[w * RT + r] * e;
      A += Wa[(w * RT + r) * hd + d] * e;
    }
    a.acc[prow * hd + idx] = A;
    if (d == 0) {
      a.m[prow + r] = M;
      a.l[prow + r] = L;
    }
  }
}

// Merge S split partials of every (slot, head, row) in split-index order:
// M = max m_s, l = sum l_s e^(m_s - M), acc = sum acc_s e^(m_s - M).  All
// splits empty gives the identity partial exactly.  One block per row.
__global__ void split_combine_kernel(const float* pacc, const float* pm, const float* pl,
                                     float* acc, float* m, float* l, int S, int rows,
                                     int hd) {
  const int row = blockIdx.x;
  float M = kNegInf;
  for (int s = 0; s < S; ++s) M = fmaxf(M, pm[(size_t)s * rows + row]);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float A = 0.f;
    for (int s = 0; s < S; ++s)
      A += pacc[((size_t)s * rows + row) * hd + d] * expf(pm[(size_t)s * rows + row] - M);
    acc[(size_t)row * hd + d] = A;
  }
  if (threadIdx.x == 0) {
    float L = 0.f;
    for (int s = 0; s < S; ++s) L += pl[(size_t)s * rows + row] * expf(pm[(size_t)s * rows + row] - M);
    m[row] = M;
    l[row] = L;
  }
}

template <int RT, int CPL>
cudaError_t launch_split_typed(const SplitArgs& a, int splits, cudaStream_t stream) {
  const int hd = a.hd, ps = a.c.nb * a.c.w;
  const size_t rows_kv = (size_t)a.c.nb * (a.c.mask_rows + a.c.hi_rows + a.c.lo_rows);
  const size_t stage = 2 * rows_kv * hd + 8 * (size_t)hd;
  const size_t main_bytes = 2 * stage + sizeof(float) * ((size_t)ps * (hd + 8) +
                                                         (size_t)ps * hd + (size_t)RT * hd);
  const size_t merge_bytes = sizeof(float) * kPosGroups * (size_t)RT * (hd + 2);
  const size_t smem = main_bytes > merge_bytes ? main_bytes : merge_bytes;
  auto kernel = paged_attention_split_kernel<RT, CPL>;
  // always raise the dynamic limit to this launch's need (the kernel has
  // static shared memory beside it)
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(splits, a.KV * a.tiles, a.B);
  kernel<<<grid, kSplitThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int RT>
cudaError_t launch_split_rows(const SplitArgs& a, int splits, cudaStream_t s) {
  if (a.hd <= 64) return launch_split_typed<RT, 2>(a, splits, s);
  if (a.hd <= 128) return launch_split_typed<RT, 4>(a, splits, s);
  return launch_split_typed<RT, 8>(a, splits, s);
}

}  // namespace

extern "C" int strum_page_decode_launch(const void* mask, const void* hi, const void* lo,
                                        const void* scale, void* out, int P, int nb, int w,
                                        int F, int mask_rows, int hi_rows, int lo_rows,
                                        int n_low, int q, int method, void* stream) {
  if (P <= 0 || nb <= 0 || w <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  Pool pool = {static_cast<const uint8_t*>(mask), static_cast<const int8_t*>(hi),
               static_cast<const uint8_t*>(lo), static_cast<const float*>(scale)};
  const Codec c = make_codec(nb, w, F, mask_rows, hi_rows, lo_rows, n_low, q, method);
  const size_t total = (size_t)P * nb * F;
  const unsigned blocks = (unsigned)((total + kDecodeThreads - 1) / kDecodeThreads);
  page_decode_kernel<<<blocks, kDecodeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pool, c, P, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// mode 1 = K5 (p = 1: lo only; mask/hi unused).  Mode 0 (K4) runs the
// split kernel (strum_paged_attention_split_launch) and is refused here.
extern "C" int strum_paged_attention_launch(
    int mode, const void* q, const void* k_mask, const void* k_hi, const void* k_lo,
    const void* k_scale, const void* v_mask, const void* v_hi, const void* v_lo,
    const void* v_scale, const void* page_ids, const void* n_valid, void* acc, void* m,
    void* l, int B, int KV, int R, int hd, int P, int n_pages, int nb, int w,
    int mask_rows, int hi_rows, int lo_rows, int n_low, int q_bits, int method,
    void* stream) {
  if (mode != kMaskfree || B <= 0 || KV <= 0 || R <= 0 || hd <= 0 || P <= 0 ||
      nb <= 0 || w <= 0)
    return (int)cudaErrorInvalidValue;
  // pages are staged with 4-byte loads: 4-byte rows and aligned fields
  const void* fields[] = {k_mask, k_hi, k_lo, v_mask, v_hi, v_lo};
  uintptr_t any = 0;
  for (const void* f : fields) any |= reinterpret_cast<uintptr_t>(f);
  if (hd % 4 != 0 || any % 4 != 0) return (int)cudaErrorInvalidValue;
  AttnArgs a;
  a.q = static_cast<const float*>(q);
  a.k = {static_cast<const uint8_t*>(k_mask), static_cast<const int8_t*>(k_hi),
         static_cast<const uint8_t*>(k_lo), static_cast<const float*>(k_scale)};
  a.v = {static_cast<const uint8_t*>(v_mask), static_cast<const int8_t*>(v_hi),
         static_cast<const uint8_t*>(v_lo), static_cast<const float*>(v_scale)};
  a.page_ids = static_cast<const int*>(page_ids);
  a.n_valid = static_cast<const int*>(n_valid);
  a.acc = static_cast<float*>(acc);
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.KV = KV; a.R = R; a.hd = hd; a.P = P; a.n_pages = n_pages;
  a.rows = R < kMaxRows ? R : kMaxRows;
  a.c = make_codec(nb, w, KV * hd, mask_rows, hi_rows, lo_rows, n_low, q_bits, method);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)launch_attention<kMaskfree>(a, B, s);
}

// K4: the split partials (S = ceil(P / pps) splits) into pacc / pm / pl,
// (S, B, KV, R, hd) and (S, B, KV, R); with S == 1 those are the outputs.
extern "C" int strum_paged_attention_split_launch(
    const void* q, const void* k_mask, const void* k_hi, const void* k_lo,
    const void* k_scale, const void* v_mask, const void* v_hi, const void* v_lo,
    const void* v_scale, const void* page_ids, const void* n_valid, void* pacc, void* pm,
    void* pl, int B, int KV, int R, int hd, int P, int n_pages, int pps, int nb, int w,
    int mask_rows, int hi_rows, int lo_rows, int n_low, int q_bits, int method,
    void* stream) {
  if (B <= 0 || KV <= 0 || R <= 0 || P <= 0 || nb <= 0 || pps <= 0 ||
      pps > kMaxSplitPages || w % 8 != 0 || w > 64 || nb * w > kMaxPageSize ||
      mask_rows != w / 8 || hi_rows <= 0 || lo_rows <= 0)
    return (int)cudaErrorInvalidValue;
  // 16-byte staging: whole 16-byte row slices and aligned fields
  const void* fields[] = {k_mask, k_hi, k_lo, k_scale, v_mask, v_hi, v_lo, v_scale};
  uintptr_t any = 0;
  for (const void* f : fields) any |= reinterpret_cast<uintptr_t>(f);
  if (hd <= 0 || hd % 16 != 0 || hd > 256 || any % 16 != 0)
    return (int)cudaErrorInvalidValue;
  SplitArgs a;
  a.q = static_cast<const float*>(q);
  a.k = {static_cast<const uint8_t*>(k_mask), static_cast<const int8_t*>(k_hi),
         static_cast<const uint8_t*>(k_lo), static_cast<const float*>(k_scale)};
  a.v = {static_cast<const uint8_t*>(v_mask), static_cast<const int8_t*>(v_hi),
         static_cast<const uint8_t*>(v_lo), static_cast<const float*>(v_scale)};
  a.page_ids = static_cast<const int*>(page_ids);
  a.n_valid = static_cast<const int*>(n_valid);
  a.acc = static_cast<float*>(pacc);
  a.m = static_cast<float*>(pm);
  a.l = static_cast<float*>(pl);
  a.B = B; a.KV = KV; a.R = R; a.hd = hd; a.P = P; a.n_pages = n_pages; a.pps = pps;
  a.c = make_codec(nb, w, KV * hd, mask_rows, hi_rows, lo_rows, n_low, q_bits, method);
  const int splits = (P + pps - 1) / pps;
  // row tile: 1 at decode, else 8 or 16 (8 where a lane holds 8 columns)
  const int rt = R == 1 ? 1 : (R <= 8 || hd > 128) ? 8 : 16;
  a.tiles = (R + rt - 1) / rt;
  if ((long long)KV * a.tiles > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = rt == 1   ? launch_split_rows<1>(a, splits, s)
                  : rt == 8 ? launch_split_rows<8>(a, splits, s)
                            : launch_split_typed<16, 4>(a, splits, s);
  return (int)e;
}

// K4's merge of S > 1 split partials into acc (B, KV, R, hd), m, l (B, KV, R).
extern "C" int strum_attention_combine_launch(const void* pacc, const void* pm,
                                              const void* pl, void* acc, void* m, void* l,
                                              int S, int rows, int hd, void* stream) {
  if (S <= 0 || rows <= 0 || hd <= 0) return (int)cudaErrorInvalidValue;
  const int threads = hd >= 128 ? 128 : ((hd + 31) / 32) * 32;
  split_combine_kernel<<<rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pacc), static_cast<const float*>(pm),
      static_cast<const float*>(pl), static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), S, rows, hd);
  return (int)cudaGetLastError();
}
