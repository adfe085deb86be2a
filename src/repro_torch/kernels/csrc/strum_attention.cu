// StruM-packed KV pages on Hopper (sm_90a): page decode and the sealed-page
// partial of paged attention.
//
// Replaces the TPU kernels
//   K11 strum_page_decode_launch                  <- strum_page_decode_pallas
//                                                    (src/repro/kernels/strum_decode.py)
//   K4  strum_paged_attention_split_launch        <- strum_paged_attention_pallas
//   K5  strum_paged_attention_maskfree_split_launch
//                                                 <- strum_paged_attention_pallas_maskfree
//       (+ strum_attention_combine_launch, the merge of their KV splits;
//        both in src/repro/kernels/strum_attention.py)
//
// Packed page layout (one [1, w] block per w cache positions of a feature
// channel; F = n_kv_heads * head_dim contiguous in every field):
//   mask  (n_pages, nb, mask_rows, F)  uint8, LSB-first, 1 = high
//   hi    (n_pages, nb, hi_rows, F)    int8, the n_high high values in order
//   lo    (n_pages, nb, lo_rows, F)    uint8, n_low q-bit fields, LSB-first
//   scale (n_pages, F)                 f32 per-page, per-channel scale
// A page holds nb * w cache positions.  p = 1 pages (K5) have only lo and
// scale: the lo fields are the block's w values in position order.
//
// K11's design: a thread owns VEC = 4 adjacent channels of one [1, w] block
// (VEC = 1 where F % 4 != 0 or a field is not aligned).  Each of the block
// column's w / 8 mask, n_high hi and ceil(n_low q / 8) lo rows is one 4-byte
// load through the read-only path (a warp reads 128 contiguous bytes a row),
// all issued before any decode, as no address depends on the mask.  A 4x4
// byte transpose gives each channel its mask, hi and lo words, and each
// position is decoded in registers with K4's recipe (reg_value): its rank
// among the high / low positions is a popcount of the mask bits below it,
// the hi byte one __byte_perm, the lo code one shift of the lo word (a q = 3
// field that straddles two bytes needs no second load) through a table of
// the 2^q codes; sparsity and n_low = 0 read no lo row, and at p = 1 the
// mask is zero, so position i takes field i.  Each position is one
// evict-first float4 store (__stcs; a warp writes 512 contiguous bytes).
// The registers hold w <= 64, 16 hi and 8 lo rows; past that the staged
// path lands the same loads in the thread's own column of shared memory and
// reads each position's bytes at its ranks.  The decoded integer is multiplied by the
// channel's f32 scale in one rounding, so K11 equals its plain PyTorch
// version bit for bit.
//
// What bounds them: all three read each packed byte once and do little
// arithmetic per byte, so they are bound by HBM bytes (K11 by the f32 values
// it writes, 4 / 0.875 times the packed bytes at the default codec).  The
// point of the packed pages is that attention reads 14/16 of the int8 bytes
// (mip2q, w = 16, p = .5), 8/16 at p = 1, and never a decoded copy.
//
// K4 and K5 design (split-KV, flash-decoding; one kernel, MODE picks the
// fields): a serial page chain per (slot, head) was the time of the first
// designs (~6.5 us a page x 128 pages at OLMo-1B decode on an H100 SXM at
// 700 W, 118x the byte bound), so the grid is (KV split, kv head x row tile,
// slot).  Each split owns `pps` consecutive page slots of the table; warp 0
// reads them, keeps the live ids in order (ballot + popcount) and a split
// with none writes the identity partial and returns.  A page is walked in
// pieces of at most kMaxPageSize positions (`bpp` = kMaxPageSize / w blocks;
// a page of nb blocks has ceil(nb / bpp) pieces, and the online state runs on
// across them), so a page of any size takes the same shared memory.  A
// piece's head slice of K and V -- bpp * (mask + hi + lo) rows of hd bytes at
// row stride F (lo rows only for K5: the mask and hi pointers are null and no
// code path reads them) -- and its 2 x hd scales come in by 16-byte
// cp.async.cg into a two-stage shared-memory ring, so the next piece is in
// flight while the current one decodes; where hd % 16 != 0 or a field is not
// 16-byte aligned the same rows are staged with plain loads into the same
// ring.  Per piece there are two block barriers: (1) the piece has landed
// (and the last piece's tiles are free), after which the next piece's copy
// is issued; (2) the K and V tiles are decoded (one thread per block column
// of K and V).  K4's decode holds a block's mask, hi and lo bytes in four
// registers, a position's rank among the high / low set is the popcount of
// the lower mask bits and lo codes decode through a table in shared memory;
// K5's loads the column's lo bytes as one 64-bit word and position i is
// lut[(word >> q i) & (2^q - 1)] (no popcount, no select).  Then each of 4
// position groups of warps takes 4 positions of the piece, 8 lanes per
// position, and within a group 2 warps split the tile's rows: scores by
// 8-lane __shfl_xor_sync sums over hd, the max and the sum of the softmax by
// __shfl_xor_sync across the 4 positions, and P.V into registers (a lane owns
// hd / 32 columns).  Every warp keeps its own online state (m, l, acc) for
// its rows; at the end the position groups are merged in order.  All
// arithmetic is f32 (q pre-scaled, decoded values int x scale): at R = 1 a
// tensor core buys nothing, and at R = 16 bf16 operands would not hold the
// 2e-5 tolerance.  With more than one split, each split writes its partial
// to scratch and split_combine_kernel merges the splits of every row in
// split-index order (never arrival order), so the result does not depend on
// block scheduling.  The second kernel was chosen over a last-arriving-block
// merge: it needs no zeroed counters kept between calls and no fences, and
// costs one launch per layer per lane run against ~2000 a tick.
// Contract: 0 < hd <= 256 (a lane's columns and the tiles' shared memory),
// w <= 64 (K4 also w % 8 == 0), pages per split <= 32.  The launchers return
// cudaErrorInvalidValue for anything else.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Method { kSparsity = 0, kDliq = 1, kMip2q = 2 };
enum Mode { kGeneral = 0, kMaskfree = 1 };

constexpr int kDecodeThreads = 128;   // K11's block
constexpr size_t kStagedSmem = 200 * 1024;  // K11 staged path: its columns' bytes, at most
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

// A position's rank among the high (low) positions of its block is the
// popcount of the set (clear) mask bits below it.
__device__ __forceinline__ int popc_below(uint32_t m, int pos) {
  return __popc(m & ((1u << pos) - 1u));
}
__device__ __forceinline__ int popc_below(uint64_t m, int pos) {
  return __popcll(m & ((1ull << pos) - 1ull));
}

// One position of a [1, w] block held in registers (K4 and K11): m the mask
// bits, h the hi bytes in rank order (4 a word, HW words: 4 HW high values),
// l the lo fields, lut the decoded lo codes.  Both candidates are formed and
// one selected, so lanes with different masks do not diverge.  The hi byte
// is one byte permute at the high rank (two and a select at HW = 4; a block
// has exactly n_high set bits, so a high position's rank is below n_high),
// the lo code one shift of l at the low rank, clamped to the last field
// (lmax) so that the shift stays inside the word.
template <int HW, typename MT, typename LT>
__device__ __forceinline__ float reg_value(MT m, const uint32_t (&h)[HW], LT l,
                                           const float* lut, int pos, int lmax, int q,
                                           LT qmask) {
  static_assert(HW == 2 || HW == 4, "2 or 4 hi words");
  const int rh = popc_below(m, pos);
  const int rl = pos - rh;
  uint32_t hb = __byte_perm(h[0], h[1], (unsigned)(rh & 7));
  if constexpr (HW == 4) {
    if (rh & 8) hb = __byte_perm(h[2], h[3], (unsigned)(rh & 7));
  }
  const float hv = (float)(int8_t)hb;
  const float lv = lut[(unsigned)((l >> (min(rl, lmax) * q)) & qmask)];
  return (m >> pos) & 1u ? hv : lv;
}

// ---------------------------------------------------------- K11: page decode --

// One row of a block column: the bytes of VEC adjacent channels in one load
// through the read-only path (VEC = 1: byte 0 of the word).
template <int VEC>
__device__ __forceinline__ uint32_t load_row(const uint8_t* p) {
  if constexpr (VEC == 4) return __ldg(reinterpret_cast<const unsigned int*>(p));
  else return __ldg(p);
}

// Rows r[0..3] of 4 channels (byte c of r[i] is channel c's byte of row i)
// -> one word a channel (byte i of out[c] is row i): a 4x4 byte transpose in
// eight byte permutes.  With VEC = 1 only out[0] is used.
__device__ __forceinline__ void transpose4(const uint32_t* r, uint32_t* out) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362), t3 = __byte_perm(r[2], r[3], 0x7362);
  out[0] = __byte_perm(t0, t1, 0x5410);
  out[1] = __byte_perm(t0, t1, 0x7632);
  out[2] = __byte_perm(t2, t3, 0x5410);
  out[3] = __byte_perm(t2, t3, 0x7632);
}

// Rows [0, n) of a field's block column (n <= 4 G; rows past n are 0), every
// load issued before the first transpose: w[c][g] holds channel c's bytes of
// rows 4 g .. 4 g + 3, in row order.
template <int VEC, int G>
__device__ __forceinline__ void load_rows(const uint8_t* col, size_t stride, int n,
                                          uint32_t (&w)[VEC][G]) {
  uint32_t raw[4 * G];
#pragma unroll
  for (int r = 0; r < 4 * G; ++r) raw[r] = r < n ? load_row<VEC>(col + r * stride) : 0u;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    uint32_t t[4];
    transpose4(raw + 4 * g, t);
#pragma unroll
    for (int c = 0; c < VEC; ++c) w[c][g] = t[c];
  }
}

template <int VEC>
__device__ __forceinline__ void load_scales(const float* p, float (&s)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    s[0] = v.x; s[1] = v.y; s[2] = v.z; s[3] = v.w;
  } else {
    s[0] = __ldg(p);
  }
}

// One position of VEC adjacent channels: one 16-byte (4-byte) evict-first
// store, a warp writing 32 VEC contiguous floats.
template <int VEC>
__device__ __forceinline__ void store_values(float* dst, const float (&v)[VEC]) {
  if constexpr (VEC == 4)
    __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
  else
    __stcs(dst, v[0]);
}

// Position pos of a block column's VEC channels, from registers, stored.
template <int VEC, int HW, typename MT, typename LT>
__device__ __forceinline__ void decode_position(float* dst, const MT (&m)[VEC],
                                                const uint32_t (&h)[VEC][HW],
                                                const LT (&l)[VEC], const float (&s)[VEC],
                                                const float* lut, int pos, int lmax, int q,
                                                LT qmask) {
  float v[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c)
    v[c] = reg_value<HW>(m[c], h[c], l[c], lut, pos, lmax, q, qmask) * s[c];
  store_values<VEC>(dst, v);
}

// The lo code table: 2^q decoded codes, 0 everywhere when the block has no
// lo path (sparsity, n_low = 0), so a rank past the fields reads 0 there.
__device__ __forceinline__ void fill_lut(float* lut, const Codec& c, bool lo_on) {
  for (int code = threadIdx.x; code < 256; code += blockDim.x)
    lut[code] = lo_on && code < (1 << c.q) ? decode_low(code, c.method, c.q) : 0.f;
  __syncthreads();
}

// K11, register path (w <= 64, n_high <= 4 HW, n_low q <= 8 sizeof(LT)):
// thread (x) owns VEC adjacent channels of one [1, w] block (grid y walks
// the P nb blocks).  The block column's w / 8 mask, n_high hi and
// ceil(n_low q / 8) lo rows are one VEC-byte load each, all issued up front
// (no address depends on the mask), transposed to per-channel words; then
// each position is decoded from registers and stored, one VEC-wide store.
// out (P, nb w, F) f32: value x the page's channel scale, one rounding.
template <int VEC, int HW, typename LT>
__global__ void __launch_bounds__(kDecodeThreads)
page_decode_kernel(Pool pool, Codec c, int n_blocks, float* out) {
  constexpr int LG = sizeof(LT) / 4;  // lo words a channel
  __shared__ float lut[256];
  const bool lo_on = c.method != kSparsity && c.n_low > 0;
  fill_lut(lut, c, lo_on);
  const int f0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (f0 >= c.F) return;
  const size_t F = c.F;
  const int n_high = c.n_high;
  const int lo_n = lo_on ? (c.n_low * c.q + 7) >> 3 : 0;
  const int lmax = lo_on ? c.n_low - 1 : 0;
  const LT qmask = lo_on ? (LT)((1u << c.q) - 1u) : (LT)0;
  for (int blk = blockIdx.y; blk < n_blocks; blk += gridDim.y) {
    uint32_t mw[VEC][2], h[VEC][HW], lw[VEC][LG];
    float s[VEC];
    load_rows<VEC, 2>(pool.mask + (size_t)blk * c.mask_rows * F + f0, F, c.w >> 3, mw);
    load_rows<VEC, HW>(reinterpret_cast<const uint8_t*>(pool.hi) +
                       (size_t)blk * c.hi_rows * F + f0, F, n_high, h);
    load_rows<VEC, LG>(pool.lo + (size_t)blk * c.lo_rows * F + f0, F, lo_n, lw);
    load_scales<VEC>(pool.scale + (size_t)(blk / c.nb) * F + f0, s);
    LT l[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      l[k] = (LT)lw[k][0];
      if constexpr (LG == 2) l[k] |= (LT)lw[k][1] << 32;
    }
    float* dst = out + (size_t)blk * c.w * F + f0;
    if (c.w <= 32) {
      uint32_t m[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) m[k] = mw[k][0];
      if (c.w == 16) {
#pragma unroll
        for (int pos = 0; pos < 16; ++pos)
          decode_position<VEC, HW>(dst + pos * F, m, h, l, s, lut, pos, lmax, c.q, qmask);
      } else {
        for (int pos = 0; pos < c.w; ++pos)
          decode_position<VEC, HW>(dst + pos * F, m, h, l, s, lut, pos, lmax, c.q, qmask);
      }
    } else {
      uint64_t m[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) m[k] = mw[k][0] | (uint64_t)mw[k][1] << 32;
      for (int pos = 0; pos < c.w; ++pos)
        decode_position<VEC, HW>(dst + pos * F, m, h, l, s, lut, pos, lmax, c.q, qmask);
    }
  }
}

// K11, staged path (w > 64, or more hi or lo rows than the register path
// holds): the same loads, all issued up front, land in the thread's own
// column of shared memory (row r at word r x blockDim.x + thread, so the
// rank-indexed reads of a warp hit 32 distinct banks), then each position
// reads its hi byte and lo field (one or two words) at its clamped ranks;
// the mask is read 64 positions at a time and the ranks carry across.
template <int VEC>
__global__ void __launch_bounds__(kDecodeThreads)
page_decode_staged_kernel(Pool pool, Codec c, int n_blocks, float* out) {
  // [w / 8 + max(n_high, 1) + max(lo_n, 1)][blockDim.x]: an empty field keeps
  // one zero row, which a clamped rank may read
  extern __shared__ uint32_t col_rows[];
  __shared__ float lut[256];
  const bool lo_on = c.method != kSparsity && c.n_low > 0;
  fill_lut(lut, c, lo_on);
  const int f0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (f0 >= c.F) return;  // no barrier follows
  const size_t F = c.F;
  const int T = blockDim.x, mr = c.w >> 3, n_high = c.n_high;
  const int lo_n = lo_on ? (c.n_low * c.q + 7) >> 3 : 0;
  const int hmax = max(n_high - 1, 0), lmax = lo_on ? c.n_low - 1 : 0;
  const uint32_t qmask = lo_on ? (1u << c.q) - 1u : 0u;
  uint32_t* mrow = col_rows + threadIdx.x;  // row r of this thread: [r * T]
  uint32_t* hrow = mrow + mr * T;
  uint32_t* lrow = hrow + max(n_high, 1) * T;
  if (n_high == 0) hrow[0] = 0u;
  if (lo_n == 0) lrow[0] = 0u;
  for (int blk = blockIdx.y; blk < n_blocks; blk += gridDim.y) {
    const uint8_t* mcol = pool.mask + (size_t)blk * c.mask_rows * F + f0;
    const uint8_t* hcol = reinterpret_cast<const uint8_t*>(pool.hi) +
                          (size_t)blk * c.hi_rows * F + f0;
    const uint8_t* lcol = pool.lo + (size_t)blk * c.lo_rows * F + f0;
#pragma unroll 8
    for (int r = 0; r < mr; ++r) mrow[r * T] = load_row<VEC>(mcol + r * F);
#pragma unroll 8
    for (int r = 0; r < n_high; ++r) hrow[r * T] = load_row<VEC>(hcol + r * F);
#pragma unroll 8
    for (int r = 0; r < lo_n; ++r) lrow[r * T] = load_row<VEC>(lcol + r * F);
    float s[VEC];
    load_scales<VEC>(pool.scale + (size_t)(blk / c.nb) * F + f0, s);
    float* dst = out + (size_t)blk * c.w * F + f0;
    int rh0[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) rh0[k] = 0;
    for (int base = 0; base < c.w; base += 64) {
      const int n = min(64, c.w - base);
      uint32_t raw[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) raw[r] = r < (n >> 3) ? mrow[((base >> 3) + r) * T] : 0u;
      uint32_t t0[4], t1[4];
      transpose4(raw, t0);
      transpose4(raw + 4, t1);
#pragma unroll 4
      for (int pos = 0; pos < n; ++pos) {
        float v[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const uint64_t m = t0[k] | (uint64_t)t1[k] << 32;
          const int rh = rh0[k] + popc_below(m, pos), rl = base + pos - rh;
          const float hv = (float)(int8_t)(hrow[min(rh, hmax) * T] >> (8 * k));
          const int bit = min(rl, lmax) * c.q, byte = bit >> 3;
          uint32_t lb = (lrow[byte * T] >> (8 * k)) & 0xFFu;
          if (byte + 1 < lo_n) lb |= ((lrow[(byte + 1) * T] >> (8 * k)) & 0xFFu) << 8;
          const float lv = lut[(lb >> (bit & 7)) & qmask];
          v[k] = ((m >> pos) & 1u ? hv : lv) * s[k];
        }
        store_values<VEC>(dst + (size_t)(base + pos) * F, v);
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) rh0[k] += __popcll(t0[k] | (uint64_t)t1[k] << 32);
    }
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


// K11's grid: x over groups of VEC channels (a block of up to kDecodeThreads
// threads), y over the P nb blocks (a stride loop past 65535).  The register
// path's instantiation by the rows its block column needs (n_high hi, lo_n
// lo); the staged path with as many threads as its shared memory allows.
template <int VEC>
cudaError_t launch_page_decode(const Pool& pool, const Codec& c, int n_blocks, bool staged,
                               int n_high, int lo_n, float* out,
                               cudaStream_t s) {
  const int groups = c.F / VEC;
  int threads = groups < kDecodeThreads ? (groups + 31) / 32 * 32 : kDecodeThreads;
  const size_t row_bytes =  // staged: one thread's column
      4 * (size_t)(c.w / 8 + (n_high > 1 ? n_high : 1) + (lo_n > 1 ? lo_n : 1));
  if (staged)
    while (threads > 32 && row_bytes * threads > kStagedSmem) threads -= 32;
  if (staged && row_bytes * threads > kStagedSmem) return cudaErrorInvalidValue;
  const dim3 grid((groups + threads - 1) / threads, n_blocks < 65535 ? n_blocks : 65535);
  if (staged) {
    auto kernel = page_decode_staged_kernel<VEC>;
    const int smem = (int)(row_bytes * threads);
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, threads, smem, s>>>(pool, c, n_blocks, out);
  } else if (n_high <= 8 && lo_n <= 4) {
    page_decode_kernel<VEC, 2, uint32_t><<<grid, threads, 0, s>>>(pool, c, n_blocks, out);
  } else if (n_high <= 8) {
    page_decode_kernel<VEC, 2, uint64_t><<<grid, threads, 0, s>>>(pool, c, n_blocks, out);
  } else if (lo_n <= 4) {
    page_decode_kernel<VEC, 4, uint32_t><<<grid, threads, 0, s>>>(pool, c, n_blocks, out);
  } else {
    page_decode_kernel<VEC, 4, uint64_t><<<grid, threads, 0, s>>>(pool, c, n_blocks, out);
  }
  return cudaGetLastError();
}

// ------------------------------------------- K4, K5: split-KV attention --

constexpr int kSplitThreads = 256;
constexpr int kPosGroups = 4;   // warps that share a piece's positions, 4 each
constexpr int kRowSets = kSplitThreads / 32 / kPosGroups;  // warps that share them by row
constexpr int kMaxSplitPages = 32;   // page slots per split (one warp ballot)
constexpr int kMaxPageSize = 64;     // positions of one piece of a page
constexpr int kMaxHeadDim = 256;     // 32 lanes x 8 columns

struct SplitArgs {
  const float* q;       // (B, KV, R, hd) f32, pre-scaled by 1/sqrt(hd)
  Pool k, v;            // K5: mask and hi null
  const int* page_ids;  // (B, P), -1 = unassigned
  const int* n_valid;   // (B,)
  float* acc;           // (S, B, KV, R, hd): one partial per split
  float* m;             // (S, B, KV, R)
  float* l;             // (S, B, KV, R)
  int B, KV, R, hd, P, n_pages, pps, tiles;  // pps: page slots per split
  int bpp;              // w-blocks of one piece (<= kMaxPageSize / w)
  int vec16;            // 16-byte cp.async staging; else plain loads
  Codec c;              // K5: mask_rows = hi_rows = 0
};

// Byte layout of one ring stage: K's rows (bpp blocks' mask, then hi, then
// lo rows, hd bytes each), V's rows, then the K and V scales (hd f32 each)
// at a 16-byte boundary.
struct StageLayout {
  int rows_kv, sc_off, bytes;
  __host__ __device__ StageLayout(const Codec& c, int bpp, int hd) {
    rows_kv = bpp * (c.mask_rows + c.hi_rows + c.lo_rows);
    sc_off = (2 * rows_kv * hd + 15) & ~15;
    bytes = (sc_off + 8 * hd + 15) & ~15;
  }
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

// Issue the copies of piece `pc` of page `pid`'s head slice (its blocks
// [pc * bpp, pc * bpp + nbp)): for K then V, the mask, hi and lo rows of
// those blocks (row stride F in the pool, hd here), then the K and V scales.
// 16-byte cp.async where allowed, else one byte (one f32 scale) a thread.
template <bool VEC16>
__device__ __forceinline__ void stage_piece(const SplitArgs& a, int pid, int pc,
                                            size_t col0, uint8_t* dst) {
  const Codec& c = a.c;
  const int hd = a.hd, b0 = pc * a.bpp, nbp = min(a.bpp, c.nb - b0);
  const int rf[3] = {c.mask_rows, c.hi_rows, c.lo_rows};
  const StageLayout lay(c, a.bpp, hd);
  const int live = nbp * (rf[0] + rf[1] + rf[2]);  // rows of K (V) this piece fills
  constexpr int unit = VEC16 ? 16 : 1;
  const int upr = hd / unit;
  const int n_rows = 2 * live * upr, n_sc = VEC16 ? 2 * (hd >> 2) : 2 * hd;
  float* sc = reinterpret_cast<float*>(dst + lay.sc_off);
  const size_t blk0 = (size_t)pid * c.nb + b0;
  for (int i = threadIdx.x; i < n_rows + n_sc; i += blockDim.x) {
    if (i < n_rows) {
      const int row = i / upr, u = i - row * upr;
      const int kv = row >= live;
      const Pool& pool = kv ? a.v : a.k;
      int r = row - kv * live, f = 0, off = 0;
      while (r >= nbp * rf[f]) {  // f: 0 mask, 1 hi, 2 lo (K5 skips the empty two)
        r -= nbp * rf[f];
        off += a.bpp * rf[f];
        ++f;
      }
      const uint8_t* base = f == 0 ? pool.mask
                            : f == 1 ? reinterpret_cast<const uint8_t*>(pool.hi)
                                     : pool.lo;
      const uint8_t* src = base + (blk0 * rf[f] + r) * c.F + col0 + (size_t)unit * u;
      uint8_t* d = dst + (size_t)(kv * lay.rows_kv + off + r) * hd + unit * u;
      if (VEC16) cp_async16(d, src);
      else *d = *src;
    } else {
      const int j = i - n_rows;
      if (VEC16) {
        const int per = hd >> 2, kv = j >= per, vec = j - kv * per;
        cp_async16(sc + kv * hd + 4 * vec,
                   (kv ? a.v : a.k).scale + (size_t)pid * c.F + col0 + 4 * vec);
      } else {
        const int kv = j >= hd, d = j - kv * hd;
        sc[kv * hd + d] = (kv ? a.v : a.k).scale[(size_t)pid * c.F + col0 + d];
      }
    }
  }
}

// K4: decode one staged [1, w] block column into dst[pos * dstride] (value
// x scale s).  Rows are `stride` bytes apart; the hi and lo fields have at
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
    uint32_t m = 0, h[2] = {0u, 0u}, l = 0;
    for (int r = 0; r < c.mask_rows; ++r) m |= (uint32_t)mcol[(size_t)r * stride] << (8 * r);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r >= c.hi_rows) break;
      h[r >> 2] |= (uint32_t)(uint8_t)hcol[(size_t)r * stride] << (8 * (r & 3));
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
        dst[pos * dstride] = reg_value<2>(m, h, l, lut, pos, lmax, c.q, qmask) * s;
      return;
    }
    for (int pos = 0; pos < c.w; ++pos)
      dst[pos * dstride] = reg_value<2>(m, h, l, lut, pos, lmax, c.q, qmask) * s;
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

// K5: decode one staged p = 1 block column (w q-bit lo fields in position
// order).  Up to 8 lo rows (w q <= 64 bits: w = 16 at q <= 4) the column's
// bytes are one 64-bit word and position i is lut[(word >> q i) & qmask],
// fully unrolled at w = 16 (constant shifts at q = 4); more rows read each
// field from the staged bytes.
__device__ __forceinline__ void decode_lo(const uint8_t* lcol, int stride, const Codec& c,
                                          const float* lut, float s, float* dst,
                                          int dstride) {
  if (c.lo_rows <= 8) {
    unsigned long long word = 0;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r >= c.lo_rows) break;
      word |= (unsigned long long)lcol[(size_t)r * stride] << (8 * r);
    }
    if (c.w == 16 && c.q == 4) {
#pragma unroll
      for (int pos = 0; pos < 16; ++pos)
        dst[pos * dstride] = lut[(word >> (4 * pos)) & 0xFull] * s;
      return;
    }
    const unsigned long long qmask = (1ull << c.q) - 1ull;
    if (c.w == 16) {
#pragma unroll
      for (int pos = 0; pos < 16; ++pos)
        dst[pos * dstride] = lut[(word >> (pos * c.q)) & qmask] * s;
      return;
    }
    for (int pos = 0; pos < c.w; ++pos)
      dst[pos * dstride] = lut[(word >> (pos * c.q)) & qmask] * s;
    return;
  }
  for (int pos = 0; pos < c.w; ++pos)
    dst[pos * dstride] = lut[lo_field(lcol, c.lo_rows, stride, pos, c.q)] * s;
}

// MODE: kGeneral (K4, mask + hi + lo) or kMaskfree (K5, lo only).  RT:
// query rows of the block's tile; CPL: head-dim columns per lane (hd <= 32 *
// CPL).  Grid (split, kv head * tiles, slot), kSplitThreads threads: warp w
// takes positions 4 (w % kPosGroups) + 16 j of each piece and rows
// w / kPosGroups + kRowSets i of the tile.
template <int MODE, int RT, int CPL, bool VEC16>
__global__ void __launch_bounds__(kSplitThreads) paged_attention_split_kernel(SplitArgs a) {
  constexpr int RW = (RT + kRowSets - 1) / kRowSets;  // rows a warp carries
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int live[kMaxSplitPages];
  __shared__ int n_live;
  __shared__ float lut[256];  // lo code -> value (2^q <= 256 codes)
  const Codec& c = a.c;
  const int hd = a.hd, pmax = a.bpp * c.w;           // positions of a full piece
  const int npc = (c.nb + a.bpp - 1) / a.bpp;         // pieces of a page
  const StageLayout lay(c, a.bpp, hd);
  const int KS = hd + 8;  // K row stride: the 4 positions of a warp hit 4 bank groups
  uint8_t* ring = smem_raw;                                            // [2][lay.bytes]
  float* Kt = reinterpret_cast<float*>(smem_raw + 2 * (size_t)lay.bytes);  // [pmax][KS]
  float* Vt = Kt + pmax * KS;                                          // [pmax][hd]
  float* Qs = Vt + pmax * hd;                                          // [RT][hd]

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
  const int items = nl * npc;  // (live page, piece) in order
  stage_piece<VEC16>(a, live[0], 0, col0, ring);
  cp_async_commit();

  float m_r[RW], l_r[RW], acc[RW][CPL];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) acc[i][cc] = 0.f;
  }
  const int tl = lane >> 3, part = lane & 7;
  int pc = 0, next_pg = npc > 1 ? 0 : 1, next_pc = npc > 1 ? 1 : 0;  // item it + 1
  for (int it = 0; it < items; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // (1) piece it landed; every warp is done with piece it - 1's tiles
    if (it + 1 < items)
      stage_piece<VEC16>(a, live[next_pg], next_pc, col0, ring + ((it + 1) & 1) * lay.bytes);
    cp_async_commit();
    const int nbp = min(a.bpp, c.nb - pc * a.bpp), ps = nbp * c.w;
    const uint8_t* st = ring + (it & 1) * lay.bytes;
    const float* sc = reinterpret_cast<const float*>(st + lay.sc_off);
    const int cols = nbp * hd;
    for (int idx = t; idx < 2 * cols; idx += blockDim.x) {
      const int kv = idx >= cols;
      const int rem = idx - kv * cols;
      const int blk = rem / hd, d = rem - blk * hd;
      const uint8_t* base = st + (size_t)kv * lay.rows_kv * hd;
      const int ds = kv ? hd : KS;
      float* dst = (kv ? Vt : Kt) + (blk * c.w) * ds + d;
      if (MODE == kMaskfree) {
        decode_lo(base + blk * c.lo_rows * hd + d, hd, c, lut, sc[kv * hd + d], dst, ds);
      } else {
        const uint8_t* hbase = base + a.bpp * c.mask_rows * hd;
        const uint8_t* lbase = hbase + a.bpp * c.hi_rows * hd;
        decode_ranked(base + blk * c.mask_rows * hd + d,
                      reinterpret_cast<const int8_t*>(hbase + blk * c.hi_rows * hd + d),
                      lbase + blk * c.lo_rows * hd + d, hd, c, lut, sc[kv * hd + d], dst,
                      ds);
      }
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
    pc = next_pc;
    if (++next_pc == npc) {
      next_pc = 0;
      ++next_pg;
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

template <int MODE, int RT, int CPL, bool VEC16>
cudaError_t launch_split_kernel(const SplitArgs& a, int splits, cudaStream_t stream) {
  const int hd = a.hd, pmax = a.bpp * a.c.w;
  const StageLayout lay(a.c, a.bpp, hd);
  const size_t main_bytes = 2 * (size_t)lay.bytes +
                            sizeof(float) * ((size_t)pmax * (hd + 8) + (size_t)pmax * hd +
                                             (size_t)RT * hd);
  const size_t merge_bytes = sizeof(float) * kPosGroups * (size_t)RT * (hd + 2);
  const size_t smem = main_bytes > merge_bytes ? main_bytes : merge_bytes;
  auto kernel = paged_attention_split_kernel<MODE, RT, CPL, VEC16>;
  // always raise the dynamic limit to this launch's need (the kernel has
  // static shared memory beside it)
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(splits, a.KV * a.tiles, a.B);
  kernel<<<grid, kSplitThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int MODE, int RT, int CPL>
cudaError_t launch_split_typed(const SplitArgs& a, int splits, cudaStream_t s) {
  return a.vec16 ? launch_split_kernel<MODE, RT, CPL, true>(a, splits, s)
                 : launch_split_kernel<MODE, RT, CPL, false>(a, splits, s);
}

template <int MODE, int RT>
cudaError_t launch_split_rows(const SplitArgs& a, int splits, cudaStream_t s) {
  if (a.hd <= 64) return launch_split_typed<MODE, RT, 2>(a, splits, s);
  if (a.hd <= 128) return launch_split_typed<MODE, RT, 4>(a, splits, s);
  return launch_split_typed<MODE, RT, 8>(a, splits, s);
}

// Check the contract, fill the rest of `a` and launch MODE's kernel: S =
// ceil(P / pps) split partials into a.acc / a.m / a.l.  `fields`: every
// pointer the kernel reads pool bytes or scales from.
template <int MODE>
int launch_split(SplitArgs& a, const void* const* fields, int n_fields,
                 cudaStream_t s) {
  const Codec& c = a.c;
  if (a.B <= 0 || a.KV <= 0 || a.R <= 0 || a.P <= 0 || c.nb <= 0 || a.pps <= 0 ||
      a.pps > kMaxSplitPages || c.w <= 0 || c.w > kMaxPageSize || a.hd <= 0 ||
      a.hd > kMaxHeadDim || c.lo_rows <= 0 ||
      (c.method != kSparsity && (c.q < 1 || c.q > 8)))
    return (int)cudaErrorInvalidValue;
  if (MODE == kGeneral && (c.w % 8 != 0 || c.mask_rows != c.w / 8 || c.hi_rows <= 0))
    return (int)cudaErrorInvalidValue;
  if (MODE == kMaskfree &&
      (c.method == kSparsity || c.n_low != c.w || c.lo_rows * 8 < c.w * c.q))
    return (int)cudaErrorInvalidValue;
  uintptr_t any = 0;  // 16-byte staging: whole 16-byte row slices, aligned fields
  for (int i = 0; i < n_fields; ++i) any |= reinterpret_cast<uintptr_t>(fields[i]);
  a.vec16 = a.hd % 16 == 0 && any % 16 == 0;
  a.bpp = c.nb < kMaxPageSize / c.w ? c.nb : kMaxPageSize / c.w;
  const int splits = (a.P + a.pps - 1) / a.pps;
  // row tile: 1 at decode, else 8 or 16 (8 where a lane holds 8 columns)
  const int rt = a.R == 1 ? 1 : (a.R <= 8 || a.hd > 128) ? 8 : 16;
  a.tiles = (a.R + rt - 1) / rt;
  if ((long long)a.KV * a.tiles > 65535 || a.B > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t e = rt == 1   ? launch_split_rows<MODE, 1>(a, splits, s)
                  : rt == 8 ? launch_split_rows<MODE, 8>(a, splits, s)
                            : launch_split_typed<MODE, 16, 4>(a, splits, s);
  return (int)e;
}

void set_common(SplitArgs& a, const void* q, const void* page_ids, const void* n_valid,
                void* pacc, void* pm, void* pl, int B, int KV, int R, int hd, int P,
                int n_pages, int pps) {
  a.q = static_cast<const float*>(q);
  a.page_ids = static_cast<const int*>(page_ids);
  a.n_valid = static_cast<const int*>(n_valid);
  a.acc = static_cast<float*>(pacc);
  a.m = static_cast<float*>(pm);
  a.l = static_cast<float*>(pl);
  a.B = B; a.KV = KV; a.R = R; a.hd = hd; a.P = P; a.n_pages = n_pages; a.pps = pps;
}

}  // namespace

// K11: P packed pages -> out (P, nb w, F) f32.  The register path where a
// block column fits it (w <= 64, n_high <= 16, lo_n <= 8), else the staged
// path: every codec with w % 8 == 0 runs.  VEC = 4 channels a thread where
// F % 4 == 0 and the fields (4 bytes), scale and out (16 bytes) are aligned,
// else the same code at VEC = 1.
extern "C" int strum_page_decode_launch(const void* mask, const void* hi, const void* lo,
                                        const void* scale, void* out, int P, int nb, int w,
                                        int F, int mask_rows, int hi_rows, int lo_rows,
                                        int n_low, int q, int method, void* stream) {
  const bool lo_on = method != kSparsity && n_low > 0;
  const int n_high = w - n_low, lo_n = lo_on ? (n_low * q + 7) / 8 : 0;
  if (P <= 0 || nb <= 0 || w <= 0 || w % 8 != 0 || F <= 0 || n_low < 0 || n_high < 0 ||
      (long long)P * nb > 0x7fffffff || (lo_on && (q < 1 || q > 8)) ||
      mask_rows < w / 8 || hi_rows < (n_high > 1 ? n_high : 1) ||
      lo_rows < (lo_n > 1 ? lo_n : 1))
    return (int)cudaErrorInvalidValue;
  Pool pool = {static_cast<const uint8_t*>(mask), static_cast<const int8_t*>(hi),
               static_cast<const uint8_t*>(lo), static_cast<const float*>(scale)};
  const Codec c = make_codec(nb, w, F, mask_rows, hi_rows, lo_rows, n_low, q, method);
  const bool staged = w > 64 || n_high > 16 || lo_n > 8;
  const uintptr_t bytes = reinterpret_cast<uintptr_t>(mask) | reinterpret_cast<uintptr_t>(hi) |
                          reinterpret_cast<uintptr_t>(lo);
  const uintptr_t floats = reinterpret_cast<uintptr_t>(scale) | reinterpret_cast<uintptr_t>(out);
  const bool vec4 = F % 4 == 0 && bytes % 4 == 0 && floats % 16 == 0;
  auto s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  return (int)(vec4 ? launch_page_decode<4>(pool, c, P * nb, staged, n_high, lo_n, o, s)
                    : launch_page_decode<1>(pool, c, P * nb, staged, n_high, lo_n, o, s));
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
  SplitArgs a;
  set_common(a, q, page_ids, n_valid, pacc, pm, pl, B, KV, R, hd, P, n_pages, pps);
  a.k = {static_cast<const uint8_t*>(k_mask), static_cast<const int8_t*>(k_hi),
         static_cast<const uint8_t*>(k_lo), static_cast<const float*>(k_scale)};
  a.v = {static_cast<const uint8_t*>(v_mask), static_cast<const int8_t*>(v_hi),
         static_cast<const uint8_t*>(v_lo), static_cast<const float*>(v_scale)};
  a.c = make_codec(nb, w, KV * hd, mask_rows, hi_rows, lo_rows, n_low, q_bits, method);
  const void* fields[] = {k_mask, k_hi, k_lo, k_scale, v_mask, v_hi, v_lo, v_scale};
  return launch_split<kGeneral>(a, fields, 8, static_cast<cudaStream_t>(stream));
}

// K5 (p = 1 pages: lo + scale, no mask or hi): the same partials as K4.
extern "C" int strum_paged_attention_maskfree_split_launch(
    const void* q, const void* k_lo, const void* k_scale, const void* v_lo,
    const void* v_scale, const void* page_ids, const void* n_valid, void* pacc, void* pm,
    void* pl, int B, int KV, int R, int hd, int P, int n_pages, int pps, int nb, int w,
    int lo_rows, int q_bits, int method, void* stream) {
  SplitArgs a;
  set_common(a, q, page_ids, n_valid, pacc, pm, pl, B, KV, R, hd, P, n_pages, pps);
  a.k = {nullptr, nullptr, static_cast<const uint8_t*>(k_lo),
         static_cast<const float*>(k_scale)};
  a.v = {nullptr, nullptr, static_cast<const uint8_t*>(v_lo),
         static_cast<const float*>(v_scale)};
  a.c = make_codec(nb, w, KV * hd, 0, 0, lo_rows, w, q_bits, method);
  const void* fields[] = {k_lo, k_scale, v_lo, v_scale};
  return launch_split<kMaskfree>(a, fields, 4, static_cast<cudaStream_t>(stream));
}

// K4's and K5's merge of S > 1 split partials into acc (B, KV, R, hd), m, l
// (B, KV, R).
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
