// StruM-packed KV pages on Hopper (sm_90a): page decode and the sealed-page
// partial of paged attention.
//
// Replaces the TPU kernels
//   K11 strum_page_decode_launch                  <- strum_page_decode_pallas
//                                                    (src/repro/kernels/strum_decode.py)
//   K4  strum_paged_attention_launch(mode 0)      <- strum_paged_attention_pallas
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
// K4 / K5 design (a simple version, not yet fast): one block per (slot, kv
// head, tile of up to kMaxRows query rows).  The block reads its slot's page
// ids itself and walks the pages in order, skipping ids < 0, pages at or
// after n_valid and ids past the pool (the TPU grid's page axis becomes this
// loop).  For each live page it (1) copies its head's packed bytes of K and
// V (columns [g*hd, (g+1)*hd) of every row) and their scales into shared
// memory with independent 4-byte loads, so one memory latency covers the
// page; (2) decodes the (page_size, hd) K and V tiles there, one thread per
// block column; (3) computes the scores against the pre-scaled queries,
// up to a warp of threads per (row, position) as the block has threads to
// spare (16 at R = 1, 1 at R = 16); (4)-(5) carries the online softmax (m, l, acc)
// in f32 shared memory.  Outputs are written once per block: no atomics, so
// the result does not depend on block order.  A slot with nothing live
// returns m = -1e30, l = 0, acc = 0.  The pages of a slot are still walked
// one after another by one block (64 blocks for OLMo-1B at batch 4);
// split-KV across blocks, prefetching the next page, tensor cores and TMA
// are for later versions.
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

// mode 0 = K4 (mask + hi + lo), mode 1 = K5 (p = 1: lo only; mask/hi unused).
extern "C" int strum_paged_attention_launch(
    int mode, const void* q, const void* k_mask, const void* k_hi, const void* k_lo,
    const void* k_scale, const void* v_mask, const void* v_hi, const void* v_lo,
    const void* v_scale, const void* page_ids, const void* n_valid, void* acc, void* m,
    void* l, int B, int KV, int R, int hd, int P, int n_pages, int nb, int w,
    int mask_rows, int hi_rows, int lo_rows, int n_low, int q_bits, int method,
    void* stream) {
  if (B <= 0 || KV <= 0 || R <= 0 || hd <= 0 || P <= 0 || nb <= 0 || w <= 0)
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
  const cudaError_t e = mode == kMaskfree ? launch_attention<kMaskfree>(a, B, s)
                                          : launch_attention<kGeneral>(a, B, s);
  return (int)e;
}
