// StruM packed-weight matmul kernels for Hopper (sm_90a): y = x @ dequant(W).
//
// Replaces the TPU kernels of src/repro/kernels/strum_matmul.py:
//   K1 strum_onehot_launch    <- strum_matmul_pallas           (mask + hi + lo)
//   K2 strum_maskfree_launch  <- strum_matmul_pallas_maskfree  (p = 1: lo only)
//   K3 strum_dense_launch     <- strum_matmul_pallas_dense     (n_low = 0: hi only)
//   K6 strum_grouped_onehot_launch   <- strum_matmul_pallas_grouped
//   K7 strum_grouped_maskfree_launch <- strum_matmul_pallas_grouped_maskfree
//   K8 strum_grouped_dense_launch    <- strum_matmul_pallas_grouped_dense
//   K9 strum_histream_launch   <- strum_matmul_pallas_histream  (draft: mask + hi)
//   K10 strum_maskfree_p_launch <- strum_matmul_pallas_maskfree_p (draft: hi only)
//
// Packed layout (one [1, w] block per column, N contiguous in every field):
//   mask  (nb, w/8, N)            uint8, LSB-first, 1 = high
//   hi    (nb, hi_rows, N)        int8, the n_high high values in position order
//   lo    (nb, lo_rows, N)        uint8, n_low q-bit fields, LSB-first along the
//                                 block axis; a field may straddle two bytes
//   scale (N,)                    f32 per-column scale
// K6-K8 take a stack of G such weights (MoE expert stacks): y[g] = x[g] @
// dequant(W[g]), x (G, M, K), every packed field (G, nb, rows, N), scale
// (G, N), y (G, M, N), all contiguous; the group is the grid's z axis.
//
// What bounds them: at decode (M = batch, a few rows) each reads every packed
// byte once and does ~2 flops per weight, so it is bound by HBM bytes; the
// point of StruM is that those bytes are 14/16 of int8 (mip2q, w = 16, p = .5).
// At prefill (M = 128) the card's bound is the bf16 tensor-core rate (decoded
// values are exact in bf16 and the scale comes after the sum).  What set the
// time of the first designs here was the decode work per weight, not bytes.
//
// The first template (strum_matmul_kernel; a first version that is right,
// not fast), kept only for the widths the streamed kernel below cannot take:
// K1, K2, K9 and K10 at w > 64 or w % 8 != 0, K3 and K8 there too unless
// the 16-wide view (below) applies.  A block owns a BM x 64 output tile and
// a contiguous range of w-blocks along K.  For each
// K chunk it (1) decodes the chunk's weights into shared memory as f32, one
// thread per (w-block, column): a high position takes the next hi byte and
// a low one the next q-bit field, so a position's rank inside its set is
// the running count of set (clear) mask bits before it, with no one-hot
// contraction; (2) stages the x rows as f32 (any K past the true reduction
// dim reads as 0: padded-K weight rows decode to junk, e.g. MIP2Q code 0 is
// +1, and only zero activations null them); (3) each thread accumulates
// BM/4 rows of one column in f32; the per-column scale is applied once in
// the epilogue.  At decode the output tiles alone cannot fill the card (N =
// 2048 gives 32 tiles on 132 SMs), so a 2-D weight is split along K over
// blockIdx.z, at most 8 slices; the slices of one tile are one thread-block
// cluster, each leaves its partial tile in its shared memory, and rank r
// sums every S-th element of the tile over the S partials in rank order
// through distributed shared memory and writes it.  No atomics and no
// scratch: two calls on the same inputs give the same bits.  A tile takes
// at most 8 slices (a portable cluster size).  K8's stacks fill the card
// with their own tiles and are never split.  K10 (maskfree_p, a draft
// lowering of self-speculative decoding) reads neither mask nor lo:
// position i < n_high of a block takes hi[i], the rest are 0.  Wrappers
// pass a null pointer for every field a kernel does not stream, so a stray
// read faults instead of going unnoticed.
//
// K1, K2, K3, K8, K9 and K10 (one kernel, stream_kernel; MODE picks the
// fields; w <= 64, w % 8 == 0).  K9 (histream, the other draft lowering) is
// K1 without the lo stream: a high position takes its hi byte, a low one is
// 0, and lo is never read.  K2 (p = 1) streams lo alone: position i takes
// lo field i.  K10 streams hi alone: position i < n_high takes hi byte i,
// the rest are 0.  K3 and K8 (kDense, n_low = 0) stream hi alone, and
// position i takes hi byte i: int8 weights, the family's most bytes (67.8
// MB an OLMo-1B layer, 566.6 MB a Moonshot-16B-A3B MoE layer), so bytes
// bound them at decode and the bf16 tensor-core rate at M = 128.  The first
// template spent dependent 1-byte loads and f32 FMAs on them (4.0x and 3.3x
// the one-call yardsticks, PERF.md).  Because hi (nb, w, N) is (nb w, N)
// contiguous int8, the launcher hands any payload with nb w % 16 == 0 to
// the byte path as nb w / 16 blocks of 16 (x's true K still nulls the
// padded rows); other widths with w <= 64, w % 8 == 0 take the general
// path.  K8 is the same mode with GROUPED set: blockIdx.z is the group, whose
// w-blocks are [g nb, g nb + nb) of the stacked field (one group base, so
// the read-only argument block needs no per-group copy), no split and no
// cluster (a Moonshot stack is 704-1024 blocks), and it reads the live-row
// counts as K6 does: a row tile past rows[g] writes zeros and returns
// before it stages anything.
// The template spent ~300 issued instructions a weight on K1 (0.60 ms an
// OLMo-1B layer at decode against a 17.7 us byte bound, which leaves ~9 at
// the card's issue rate): 1-byte dependent global loads and nothing in
// flight.  What bounds this kernel at decode is issued instructions, not
// bytes: ~11 a weight in the decode (PERF.md has the measurements).
//   Tile: 128 output columns (every field row a block reads is one full
// 128-byte line) x BM rows -- 16 (the mma's height) for M <= 16 or f32 x,
// with 512 threads and K chunks of 128; 128 past 16 rows of bf16 x, with
// 256 threads and chunks of 64 -- over one K slice: split-K over a
// cluster as above, and the launcher lowers the split until the card holds
// every cluster of the launch at once (it holds 15 clusters of 8 at one
// block an SM, not 16: a second wave doubled the time).
//   Bytes in flight: each chunk's packed rows and x rows come in by 16-byte
// cp.async.cg into a six-slot ring, four chunks (~58 KB at BM = 16) ahead
// of the one decoding; each thread's copies are planned once per block.
// Unaligned fields or x (odd N, K % 8 != 0) take plain loads into the ring.
//   Decode: the common codec (w = 16, 8 high, 4-bit lo codes whose values
// fit int8: dliq q = 4, mip2q L <= 6; for K9 and K10 any w = 16, p = 0.5
// payload; for K2 w = 16 with those 4-bit codes; for K3 and K8 w = 16 at
// n_low = 0, which the 16-wide view makes of most widths) takes the byte path: two
// threads share a w-block of four adjacent columns (one shared-memory word
// a staged row), a column's fields are byte-gathered by prmt, lo codes
// become int8 values through a 16-byte code table in registers, and (K1,
// K9) for each group of 4 positions one prmt takes the hi bytes from the
// running high rank, one the lo values from the running low rank, and one
// with a selector from a 16-entry table indexed by the mask nibble places
// all four; K2's codes are in position order (dliq q = 4's are their
// values' top nibbles: a shift, no table) and K10's hi bytes are its
// leading 8 positions, so neither places anything; K3 / K8's 16 hi bytes
// are positions 0-15: four gathers, four conversions, no table, no
// placement (~3 instructions a weight).  K10's trailing 8
// positions are 0, so its byte path stages and multiplies only the leading
// 8 of each w-block, x and weights alike: half the tile and half the
// product of zero-filling the rest (PERF.md has both designs' times).
// int8 -> bf16 is exact by two magic-number lanes and one bf16x2 fma.  The
// tables come from the Python launcher (byte_path_tables).  Every other
// codec walks each column's positions.
//   Product: decoded bf16 go to one of two [128][K chunk] tiles whose
// 16-byte chunks are XOR-swizzled (no bank conflicts for the decode's
// 16-byte stores or the product's ldmatrix rows); one barrier a chunk:
// while chunk c decodes, chunk c - 1 multiplies on tensor cores (ldmatrix
// fragments, mma.sync m16n8k16, bf16 x bf16 -> f32; at BM = 16 the warps
// split the chunk's k16 steps and their partial tiles are added in a fixed
// order), f32 x on the CUDA cores against the same exact tile; the
// per-column scale is applied in the epilogue.  No atomics: two calls give
// the same bits.
//
// K6 and K7 (one kernel, grouped_live_kernel; MODE picks the fields): the
// template above decoded one bit field at a time into f32 shared memory with
// nothing in flight, and its decode work set the time (2.93 ms for one
// Moonshot MoE layer on an H100 SXM at 700 W, 20x the byte bound).  Both
// take an optional per-group live-row count `rows` (rows at or past rows[g]
// of x[g] are zero): a row tile at or past the count reads no weight byte
// and writes exact zeros (a group with rows[g] == 0 reads nothing), and rows
// past the count inside a computed tile are written as 0 too.  Block = 64
// output columns x BM rows (16, 32 or 64) of one group, 256 threads.  The
// packed bytes of each K chunk (64 K positions: K6's mask, hi and lo rows,
// K7's lo rows, of 64 columns) come in by 16-byte cp.async.cg into a
// three-stage ring, two chunks ahead of the one being decoded, and the
// chunk's x rows one chunk ahead into registers.  Decode, one thread per
// (w-block, column): K6 holds the block's mask, hi and lo bytes in four
// registers, a position's rank among the high (low) set is the popcount of
// the lower mask bits, a hi value is a byte permute, a lo code decodes
// through a table in shared memory, and the two candidates are selected,
// not branched on; K7 loads the block's lo bytes as one 64-bit word and
// position i is the table's entry for bits [q i, q i + q).  bf16 integers
// (|v| <= 128, exact) go out as 16-byte stores into one of two column-major
// tiles.  One barrier per chunk: while chunk c decodes into one tile, the
// product of chunk c - 1 runs on the other.  bf16 x runs on tensor cores
// (mma.sync m16n8k16, bf16 x bf16 -> f32, rows padded to 16 with zeros);
// f32 x keeps f32 FMAs on the CUDA cores against the same exact tile.  The
// per-column scale is applied to the f32 sums in the epilogue.  No split-K,
// no atomics: the same result on every run.  Fields must be 16-byte aligned
// with N % 16 == 0 for the asynchronous copies; other shapes (tests' odd N)
// are staged with plain byte loads into the same ring.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cooperative_groups.h>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;                       // output columns per block
constexpr int kRowGroups = kThreads / kBN;    // threads sharing one column
constexpr int kTargetKC = 64;                 // K elements staged per chunk
constexpr int kMaxSplits = 8;   // K slices of one tile: a portable cluster size

enum Mode { kOnehot = 0, kMaskfree = 1, kDense = 2, kHistream = 3, kMaskfreeP = 4 };
enum Method { kSparsity = 0, kDliq = 1, kMip2q = 2 };

struct Args {
  const void* x;
  const uint8_t* mask;
  const int8_t* hi;
  const uint8_t* lo;
  const float* scale;
  float* out;
  int M, N, K, ldx;
  int nb, w, mask_rows, hi_rows, lo_rows, n_high, n_low, q, method;
  int nbk;               // w-blocks per K chunk
  int blocks_per_split;  // w-blocks per gridDim.z slice (2-D kernels)
  // per-group element strides of x, mask, hi, lo, scale and out (grouped)
  long long gx, gmask, ghi, glo, gscale, gout;
};

__device__ __forceinline__ void cp_async_commit_g() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait_g() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// q-bit field j of one column's lo bytes (col points at lo[b, 0, n]).
__device__ __forceinline__ int lo_field(const uint8_t* col, int rows, int N,
                                        int j, int q) {
  const int bit = j * q;
  const int byte = bit >> 3;
  const int sh = bit & 7;
  unsigned v = col[(size_t)byte * N];
  if (sh + q > 8 && byte + 1 < rows) v |= (unsigned)col[(size_t)(byte + 1) * N] << 8;
  return (int)((v >> sh) & ((1u << q) - 1u));
}

// q-bit code -> value on the int8 grid: DLIQ sign-extends then shifts left by
// 8 - q, MIP2Q is [sign | k] -> +-2^k, sparsity stores nothing (0).
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

// Decode block b of column n into dst[pos * kBN], pos in [0, w).
template <int MODE>
__device__ __forceinline__ void decode_block(const Args& a, int b, int n, float* dst) {
  if (MODE == kDense) {  // K3 reads hi only
    const int8_t* hcol = a.hi + (size_t)b * a.hi_rows * a.N + n;
    for (int pos = 0; pos < a.w; ++pos) dst[pos * kBN] = (float)hcol[(size_t)pos * a.N];
  } else if (MODE == kMaskfreeP) {  // K10 reads hi only: leading n_high positions
    const int8_t* hcol = a.hi + (size_t)b * a.hi_rows * a.N + n;
    for (int pos = 0; pos < a.w; ++pos)
      dst[pos * kBN] = pos < a.n_high ? (float)hcol[(size_t)pos * a.N] : 0.f;
  } else if (MODE == kHistream) {  // K9 reads mask + hi; low positions are 0
    const int8_t* hcol = a.hi + (size_t)b * a.hi_rows * a.N + n;
    const uint8_t* mcol = a.mask + (size_t)b * a.mask_rows * a.N + n;
    int hc = 0;  // rank among the high positions seen so far
    for (int byte = 0; byte < a.mask_rows; ++byte) {
      const unsigned bits = mcol[(size_t)byte * a.N];
      for (int j = 0; j < 8; ++j) {
        const int pos = byte * 8 + j;
        if (pos >= a.w) break;
        float v = 0.f;
        if ((bits >> j) & 1u) {
          if (hc < a.n_high) v = (float)hcol[(size_t)hc * a.N];
          ++hc;
        }
        dst[pos * kBN] = v;
      }
    }
  } else if (MODE == kMaskfree) {  // K2 reads lo only
    const uint8_t* lcol = a.lo + (size_t)b * a.lo_rows * a.N + n;
    for (int pos = 0; pos < a.w; ++pos)
      dst[pos * kBN] = decode_low(lo_field(lcol, a.lo_rows, a.N, pos, a.q), a.method, a.q);
  } else {
    const uint8_t* lcol = a.lo + (size_t)b * a.lo_rows * a.N + n;
    const int8_t* hcol = a.hi + (size_t)b * a.hi_rows * a.N + n;
    const uint8_t* mcol = a.mask + (size_t)b * a.mask_rows * a.N + n;
    int hc = 0, lc = 0;  // ranks among the high / low positions seen so far
    for (int byte = 0; byte < a.mask_rows; ++byte) {
      const unsigned bits = mcol[(size_t)byte * a.N];
      for (int j = 0; j < 8; ++j) {
        const int pos = byte * 8 + j;
        if (pos >= a.w) break;
        float v = 0.f;
        if ((bits >> j) & 1u) {
          if (hc < a.n_high) v = (float)hcol[(size_t)hc * a.N];
          ++hc;
        } else {
          if (a.method != kSparsity && lc < a.n_low)
            v = decode_low(lo_field(lcol, a.lo_rows, a.N, lc, a.q), a.method, a.q);
          ++lc;
        }
        dst[pos * kBN] = v;
      }
    }
  }
}

// GROUPED: blockIdx.z is the group, K is not split; otherwise blockIdx.z is
// the K slice of one 2-D weight.
template <int MODE, int BM, typename T, bool GROUPED>
__global__ void __launch_bounds__(kThreads) strum_matmul_kernel(Args a) {
  constexpr int kRows = BM / kRowGroups;  // rows per thread
  extern __shared__ float smem[];
  const int KC = a.nbk * a.w;
  float* Ws = smem;             // [KC][kBN] decoded weights (unscaled)
  float* Xs = smem + KC * kBN;  // [BM][KC] activations as f32
  const T* x = static_cast<const T*>(a.x);
  if (GROUPED) {
    const long long g = blockIdx.z;
    x += g * a.gx;
    a.mask += g * a.gmask;
    a.hi += g * a.ghi;
    a.lo += g * a.glo;
    a.scale += g * a.gscale;
    a.out += g * a.gout;
  }

  const int t = threadIdx.x;
  const int c = t % kBN;
  const int rg = t / kBN;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int b_begin = GROUPED ? 0 : blockIdx.z * a.blocks_per_split;
  const int b_end = min(a.nb, b_begin + a.blocks_per_split);

  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;

  for (int b0 = b_begin; b0 < b_end; b0 += a.nbk) {
    for (int idx = t; idx < a.nbk * kBN; idx += kThreads) {
      const int kb = idx / kBN, cc = idx % kBN;
      const int b = b0 + kb, n = n0 + cc;
      float* dst = Ws + (kb * a.w) * kBN + cc;
      if (b < b_end && n < a.N) {
        decode_block<MODE>(a, b, n, dst);
      } else {
        for (int pos = 0; pos < a.w; ++pos) dst[pos * kBN] = 0.f;
      }
    }
    const int kbase = b0 * a.w;
    for (int idx = t; idx < BM * KC; idx += kThreads) {
      const int r = idx / KC, kk = idx % KC;
      const int m = m0 + r, k = kbase + kk;
      Xs[idx] = (m < a.M && k < a.K) ? to_f32(x[(size_t)m * a.ldx + k]) : 0.f;
    }
    __syncthreads();
    const int kc_valid = min(KC, (b_end - b0) * a.w);
    for (int kk = 0; kk < kc_valid; ++kk) {
      const float wv = Ws[kk * kBN + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] += Xs[(rg + kRowGroups * i) * KC + kk] * wv;
    }
    __syncthreads();
  }

  if (!GROUPED && gridDim.z > 1) {
    // split-K: the gridDim.z K slices of this tile are one thread-block
    // cluster (cluster rank == blockIdx.z).  Each slice leaves its partial
    // tile in its own shared memory (free after the loop's last barrier);
    // then rank r sums the tile's elements r, r + S, r + 2S, ... over the S
    // partials in rank order through distributed shared memory and writes
    // them, so every run adds in the same order and the cluster shares the
    // reduction.
    float* part = smem;  // [BM][kBN]
#pragma unroll
    for (int i = 0; i < kRows; ++i) part[(rg + kRowGroups * i) * kBN + c] = acc[i];
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int S = gridDim.z;
    for (int e = blockIdx.z + S * t; e < BM * kBN; e += S * kThreads) {
      float sum = *cluster.map_shared_rank(part + e, 0);
      for (int r = 1; r < S; ++r) sum += *cluster.map_shared_rank(part + e, r);
      const int m = m0 + e / kBN, n = n0 + e % kBN;
      if (m < a.M && n < a.N) a.out[(size_t)m * a.N + n] = sum * a.scale[n];
    }
    cluster.sync();  // every slice's shared memory stays alive until all are read
    return;
  }
  const int n = n0 + c;
  if (n >= a.N) return;
  const float s = a.scale[n];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int m = m0 + rg + kRowGroups * i;
    if (m < a.M) a.out[(size_t)m * a.N + n] = acc[i] * s;
  }
}

template <int MODE, int BM, typename T, bool GROUPED>
cudaError_t launch_typed(const Args& a, int grid_z, cudaStream_t stream) {
  const int KC = a.nbk * a.w;
  const size_t smem = sizeof(float) * (size_t)KC * (kBN + BM);
  auto kernel = strum_matmul_kernel<MODE, BM, T, GROUPED>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((a.N + kBN - 1) / kBN, (a.M + BM - 1) / BM, grid_z);
  if (GROUPED || grid_z == 1) {
    kernel<<<grid, kThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  // split-K: the K slices of one output tile form a (1, 1, grid_z) cluster,
  // placed by the load-balancing policy (under the default placement
  // clusters of 3 slices ran measurably slower than the atomics did)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid_z;
  attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attr[1].val.clusterSchedulingPolicyPreference = cudaClusterSchedulingPolicyLoadBalancing;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int MODE, bool GROUPED>
cudaError_t launch_rows(const Args& a, int x_bf16, int grid_z, cudaStream_t s) {
  if (a.M <= 8) {
    return x_bf16 ? launch_typed<MODE, 8, __nv_bfloat16, GROUPED>(a, grid_z, s)
                  : launch_typed<MODE, 8, float, GROUPED>(a, grid_z, s);
  }
  return x_bf16 ? launch_typed<MODE, 64, __nv_bfloat16, GROUPED>(a, grid_z, s)
                : launch_typed<MODE, 64, float, GROUPED>(a, grid_z, s);
}

// groups = 0: one 2-D weight split in `splits` K slices; groups >= 1: a
// stack of `groups` weights, K not split.
template <int MODE>
int launch(const void* x, int x_bf16, const void* mask, const void* hi,
           const void* lo, const void* scale, void* out, int groups, int M, int N,
           int K, int ldx, int nb, int w, int mask_rows, int hi_rows, int lo_rows,
           int n_low, int q, int method, int splits, void* stream) {
  if (groups < 0 || groups > 65535 || M <= 0 || N <= 0 || nb <= 0 || w <= 0 ||
      splits <= 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.mask = static_cast<const uint8_t*>(mask);
  a.hi = static_cast<const int8_t*>(hi);
  a.lo = static_cast<const uint8_t*>(lo);
  a.scale = static_cast<const float*>(scale);
  a.out = static_cast<float*>(out);
  a.M = M; a.N = N; a.K = K; a.ldx = ldx;
  a.nb = nb; a.w = w; a.mask_rows = mask_rows; a.hi_rows = hi_rows; a.lo_rows = lo_rows;
  a.n_high = w - n_low; a.n_low = n_low; a.q = q; a.method = method;
  a.nbk = w >= kTargetKC ? 1 : kTargetKC / w;
  if (!groups && splits > kMaxSplits) return (int)cudaErrorInvalidValue;
  a.blocks_per_split = (nb + splits - 1) / splits;
  splits = (nb + a.blocks_per_split - 1) / a.blocks_per_split;  // no empty slice
  // contiguous (G, ...) stacks; a 2-D call never reads these
  a.gx = (long long)M * ldx;
  a.gmask = (long long)nb * mask_rows * N;
  a.ghi = (long long)nb * hi_rows * N;
  a.glo = (long long)nb * lo_rows * N;
  a.gscale = N;
  a.gout = (long long)M * N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(groups ? launch_rows<MODE, true>(a, x_bf16, groups, s)
                      : launch_rows<MODE, false>(a, x_bf16, splits, s));
}


// ---------------------------------------- K6: live-expert grouped matmul --

constexpr int kGThreads = 256;
constexpr int kGBN = 64;       // output columns per block
constexpr int kGRowGroups = kGThreads / kGBN;     // f32 path: threads per column
constexpr int kGNT = kGBN / 8 / (kGThreads / 32);  // mma path: n8 tiles per warp
constexpr int kGStages = 3;    // K chunks in the shared-memory ring (deeper
                               // rings measured no faster for K6 or K7)
constexpr int kGTargetKC = 64; // K positions per chunk

struct GroupedArgs {
  const void* x;        // (G, M, K)
  const uint8_t* mask;  // (G, nb, mask_rows, N)
  const int8_t* hi;     // (G, nb, hi_rows, N)
  const uint8_t* lo;    // (G, nb, lo_rows, N)
  const float* scale;   // (G, N)
  const int* rows;      // (G,) live rows, or null: all M rows live
  float* out;           // (G, M, N)
  int M, N, K, nb, w, mask_rows, hi_rows, lo_rows, n_high, n_low, q, method;
  int nbk, kc, kcp;     // w-blocks per chunk, K per chunk, kc padded to 16
  int vec16;            // 16-byte asynchronous staging allowed
};

__device__ __forceinline__ void g_cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

// Stage chunk `ch`: for each of its w-blocks, the mask, hi and lo rows of
// columns [n0, n0 + 64); blocks past nb and columns past N read as 0.
// Layout: [field rows of block 0][of block 1]..., each row kGBN bytes.
__device__ __forceinline__ void stage_chunk(const GroupedArgs& a, int ch, int n0,
                                            uint8_t* dst) {
  const int per_blk = a.mask_rows + a.hi_rows + a.lo_rows;
  const int nrow = a.nbk * per_blk;
  if (a.vec16) {
    for (int i = threadIdx.x; i < nrow * (kGBN / 16); i += blockDim.x) {
      const int row = i >> 2, vec = i & 3;
      const int kb = row / per_blk;
      int r = row - kb * per_blk;
      const int b = ch * a.nbk + kb, n = n0 + 16 * vec;
      const uint8_t* src = a.mask;
      if (r < a.mask_rows) {
        src = a.mask + ((size_t)b * a.mask_rows + r) * a.N + n;
      } else if ((r -= a.mask_rows) < a.hi_rows) {
        src = reinterpret_cast<const uint8_t*>(a.hi) + ((size_t)b * a.hi_rows + r) * a.N + n;
      } else {
        r -= a.hi_rows;
        src = a.lo + ((size_t)b * a.lo_rows + r) * a.N + n;
      }
      const bool in = b < a.nb && n < a.N;  // N % 16 == 0: whole vectors
      // a zero-fill copy reads no byte; its dummy source is lo, never null
      g_cp_async16(dst + row * kGBN + 16 * vec, in ? src : a.lo, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < nrow * kGBN; i += blockDim.x) {
      const int row = i / kGBN, cc = i % kGBN;
      const int kb = row / per_blk;
      int r = row - kb * per_blk;
      const int b = ch * a.nbk + kb, n = n0 + cc;
      uint8_t v = 0;
      if (b < a.nb && n < a.N) {
        if (r < a.mask_rows) v = a.mask[((size_t)b * a.mask_rows + r) * a.N + n];
        else if ((r -= a.mask_rows) < a.hi_rows)
          v = (uint8_t)a.hi[((size_t)b * a.hi_rows + r) * a.N + n];
        else v = a.lo[((size_t)b * a.lo_rows + r - a.hi_rows) * a.N + n];
      }
      dst[i] = v;
    }
  }
}

// q-bit field j of one staged column's lo bytes (col points at its row 0;
// staged rows are STRIDE bytes apart).
template <int STRIDE = kGBN>
__device__ __forceinline__ int g_lo_field(const uint8_t* col, int rows, int j, int q) {
  const int bit = j * q, byte = bit >> 3, sh = bit & 7;
  unsigned v = col[byte * STRIDE];
  if (sh + q > 8 && byte + 1 < rows) v |= (unsigned)col[(byte + 1) * STRIDE] << 8;
  return (int)((v >> sh) & ((1u << q) - 1u));
}

__device__ __forceinline__ int g_decode_low(int c, int method, int q) {
  if (method == kDliq) {
    const int sb = 1 << (q - 1);
    return ((c ^ sb) - sb) * (1 << (8 - q));
  }
  if (method == kMip2q) {
    const int s = 1 - 2 * (c >> (q - 1));
    return s * (1 << (c & ((1 << (q - 1)) - 1)));
  }
  return 0;
}

// One position of a [1, w] block held in registers: m the mask bits, h0/h1
// the hi bytes (rank order), l the lo fields, lut the decoded lo codes.  A
// position's rank among the high (low) set is the popcount of the set
// (clear) mask bits below it; both candidates are formed and one selected.
// Valid payloads have n_high set bits a block; a padded block (all clear)
// reads lo field min(rank, lmax), whose activations are zero.
__device__ __forceinline__ float reg_value(uint32_t m, uint32_t h0, uint32_t h1, uint32_t l,
                                           const float* lut, int pos, int lmax, int q,
                                           uint32_t qmask) {
  const int rh = __popc(m & ((1u << pos) - 1u));
  const int rl = pos - rh;
  const float hv = (float)(int8_t)__byte_perm(h0, h1, (unsigned)(rh & 7));
  const float lv = lut[(l >> (min(rl, lmax) * q)) & qmask];
  return (m >> pos) & 1u ? hv : lv;
}

// K7: decode a staged p = 1 chunk (each block's w q-bit lo fields in
// position order) into Wt[n][k], as decode_chunk below.  Up to 8 lo rows (w q
// <= 64 bits) the block's bytes are one 64-bit word and position i is
// lut[(word >> q i) & qmask] (constant shifts at w = 16, q = 4), stored as
// 16-byte bf16 vectors where w % 8 == 0; more rows read each field from the
// staged bytes.
__device__ __forceinline__ void decode_chunk_lo(const GroupedArgs& a, const uint8_t* st,
                                                const float* lut, __nv_bfloat16* Wt) {
  const int ws = a.kcp + 8;
  const unsigned long long qmask = (1ull << a.q) - 1ull;
  for (int idx = threadIdx.x; idx < a.nbk * kGBN; idx += blockDim.x) {
    const int kb = idx / kGBN, n = idx % kGBN;
    const uint8_t* lcol = st + kb * a.lo_rows * kGBN + n;
    __nv_bfloat16* dst = Wt + n * ws + kb * a.w;
    if (a.lo_rows <= 8) {
      unsigned long long word = 0;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r >= a.lo_rows) break;
        word |= (unsigned long long)lcol[r * kGBN] << (8 * r);
      }
      if (a.w == 16) {
        uint32_t v8[8];
        if (a.q == 4) {
#pragma unroll
          for (int pos = 0; pos < 16; pos += 2) {
            const __nv_bfloat162 pair = __floats2bfloat162_rn(
                lut[(word >> (4 * pos)) & 0xFull], lut[(word >> (4 * pos + 4)) & 0xFull]);
            v8[pos >> 1] = *reinterpret_cast<const uint32_t*>(&pair);
          }
        } else {
#pragma unroll
          for (int pos = 0; pos < 16; pos += 2) {
            const __nv_bfloat162 pair = __floats2bfloat162_rn(
                lut[(word >> (pos * a.q)) & qmask], lut[(word >> ((pos + 1) * a.q)) & qmask]);
            v8[pos >> 1] = *reinterpret_cast<const uint32_t*>(&pair);
          }
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(v8[0], v8[1], v8[2], v8[3]);
        *reinterpret_cast<uint4*>(dst + 8) = make_uint4(v8[4], v8[5], v8[6], v8[7]);
        continue;
      }
      if (a.w % 8 == 0) {
        for (int p0 = 0; p0 < a.w; p0 += 8) {
          uint32_t v4[4];
#pragma unroll
          for (int j = 0; j < 8; j += 2) {
            const __nv_bfloat162 pair =
                __floats2bfloat162_rn(lut[(word >> ((p0 + j) * a.q)) & qmask],
                                      lut[(word >> ((p0 + j + 1) * a.q)) & qmask]);
            v4[j >> 1] = *reinterpret_cast<const uint32_t*>(&pair);
          }
          *reinterpret_cast<uint4*>(dst + p0) = make_uint4(v4[0], v4[1], v4[2], v4[3]);
        }
        continue;
      }
      for (int pos = 0; pos < a.w; ++pos)
        dst[pos] = __float2bfloat16_rn(lut[(word >> (pos * a.q)) & qmask]);
      continue;
    }
    for (int pos = 0; pos < a.w; ++pos)
      dst[pos] = __float2bfloat16_rn(lut[g_lo_field(lcol, a.lo_rows, pos, a.q)]);
  }
}

// K6: decode a staged chunk into Wt[n][k] (bf16 integers, k contiguous, row
// stride kcp + 8): one thread per (w-block, column).  The common codecs
// (w <= 32, <= 8 hi and <= 4 lo rows: mip2q / dliq p = 0.5) read the
// block's bytes once into registers (fully unrolled at w = 16), and lo codes
// decode through `lut` (2^q values in shared memory); the others read the
// staged bytes per position.
__device__ __forceinline__ void decode_chunk(const GroupedArgs& a, const uint8_t* st,
                                             const float* lut, __nv_bfloat16* Wt) {
  const int per_blk = a.mask_rows + a.hi_rows + a.lo_rows;
  const int ws = a.kcp + 8;
  const int hmax = a.n_high > 0 ? a.n_high - 1 : 0;
  const int lmax = a.method != kSparsity && a.n_low > 0 ? a.n_low - 1 : 0;
  const bool fast = a.w <= 32 && a.hi_rows <= 8 && a.lo_rows <= 4;
  const uint32_t qmask = a.method == kSparsity ? 0u : (1u << a.q) - 1u;
  for (int idx = threadIdx.x; idx < a.nbk * kGBN; idx += blockDim.x) {
    const int kb = idx / kGBN, n = idx % kGBN;
    const uint8_t* mcol = st + kb * per_blk * kGBN + n;
    const int8_t* hcol = reinterpret_cast<const int8_t*>(mcol + a.mask_rows * kGBN);
    const uint8_t* lcol = mcol + (a.mask_rows + a.hi_rows) * kGBN;
    __nv_bfloat16* dst = Wt + n * ws + kb * a.w;
    if (fast) {  // the block's mask, hi and lo bytes in four registers
      uint32_t m = 0, h0 = 0, h1 = 0, l = 0;
      for (int r = 0; r < a.mask_rows; ++r) m |= (uint32_t)mcol[r * kGBN] << (8 * r);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r >= a.hi_rows) break;
        const uint32_t b = (uint8_t)hcol[r * kGBN];
        if (r < 4) h0 |= b << (8 * r);
        else h1 |= b << (8 * (r - 4));
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (r >= a.lo_rows) break;
        l |= (uint32_t)lcol[r * kGBN] << (8 * r);
      }
      if (a.w == 16) {
        uint32_t v8[8];
#pragma unroll
        for (int pos = 0; pos < 16; pos += 2) {
          const __nv_bfloat162 pair = __floats2bfloat162_rn(
              reg_value(m, h0, h1, l, lut, pos, lmax, a.q, qmask),
              reg_value(m, h0, h1, l, lut, pos + 1, lmax, a.q, qmask));
          v8[pos >> 1] = *reinterpret_cast<const uint32_t*>(&pair);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(v8[0], v8[1], v8[2], v8[3]);
        *reinterpret_cast<uint4*>(dst + 8) = make_uint4(v8[4], v8[5], v8[6], v8[7]);
        continue;
      }
      for (int p0 = 0; p0 < a.w; p0 += 8) {
        uint32_t v4[4];
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          const __nv_bfloat162 pair = __floats2bfloat162_rn(
              reg_value(m, h0, h1, l, lut, p0 + j, lmax, a.q, qmask),
              reg_value(m, h0, h1, l, lut, p0 + j + 1, lmax, a.q, qmask));
          v4[j >> 1] = *reinterpret_cast<const uint32_t*>(&pair);
        }
        *reinterpret_cast<uint4*>(dst + p0) = make_uint4(v4[0], v4[1], v4[2], v4[3]);
      }
      continue;
    }
    unsigned long long bits = 0;
    for (int byte = 0; byte < a.mask_rows; ++byte)
      bits |= (unsigned long long)mcol[byte * kGBN] << (8 * byte);
    for (int p0 = 0; p0 < a.w; p0 += 8) {
      uint32_t v8[4] = {0u, 0u, 0u, 0u};  // eight bf16, two a word, low half first
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int pos = p0 + j;
        const int rh = __popcll(bits & ((1ull << pos) - 1ull));
        const int rl = pos - rh;
        const int hv = hcol[min(rh, hmax) * kGBN];
        const int lv = g_decode_low(g_lo_field(lcol, a.lo_rows, min(rl, lmax), a.q),
                                    a.method, a.q);
        const bool high = (bits >> pos) & 1ull;
        const int v = high ? (rh < a.n_high ? hv : 0) : (rl < a.n_low ? lv : 0);
        v8[j >> 1] |= (uint32_t)__bfloat16_as_ushort(__int2bfloat16_rn(v)) << (16 * (j & 1));
      }
      *reinterpret_cast<uint4*>(dst + p0) = make_uint4(v8[0], v8[1], v8[2], v8[3]);
    }
  }
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One chunk's product into the accumulators: bf16 x on tensor cores (each
// warp kGNT n8 tiles of the block's 64 columns, every live m16 tile), f32 x
// as f32 FMAs (kGRowGroups threads per column).
template <int BM, typename T>
__device__ __forceinline__ void chunk_product(const GroupedArgs& a, const __nv_bfloat16* Wt,
                                              const T* Xs, int mrows,
                                              float (&acc)[BM / 16][kGNT][4],
                                              float (&facc)[BM / kGRowGroups]) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int ws = a.kcp + 8;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int xs = a.kcp + 8;
    const int gid = lane >> 2, tig = lane & 3;
    const uint32_t* W32 = reinterpret_cast<const uint32_t*>(Wt);
    const uint32_t* X32 = reinterpret_cast<const uint32_t*>(Xs);
    for (int ks = 0; ks < a.kcp; ks += 16) {
      uint32_t bf[kGNT][2];
#pragma unroll
      for (int j = 0; j < kGNT; ++j) {
        const int nrow = (warp * kGNT + j) * 8 + gid;
        bf[j][0] = W32[(nrow * ws + ks + tig * 2) >> 1];
        bf[j][1] = W32[(nrow * ws + ks + 8 + tig * 2) >> 1];
      }
#pragma unroll
      for (int i = 0; i < BM / 16; ++i) {
        if (i * 16 >= mrows) break;
        const int r = i * 16 + gid;
        uint32_t af[4];
        af[0] = X32[(r * xs + ks + tig * 2) >> 1];
        af[1] = X32[((r + 8) * xs + ks + tig * 2) >> 1];
        af[2] = X32[(r * xs + ks + 8 + tig * 2) >> 1];
        af[3] = X32[((r + 8) * xs + ks + 8 + tig * 2) >> 1];
#pragma unroll
        for (int j = 0; j < kGNT; ++j) mma_bf16(acc[i][j], af, bf[j]);
      }
    }
  } else {
    const int xs = a.kcp + 4;
    const int c = t % kGBN, rg = t / kGBN;
    const __nv_bfloat16* wr = Wt + c * ws;
    for (int kk = 0; kk < a.kc; ++kk) {
      const float wv = __bfloat162float(wr[kk]);
#pragma unroll
      for (int i = 0; i < BM / kGRowGroups; ++i)
        if (rg + kGRowGroups * i < mrows) facc[i] += Xs[(rg + kGRowGroups * i) * xs + kk] * wv;
    }
  }
}

// MODE: kOnehot (K6: mask + hi + lo) or kMaskfree (K7: lo only; mask and hi
// are null with no rows).  Grid (ceil(N / 64), ceil(M / BM), G).  T: x's
// type (bf16: tensor cores; f32: CUDA cores).  One barrier per chunk: while
// chunk ch decodes into one of two weight tiles, the product of chunk ch - 1
// runs on the other, chunks ch + 1 and ch + 2 are in flight in the ring, and
// chunk ch + 1's x rows are in flight into registers.
template <int MODE, int BM, typename T>
__global__ void __launch_bounds__(kGThreads) grouped_live_kernel(GroupedArgs a) {
  constexpr int XPT = BM * kGTargetKC / kGThreads;  // x elements a thread stages
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float lut[256];  // lo code -> value (2^q <= 256 codes)
  const int g = blockIdx.z, n0 = blockIdx.x * kGBN, m0 = blockIdx.y * BM;
  const int t = threadIdx.x;
  const int live = a.rows ? min(max(a.rows[g], 0), a.M) : a.M;
  float* out = a.out + (size_t)g * a.M * a.N;
  if (m0 >= live) {  // nothing live in this row tile: exact zeros, no weight read
    for (int idx = t; idx < BM * kGBN; idx += blockDim.x) {
      const int m = m0 + idx / kGBN, n = n0 + idx % kGBN;
      if (m < a.M && n < a.N) out[(size_t)m * a.N + n] = 0.f;
    }
    return;
  }
  const int mrows = min(BM, live - m0);
  if (MODE != kMaskfree) {
    a.mask += (size_t)g * a.nb * a.mask_rows * a.N;
    a.hi += (size_t)g * a.nb * a.hi_rows * a.N;
  }
  a.lo += (size_t)g * a.nb * a.lo_rows * a.N;
  const float* scale = a.scale + (size_t)g * a.N;
  const T* x = static_cast<const T*>(a.x) + ((size_t)g * a.M + m0) * a.K;

  if (a.method != kSparsity)
    for (int c = t; c < (1 << a.q); c += blockDim.x) lut[c] = (float)g_decode_low(c, a.method, a.q);
  else if (t == 0)
    lut[0] = 0.f;
  const int stage_bytes = ((a.nbk * (a.mask_rows + a.hi_rows + a.lo_rows) * kGBN) + 15) & ~15;
  const int ws = a.kcp + 8;                                 // Wt row stride (bf16)
  const int xs = std::is_same<T, __nv_bfloat16>::value ? a.kcp + 8 : a.kcp + 4;
  uint8_t* ring = smem_raw;
  __nv_bfloat16* Wt = reinterpret_cast<__nv_bfloat16*>(ring + kGStages * stage_bytes);  // [2]
  T* Xs = reinterpret_cast<T*>(Wt + 2 * kGBN * ws);                                     // [2]
  // the pad columns [kc, kcp) are never written: zero them once, in both buffers
  const int pad = a.kcp - a.kc;
  for (int idx = t; idx < 2 * kGBN * pad; idx += blockDim.x)
    Wt[(idx / pad) * ws + a.kc + idx % pad] = __int2bfloat16_rn(0);
  for (int idx = t; idx < 2 * BM * pad; idx += blockDim.x)
    Xs[(idx / pad) * xs + a.kc + idx % pad] = T(0.f);

  const int chunks = (a.nb + a.nbk - 1) / a.nbk;
  T xr[XPT];  // x of the next chunk, in flight in registers
  auto load_x = [&](int ch) {
#pragma unroll
    for (int e = 0; e < XPT; ++e) {
      const int idx = t + e * kGThreads, r = idx / kGTargetKC, kk = idx % kGTargetKC;
      const int k = ch * a.kc + kk;
      xr[e] = (r < mrows && kk < a.kc && k < a.K) ? x[(size_t)r * a.K + k] : T(0.f);
    }
  };
  auto store_x = [&](T* dst) {
#pragma unroll
    for (int e = 0; e < XPT; ++e) {
      const int idx = t + e * kGThreads, r = idx / kGTargetKC, kk = idx % kGTargetKC;
      if (kk < a.kc) dst[r * xs + kk] = xr[e];
    }
  };
#pragma unroll
  for (int c0 = 0; c0 < kGStages - 1; ++c0) {  // chunks 0 .. kGStages - 2 in flight
    if (c0 < chunks) stage_chunk(a, c0, n0, ring + c0 * stage_bytes);
    cp_async_commit_g();
  }
  load_x(0);

  float acc[BM / 16][kGNT][4];   // bf16 path: [m tile][n8 tile][fragment]
  float facc[BM / kGRowGroups];  // f32 path: rows rg + kGRowGroups i of column t % 64
#pragma unroll
  for (int i = 0; i < BM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kGNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
  for (int i = 0; i < BM / kGRowGroups; ++i) facc[i] = 0.f;

  cp_async_wait_g<kGStages - 2>();
  __syncthreads();  // chunk 0 landed, the lookup table is written
  for (int ch = 0; ch < chunks; ++ch) {
    const int cur = ch & 1;
    store_x(Xs + cur * BM * xs);
    if (ch + 1 < chunks) load_x(ch + 1);
    if (MODE == kMaskfree)
      decode_chunk_lo(a, ring + (ch % kGStages) * stage_bytes, lut, Wt + cur * kGBN * ws);
    else
      decode_chunk(a, ring + (ch % kGStages) * stage_bytes, lut, Wt + cur * kGBN * ws);
    if (ch > 0)
      chunk_product<BM, T>(a, Wt + (cur ^ 1) * kGBN * ws, Xs + (cur ^ 1) * BM * xs, mrows,
                           acc, facc);
    // the slot of chunk ch - 1, whose decode the last barrier closed
    const int ahead = ch + kGStages - 1;
    if (ahead < chunks) stage_chunk(a, ahead, n0, ring + (ahead % kGStages) * stage_bytes);
    cp_async_commit_g();
    cp_async_wait_g<kGStages - 2>();
    __syncthreads();  // chunk ch decoded, chunk ch + 1 landed, chunk ch - 1's product done
  }
  chunk_product<BM, T>(a, Wt + ((chunks - 1) & 1) * kGBN * ws,
                       Xs + ((chunks - 1) & 1) * BM * xs, mrows, acc, facc);
  cp_async_wait_g<0>();

  // epilogue: scale per column; rows past the live count are exact zeros
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int warp = t >> 5, lane = t & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int i = 0; i < BM / 16; ++i)
#pragma unroll
      for (int j = 0; j < kGNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = i * 16 + gid + (e >> 1) * 8;
          const int n = n0 + (warp * kGNT + j) * 8 + tig * 2 + (e & 1);
          if (m0 + r < a.M && n < a.N)
            out[(size_t)(m0 + r) * a.N + n] = r < mrows ? acc[i][j][e] * scale[n] : 0.f;
        }
  } else {
    const int c = t % kGBN, rg = t / kGBN, n = n0 + c;
    if (n < a.N) {
      const float s = scale[n];
#pragma unroll
      for (int i = 0; i < BM / kGRowGroups; ++i) {
        const int r = rg + kGRowGroups * i;
        if (m0 + r < a.M) out[(size_t)(m0 + r) * a.N + n] = r < mrows ? facc[i] * s : 0.f;
      }
    }
  }
}

template <int MODE, int BM, typename T>
cudaError_t launch_grouped_typed(const GroupedArgs& a, int G, cudaStream_t stream) {
  const int stage_bytes = ((a.nbk * (a.mask_rows + a.hi_rows + a.lo_rows) * kGBN) + 15) & ~15;
  const int xs = std::is_same<T, __nv_bfloat16>::value ? a.kcp + 8 : a.kcp + 4;
  const size_t smem = (size_t)kGStages * stage_bytes + 2 * 2 * (size_t)kGBN * (a.kcp + 8) +
                      2 * sizeof(T) * (size_t)BM * xs;
  auto kernel = grouped_live_kernel<MODE, BM, T>;
  // always raise the dynamic limit to this launch's need: with the static
  // lookup table a launch near 48 KB is refused under the default limit
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.N + kGBN - 1) / kGBN, (a.M + BM - 1) / BM, G);
  kernel<<<grid, kGThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int MODE, typename T>
cudaError_t launch_grouped_rows(const GroupedArgs& a, int G, cudaStream_t s) {
  if (a.M <= 16) return launch_grouped_typed<MODE, 16, T>(a, G, s);
  if (a.M <= 32) return launch_grouped_typed<MODE, 32, T>(a, G, s);
  return launch_grouped_typed<MODE, 64, T>(a, G, s);
}

// K6 and K7: fill the chunking of `a` and launch MODE's kernel; the caller
// has checked the fields.  `fields`: the packed pointers the kernel stages.
template <int MODE>
int launch_grouped(GroupedArgs& a, int x_bf16, const void* const* fields, int n_fields,
                   int G, cudaStream_t s) {
  a.nbk = a.w >= kGTargetKC ? 1 : kGTargetKC / a.w;
  a.kc = a.nbk * a.w;
  a.kcp = (a.kc + 15) / 16 * 16;
  uintptr_t any = 0;
  for (int i = 0; i < n_fields; ++i) any |= reinterpret_cast<uintptr_t>(fields[i]);
  a.vec16 = a.N % 16 == 0 && any % 16 == 0;
  return (int)(x_bf16 ? launch_grouped_rows<MODE, __nv_bfloat16>(a, G, s)
                      : launch_grouped_rows<MODE, float>(a, G, s));
}

void set_grouped(GroupedArgs& a, const void* x, const void* scale, const void* rows,
                 void* out, int M, int N, int K, int nb, int w, int n_low, int q,
                 int method) {
  a.x = x;
  a.scale = static_cast<const float*>(scale);
  a.rows = static_cast<const int*>(rows);
  a.out = static_cast<float*>(out);
  a.M = M; a.N = N; a.K = K; a.nb = nb; a.w = w;
  a.n_high = w - n_low; a.n_low = n_low; a.q = q; a.method = method;
}


// ------------------ K1, K2, K9 and K10: the streamed packed-field matmul --

constexpr int kSBN = 128;       // output columns per block: each field row read is one 128-byte line
constexpr int kSStages = 6;     // ring slots, each the packed rows and x rows of one K chunk
constexpr int kSAhead = kSStages - 2;  // chunks in flight beyond the one decoding

struct StreamArgs {
  const void* x;        // (M, K), row stride ldx; grouped: (G, M, K), ldx = K
  const uint8_t* mask;  // (nb, mask_rows, N); null in kMaskfree, kMaskfreeP, kDense modes
  const int8_t* hi;     // (nb, hi_rows, N); null in kMaskfree mode
  const uint8_t* lo;    // (nb, lo_rows, N); null in kHistream, kMaskfreeP, kDense modes
  const uint8_t* dummy; // a streamed field: the source of zero-fill copies
  const float* scale;   // (N,); grouped: (G, N)
  const int* live;      // grouped: (G,) live rows of each group, or null (all M)
  float* out;           // (M, N); grouped: (G, M, N)
  int M, N, K, ldx;
  int nb, w, mask_rows, hi_rows, lo_rows, n_high, n_low, q, method;  // rows: 0
                                                                      // if not streamed
  int nbk, kc, kcp;     // w-blocks per chunk, K per chunk, kc padded to 16
  int shift4;           // kMaskfree's byte path: the code table is c -> c << 4 (dliq q = 4)
  int ws, xs;           // row strides (elements) of the weight and x tiles
  int rows, bstride;    // staged field rows a w-block, staged bytes a w-block
  int xoff, slot_bytes; // x tile offset in a ring slot, bytes a slot
  int blocks_per_split;
  int vec_fields, vec_x;  // 16-byte asynchronous staging allowed
  uint32_t sel[16];     // byte path: prmt selector per mask nibble
  uint32_t code[4];     // byte path: lo code -> int8 value, 16 bytes
};

// BM = 16: 512 threads, chunks of 128 positions; the product's 16 warps
// are 4 along N (32 columns each) x 4 along K (two k16 steps each).  BM =
// 128: 256 threads (the accumulators need the registers), chunks of 64,
// warps 2 along M x 4 along N.  (1024 threads at BM = 16 cap a thread at 64
// registers, spill, and measured slower.)
template <int BM>
struct StreamTile {
  static constexpr int TH = BM == 16 ? 512 : 256;      // threads a block
  static constexpr int KC = BM == 16 ? 128 : 64;       // K positions a chunk
  static constexpr int SPLIT = TH / (KC / 16 * 32);    // byte path: threads an item
  static constexpr int WN = 4;                         // warps along N
  static constexpr int WM = BM == 16 ? 1 : 2;          // warps along M
  static constexpr int KH = TH / 32 / (WN * WM);       // warps along K (bf16 x)
  static constexpr int NT = kSBN / 8 / WN;             // n8 tiles a warp
  static constexpr int MT = BM / 16 / WM;              // m16 tiles a warp
  static constexpr int RG = TH / kSBN;                 // f32 path: threads a column
  static constexpr int FR = BM / RG;                   // f32 path: rows a thread
};

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void sts128(uint32_t addr, uint32_t a, uint32_t b, uint32_t c,
                                       uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b),
               "r"(c), "r"(d));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Element offset of (column n, K position k) in a weight tile.  The 16-byte
// chunks of a row are XOR-swizzled by (n ^ n >> 3) & 7 (ws is a multiple of
// 64), so neither the decode's 16-byte stores nor the product's ldmatrix
// rows meet a bank conflict.
__device__ __forceinline__ int wt_off(int n, int k, int ws) {
  return n * ws + (((k >> 3) ^ ((n ^ (n >> 3)) & 7)) << 3) + (k & 7);
}

// What a thread stages into every ring slot: up to kPlan 16-byte vectors
// of packed rows and one of x at fixed slot offsets, each source moving by
// a fixed stride a chunk (what a large chunk has beyond them is staged by
// index arithmetic in stream_stage).
constexpr int kPlan = 2;
struct StagePlan {
  const uint8_t* src[kPlan];  // each vector's source in chunk 0 (field rows)
  long long step[kPlan];      // bytes the source moves a chunk
  int dst[kPlan], kb[kPlan];  // slot offset; w-block within the chunk (-1: none)
  bool nok[kPlan];            // the vector's columns lie below N
  const uint8_t* xsrc;        // the x vector's source in chunk 0
  int xdst, xk;               // slot offset; K offset within a chunk (-1: none)
};

// Staged field row r (mask, then hi, then lo rows; a field the mode does
// not stream has no rows) of w-block b at column n.
__device__ __forceinline__ const uint8_t* field_src(const StreamArgs& a, int b, int r, int n) {
  if (r < a.mask_rows) return a.mask + ((size_t)b * a.mask_rows + r) * a.N + n;
  if ((r -= a.mask_rows) < a.hi_rows)
    return reinterpret_cast<const uint8_t*>(a.hi) + ((size_t)b * a.hi_rows + r) * a.N + n;
  return a.lo + ((size_t)b * a.lo_rows + r - a.hi_rows) * a.N + n;
}

__device__ __forceinline__ long long field_step(const StreamArgs& a, int r) {
  const int rows = r < a.mask_rows ? a.mask_rows
                 : r < a.mask_rows + a.hi_rows ? a.hi_rows : a.lo_rows;
  return (long long)a.nbk * rows * a.N;
}

// K offset within a chunk of the c-th position the x tile holds: every
// position, or (COMPACT: K10's byte path, w = 16) the leading 8 of each
// w-block, whose chunk then spans 2 kc positions of K.
template <bool COMPACT>
__device__ __forceinline__ int kpos(int c) {
  return COMPACT ? c + (c & ~7) : c;
}

// b_begin / b_end: the block's w-blocks, counted over the whole field (a
// grouped launch's group g owns w-blocks [g nb, g nb + nb), so field_src
// needs no group offset); kb0: the w-block at x's K = 0 (g nb, or 0); xr0:
// x's row of the tile's row 0 (g M + m0, or m0).
template <int TH, typename T, bool COMPACT>
__device__ __forceinline__ StagePlan stage_plan(const StreamArgs& a, int b_begin, int kb0,
                                                int n0, int xr0, int mrows) {
  StagePlan p;
  const int t = threadIdx.x;
#pragma unroll
  for (int e = 0; e < kPlan; ++e) {
    const int i = t + e * TH;
    p.kb[e] = -1;
    p.src[e] = a.dummy;
    p.step[e] = 0;
    p.dst[e] = 0;
    p.nok[e] = false;
    if (a.vec_fields && i < a.nbk * a.rows * (kSBN / 16)) {
      const int vec = i & 7, row = i >> 3;
      const int kb = row / a.rows, r0 = row - kb * a.rows, n = n0 + 16 * vec;
      p.kb[e] = kb;
      p.nok[e] = n < a.N;  // N % 16 == 0: whole vectors
      p.src[e] = field_src(a, b_begin + kb, r0, n);
      p.step[e] = field_step(a, r0);
      p.dst[e] = kb * a.bstride + r0 * kSBN + 16 * vec;
    }
  }
  constexpr int kEPV = 16 / sizeof(T);
  const int per_row = a.kc / kEPV;
  p.xk = -1;
  p.xsrc = static_cast<const uint8_t*>(a.x);
  p.xdst = 0;
  if (a.vec_x && t < mrows * per_row) {
    const int r = t / per_row, v = t - r * per_row;
    p.xk = kpos<COMPACT>(v * kEPV);
    p.xsrc = reinterpret_cast<const uint8_t*>(static_cast<const T*>(a.x) +
                                              (size_t)(xr0 + r) * a.ldx +
                                              (b_begin - kb0) * a.w + p.xk);
    p.xdst = a.xoff + (r * a.xs + v * kEPV) * (int)sizeof(T);
  }
  return p;
}

// Stage chunk `ch` of this block's K slice into a ring slot: the packed
// rows its mode streams (mask, hi, lo in that order) of columns [n0, n0 +
// 128) of its w-blocks, laid out [w-block][row][128 bytes] with 16 bytes of
// padding a w-block, and x rows m0 .. m0 + mrows - 1 of the chunk at xoff,
// [row][xs], holding the chunk's multiplied positions (kpos: all of them,
// or, COMPACT, each w-block's leading 8).  W-blocks past the slice and columns
// past N read as 0, and so does x past the slice or past K (padded-K weight
// rows decode to junk, e.g. MIP2Q code 0 is +1: only zero activations null
// them).  Unaligned fields or x are staged with plain loads into the same
// slot.  b_begin, b_end, kb0 and xr0 as for stage_plan.
template <int TH, typename T, bool COMPACT>
__device__ __forceinline__ void stream_stage(const StreamArgs& a, const StagePlan& p, int ch,
                                             int b_begin, int b_end, int kb0, int n0,
                                             int xr0, int mrows, uint8_t* slot) {
  const int t = threadIdx.x;
  const int b0 = b_begin + ch * a.nbk;
  if (a.vec_fields) {
#pragma unroll
    for (int e = 0; e < kPlan; ++e) {
      if (p.kb[e] >= 0) {
        const bool in = p.nok[e] && b0 + p.kb[e] < b_end;
        // a zero-fill copy reads no byte; its source is a streamed field, never null
        g_cp_async16(slot + p.dst[e], in ? p.src[e] + ch * p.step[e] : a.dummy, in ? 16 : 0);
      }
    }
    for (int i = t + kPlan * TH; i < a.nbk * a.rows * (kSBN / 16); i += TH) {
      const int vec = i & 7, row = i >> 3;
      const int kb = row / a.rows, r0 = row - kb * a.rows;
      const int b = b0 + kb, n = n0 + 16 * vec;
      const bool in = b < b_end && n < a.N;
      g_cp_async16(slot + kb * a.bstride + r0 * kSBN + 16 * vec,
                   in ? field_src(a, b, r0, n) : a.dummy, in ? 16 : 0);
    }
  } else {
    for (int i = t; i < a.nbk * a.rows * kSBN; i += TH) {
      const int cc = i % kSBN, row = i / kSBN;
      const int kb = row / a.rows, r0 = row - kb * a.rows;
      const int b = b0 + kb, n = n0 + cc;
      slot[kb * a.bstride + r0 * kSBN + cc] =
          b < b_end && n < a.N ? *field_src(a, b, r0, n) : 0;
    }
  }
  T* xt = reinterpret_cast<T*>(slot + a.xoff);
  const T* x = static_cast<const T*>(a.x);
  const int k0 = (b0 - kb0) * a.w, kend = min(a.K, (b_end - kb0) * a.w);
  if (a.vec_x) {  // K, ldx and the slice ends are multiples of the vector
    constexpr int kEPV = 16 / sizeof(T);
    if (p.xk >= 0) {
      const bool in = k0 + p.xk < kend;
      g_cp_async16(slot + p.xdst,
                   in ? p.xsrc + (size_t)ch * (COMPACT ? 2 : 1) * a.kc * sizeof(T) : a.x,
                   in ? 16 : 0);
    }
    const int per_row = a.kc / kEPV;
    for (int i = t + TH; i < mrows * per_row; i += TH) {
      const int r = i / per_row, v = i - r * per_row, k = k0 + kpos<COMPACT>(v * kEPV);
      const bool in = k < kend;
      g_cp_async16(xt + r * a.xs + v * kEPV, in ? x + (size_t)(xr0 + r) * a.ldx + k : x,
                   in ? 16 : 0);
    }
  } else {
    for (int i = t; i < mrows * a.kc; i += TH) {
      const int r = i / a.kc, kk = i - r * a.kc, k = k0 + kpos<COMPACT>(kk);
      xt[r * a.xs + kk] = k < kend ? x[(size_t)(xr0 + r) * a.ldx + k] : T(0.f);
    }
  }
}

// Column c of four rows: word i of `in` holds row i of four adjacent
// columns (byte c = column c); the result holds column c's rows 0-3.  `pick`
// is c | (c + 4) << 4, the selector of bytes c of two words.
__device__ __forceinline__ uint32_t column4(const uint32_t* in, uint32_t pick) {
  return prmt(prmt(in[0], in[1], pick), prmt(in[2], in[3], pick), 0x5410);
}

// The int8 values of four lo codes (the nibbles of lw's low half) from the
// 16-byte code table t0..t3: codes 0-7 index (t0, t1), codes 8-15 (t2, t3),
// and each byte takes the one its code's top bit names (a selector nibble
// with bit 3 set sign-replicates, so each lookup is junk where unused).
__device__ __forceinline__ uint32_t lo_values(uint32_t lw, uint32_t t0, uint32_t t1,
                                              uint32_t t2, uint32_t t3) {
  const uint32_t low = prmt(t0, t1, lw);
  const uint32_t high = prmt(t2, t3, lw ^ 0x8888u);
  const uint32_t top = prmt(0x8000u, 0u, (lw & 0x8888u) | ((lw >> 3) & 0x1111u));
  return (low & ~top) | (high & top);
}

// Four int8 values, one a byte, to two bf16 pairs, exactly: each lane takes
// 0x43 as its high byte and either the value's low 7 bits (128 + low7) or
// its sign bit (128, or 256 when set) as its low byte; one bf16x2 fma
// subtracts the second from the first, low7 - 128 sign = the value (both
// operands and the result are exact in bf16).
__device__ __forceinline__ void bytes_to_bf16(uint32_t v, uint32_t& p01, uint32_t& p23) {
  const uint32_t low7 = v & 0x7F7F7F7Fu, sign = v & 0x80808080u;
  const uint32_t k43 = 0x43434343u, neg1 = 0xBF80BF80u;
  const uint32_t a01 = prmt(low7, k43, 0x5140), c01 = prmt(sign, k43, 0x5140);
  const uint32_t a23 = prmt(low7, k43, 0x7362), c23 = prmt(sign, k43, 0x7362);
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(p01) : "r"(c01), "r"(neg1), "r"(a01));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(p23) : "r"(c23), "r"(neg1), "r"(a23));
}

// Byte path (w = 16).  An item is one w-block of 4 adjacent columns, one
// shared-memory word a staged row (that row of the 4 columns); SPLIT
// threads share an item, each decoding 4 / SPLIT of its columns.
// kOnehot / kHistream (2 mask, 8 hi and, in kOnehot mode, 4 lo rows of
// 4-bit codes whose values fit int8): a column is byte-gathered to its 16
// mask bits, 8 hi bytes and 8 lo values (the code table applied once to
// the 32-bit lo word).  For each group of 4 positions (a mask nibble) with
// r high positions before it: one prmt takes hi bytes r .. r + 3, one takes
// lo values 4j - r .. 4j - r + 3, and one with sel[nibble] (the launcher's
// table: byte i takes hi byte (high rank of i in the nibble) or lo byte 4 +
// (low rank of i)) places all four; in kHistream mode the lo bytes are 0.
// kMaskfree (8 lo rows): a column's 8 lo bytes hold position j in nibble j,
// so each group of 4 positions is the code table applied to one half word
// (`shift4`, dliq q = 4: each code is its value's top nibble, so a mask
// and a shift per word and one prmt per 4 positions replace the table).
// kMaskfreeP (8 hi rows): hi byte j is position j < 8; the tile holds only
// those 8 positions of each w-block, as the x tile does (COMPACT).
// kDense (16 hi rows): hi byte j is position j; four gathers and four
// conversions a column, no mask, no table, no placement.
// `p` is the item's words in the slot; dst[cc] + toff the shared addresses
// of column c0 + cc's positions 0-7 and 8-15 (kMaskfreeP: 0-7) in the tile.
template <int MODE, int SPLIT>
__device__ __forceinline__ void decode_bytes(const uint8_t* p, const uint32_t* sel,
                                             const uint32_t (&code)[4], bool shift4, int c0,
                                             const uint32_t (&dst)[4 / SPLIT][2], uint32_t toff) {
  constexpr int kCols = 4 / SPLIT;  // columns a thread
  constexpr bool kMasked = MODE == kOnehot || MODE == kHistream;
  if constexpr (MODE == kDense) {
    uint32_t hr[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) hr[r] = lds32(p + r * kSBN);
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const uint32_t c = c0 + cc, pick = c | (c + 4) << 4;
      uint32_t v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) bytes_to_bf16(column4(hr + 4 * j, pick), v[2 * j], v[2 * j + 1]);
      sts128(dst[cc][0] + toff, v[0], v[1], v[2], v[3]);
      sts128(dst[cc][1] + toff, v[4], v[5], v[6], v[7]);
    }
    return;
  }
  uint32_t rows[8], lr[4];          // hi rows (kMaskfree: lo rows)
#pragma unroll
  for (int r = 0; r < 8; ++r) rows[r] = lds32(p + ((kMasked ? 2 : 0) + r) * kSBN);
  if (!kMasked) {
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const uint32_t c = c0 + cc, pick = c | (c + 4) << 4;
      const uint32_t w0 = column4(rows, pick), w1 = column4(rows + 4, pick);
      uint32_t v[8];
      if (MODE == kMaskfree && shift4) {  // a code is its value's top nibble
        const uint32_t e0 = (w0 << 4) & 0xF0F0F0F0u, o0 = w0 & 0xF0F0F0F0u;
        const uint32_t e1 = (w1 << 4) & 0xF0F0F0F0u, o1 = w1 & 0xF0F0F0F0u;
        bytes_to_bf16(prmt(e0, o0, 0x5140u), v[0], v[1]);
        bytes_to_bf16(prmt(e0, o0, 0x7362u), v[2], v[3]);
        bytes_to_bf16(prmt(e1, o1, 0x5140u), v[4], v[5]);
        bytes_to_bf16(prmt(e1, o1, 0x7362u), v[6], v[7]);
      } else if (MODE == kMaskfree) {  // w0: positions 0-7, w1: 8-15, a nibble each
        bytes_to_bf16(lo_values(w0, code[0], code[1], code[2], code[3]), v[0], v[1]);
        bytes_to_bf16(lo_values(w0 >> 16, code[0], code[1], code[2], code[3]), v[2], v[3]);
        bytes_to_bf16(lo_values(w1, code[0], code[1], code[2], code[3]), v[4], v[5]);
        bytes_to_bf16(lo_values(w1 >> 16, code[0], code[1], code[2], code[3]), v[6], v[7]);
      } else {                  // w0: positions 0-3, w1: 4-7, a byte each
        bytes_to_bf16(w0, v[0], v[1]);
        bytes_to_bf16(w1, v[2], v[3]);
      }
      sts128(dst[cc][0] + toff, v[0], v[1], v[2], v[3]);
      if (MODE == kMaskfree) sts128(dst[cc][1] + toff, v[4], v[5], v[6], v[7]);
    }
    return;
  }
  if (MODE == kOnehot) {
#pragma unroll
    for (int r = 0; r < 4; ++r) lr[r] = lds32(p + (10 + r) * kSBN);
  }
  const uint32_t mk0 = lds32(p), mk1 = lds32(p + kSBN);
#pragma unroll
  for (int cc = 0; cc < kCols; ++cc) {
    const uint32_t c = c0 + cc, pick = c | (c + 4) << 4;
    const uint32_t m = prmt(mk0, mk1, pick) & 0xFFFFu;
    const uint32_t h0 = column4(rows, pick), h1 = column4(rows + 4, pick);
    uint32_t l0 = 0u, l1 = 0u;  // lo values of ranks 0-3 and 4-7
    if (MODE == kOnehot) {
      const uint32_t l = column4(lr, pick);
      l0 = lo_values(l, code[0], code[1], code[2], code[3]);
      l1 = lo_values(l >> 16, code[0], code[1], code[2], code[3]);
    }
    uint32_t v[8];
    uint32_t r = 0;  // high positions before the nibble
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t nib = (m >> (4 * j)) & 0xFu;
      const uint32_t hw = prmt(h0, h1, 0x3210u + 0x1111u * r);
      const uint32_t lw = MODE == kOnehot ? prmt(l0, l1, 0x3210u + 0x1111u * (4 * j - r)) : 0u;
      bytes_to_bf16(prmt(hw, lw, sel[nib]), v[2 * j], v[2 * j + 1]);
      r += __popc(nib);
    }
    sts128(dst[cc][0] + toff, v[0], v[1], v[2], v[3]);
    sts128(dst[cc][1] + toff, v[4], v[5], v[6], v[7]);
  }
}

// Every other codec: one thread per (w-block, column) walks the positions,
// eight bf16 a 16-byte store.  kOnehot / kHistream: a high position takes
// the next hi byte and a low one the next q-bit field (kHistream: 0);
// kMaskfree: position i takes q-bit field i; kMaskfreeP: position i takes
// hi byte i below n_high, else 0; kDense: hi byte i (n_high = w).
template <int MODE, int TH>
__device__ __forceinline__ void decode_general(const StreamArgs& a, const uint8_t* st,
                                               __nv_bfloat16* Wt) {
  constexpr bool kMasked = MODE == kOnehot || MODE == kHistream;
  for (int idx = threadIdx.x; idx < a.nbk * kSBN; idx += TH) {
    const int kb = idx / kSBN, n = idx - kb * kSBN;
    const uint8_t* mcol = st + kb * a.bstride + n;
    const int8_t* hcol = reinterpret_cast<const int8_t*>(mcol + a.mask_rows * kSBN);
    const uint8_t* lcol = mcol + (a.mask_rows + a.hi_rows) * kSBN;
    int hc = 0, lc = 0;  // ranks among the high / low positions seen so far
    for (int p0 = 0; p0 < a.w; p0 += 8) {
      const unsigned bits = kMasked ? mcol[(p0 >> 3) * kSBN] : 0u;
      uint32_t v4[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int pos = p0 + j;
        int v = 0;
        if (MODE == kMaskfree) {
          v = g_decode_low(g_lo_field<kSBN>(lcol, a.lo_rows, pos, a.q), a.method, a.q);
        } else if (MODE == kMaskfreeP || MODE == kDense) {
          if (pos < a.n_high) v = hcol[pos * kSBN];
        } else if ((bits >> j) & 1u) {
          if (hc < a.n_high) v = hcol[hc * kSBN];
          ++hc;
        } else {
          if (MODE == kOnehot && lc < a.n_low)
            v = g_decode_low(g_lo_field<kSBN>(lcol, a.lo_rows, lc, a.q), a.method, a.q);
          ++lc;
        }
        v4[j >> 1] |= (uint32_t)__bfloat16_as_ushort(__int2bfloat16_rn(v)) << (16 * (j & 1));
      }
      sts128(smem_addr(Wt + wt_off(n, kb * a.w + p0, a.ws)), v4[0], v4[1], v4[2], v4[3]);
    }
  }
}

// One chunk's product into the accumulators.  bf16 x on tensor cores: warp
// (kh, wm, wn) takes NT n8 tiles x MT m16 tiles over its share kh of the
// chunk's k16 steps, B fragments two n8 tiles an ldmatrix.x4 from the
// weight tile and A fragments one ldmatrix.x4 an m16 tile from the x tile
// (tiles past the live rows skipped).  f32 x as f32 FMAs (RG threads a
// column) against the same exact tile.
template <int BM, typename T>
__device__ __forceinline__ void stream_product(
    const StreamArgs& a, const __nv_bfloat16* Wt, const T* Xs, int mrows,
    float (&acc)[StreamTile<BM>::MT][StreamTile<BM>::NT][4],
    float (&facc)[StreamTile<BM>::FR]) {
  using S = StreamTile<BM>;
  const int t = threadIdx.x;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int warp = t >> 5, lane = t & 31;
    const int kh = warp / (S::WM * S::WN), wr = warp % (S::WM * S::WN);
    const int wn = wr % S::WN, wm = wr / S::WN;
    const uint32_t wt = smem_addr(Wt), xs = smem_addr(Xs);
    const int steps = a.kcp >> 4, per = (steps + S::KH - 1) / S::KH;
    const int s_end = min(steps, (kh + 1) * per);
    // the row this lane addresses in each ldmatrix, and its 16-byte half
    const int bn = (wn * S::NT + (lane >> 4)) * 8 + (lane & 7), bh = (lane >> 3) & 1;
    const int ar = lane & 15, ah = lane >> 4;
    for (int st = kh * per; st < s_end; ++st) {
      const int ks = st << 4;
      uint32_t bf[S::NT][2];
#pragma unroll
      for (int jp = 0; jp < S::NT / 2; ++jp) {
        uint32_t r4[4];
        ldsm4(r4, wt + 2 * wt_off(bn + 16 * jp, ks + 8 * bh, a.ws));
        bf[2 * jp][0] = r4[0];
        bf[2 * jp][1] = r4[1];
        bf[2 * jp + 1][0] = r4[2];
        bf[2 * jp + 1][1] = r4[3];
      }
#pragma unroll
      for (int i = 0; i < S::MT; ++i) {
        const int mt = wm * S::MT + i;
        if (mt * 16 >= mrows) break;
        uint32_t af[4];
        ldsm4(af, xs + 2 * ((mt * 16 + ar) * a.xs + ks + 8 * ah));
#pragma unroll
        for (int j = 0; j < S::NT; ++j) mma_bf16(acc[i][j], af, bf[j]);
      }
    }
  } else {
    const int c = t % kSBN, rg = t / kSBN;
    for (int kk = 0; kk < a.kc; ++kk) {
      const float wv = __bfloat162float(Wt[wt_off(c, kk, a.ws)]);
#pragma unroll
      for (int i = 0; i < S::FR; ++i) {
        const int r = rg + S::RG * i;
        if (r < mrows) facc[i] += Xs[r * a.xs + kk] * wv;
      }
    }
  }
}

// MODE: kOnehot (K1: mask + hi + lo), kHistream (K9: mask + hi, low
// positions 0), kMaskfree (K2: lo in position order), kMaskfreeP (K10: hi
// in the leading n_high positions, the rest 0) or kDense (K3, K8: hi is
// every position in order); a field the mode does not stream is never
// read.  BYTES: the byte path's decode.  Grid (ceil(N / 128), ceil(M / BM),
// K slices); the K slices of one tile are one thread-block cluster.
// GROUPED (kDense only, K8): blockIdx.z is the group, K is not split and
// there is no cluster; a row tile at or past the group's live rows writes
// zeros and returns before it reads anything.  One barrier per chunk: while
// chunk ch decodes into one of two weight tiles, the product of chunk ch - 1
// runs on the other and chunks ch + 1 .. ch + kSAhead are in flight in the
// ring.
template <int MODE, int BM, typename T, bool BYTES, bool GROUPED = false>
__global__ void __launch_bounds__(StreamTile<BM>::TH, 1)
    stream_kernel(const __grid_constant__ StreamArgs a) {
  using S = StreamTile<BM>;
  constexpr bool kCompact = MODE == kMaskfreeP && BYTES;  // x and tile hold positions 0-7
  static_assert(!GROUPED || MODE == kDense, "the grouped form is kDense's alone");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint32_t sel[16];
  const int t = threadIdx.x;
  const int n0 = blockIdx.x * kSBN, m0 = blockIdx.y * BM;
  // grouped: group g's w-blocks are [g nb, g nb + nb) of the stacked field,
  // its x rows [g M, g M + M), its scale and output offset by g N and g M N
  const int g = GROUPED ? blockIdx.z : 0;
  const int kb0 = GROUPED ? g * a.nb : 0;
  const int live = GROUPED && a.live ? min(max(a.live[g], 0), a.M) : a.M;
  const float* scale = a.scale + (GROUPED ? (size_t)g * a.N : 0);
  float* out = a.out + (GROUPED ? (size_t)g * a.M * a.N : 0);
  if (GROUPED && m0 >= live) {  // nothing live in this row tile: exact zeros, no read
    for (int e = t; e < BM * kSBN; e += S::TH) {
      const int m = m0 + e / kSBN, n = n0 + e % kSBN;
      if (m < a.M && n < a.N) out[(size_t)m * a.N + n] = 0.f;
    }
    return;  // legal: a grouped launch has no cluster to wait for this block
  }
  const int mrows = min(BM, live - m0);
  const int xr0 = g * a.M + m0;
  const int b_begin = GROUPED ? kb0 : blockIdx.z * a.blocks_per_split;
  const int b_end = GROUPED ? kb0 + a.nb : min(a.nb, b_begin + a.blocks_per_split);
  const int chunks = (b_end - b_begin + a.nbk - 1) / a.nbk;
  uint8_t* ring = smem_raw;
  __nv_bfloat16* Wt = reinterpret_cast<__nv_bfloat16*>(ring + kSStages * a.slot_bytes);  // [2]
  const int wt_elems = kSBN * a.ws;
  if (BYTES && (MODE == kOnehot || MODE == kHistream) && t < 16) sel[t] = a.sel[t];
  // what neither staging nor decode writes and the product reads is zeroed
  // once: x rows past M in every slot, and the K pad [kc, kcp) of x and Wt
  const int row_bytes = a.xs * (int)sizeof(T);
  const int dead = (BM - mrows) * row_bytes / 16;
  for (int idx = t; idx < kSStages * dead; idx += S::TH) {
    const int s = idx / dead;
    reinterpret_cast<uint4*>(ring + s * a.slot_bytes + a.xoff + mrows * row_bytes)[idx - s * dead] =
        make_uint4(0u, 0u, 0u, 0u);
  }
  const int pad = a.kcp - a.kc;
  for (int idx = t; idx < kSStages * mrows * pad; idx += S::TH) {
    const int s = idx / (mrows * pad), e = idx - s * mrows * pad;
    reinterpret_cast<T*>(ring + s * a.slot_bytes + a.xoff)[(e / pad) * a.xs + a.kc + e % pad] =
        T(0.f);
  }
  for (int idx = t; idx < 2 * kSBN * pad; idx += S::TH) {
    const int tile = idx / (kSBN * pad), e = idx - tile * kSBN * pad;
    Wt[tile * wt_elems + wt_off(e / pad, a.kc + e % pad, a.ws)] = __int2bfloat16_rn(0);
  }

  const StagePlan plan = stage_plan<S::TH, T, kCompact>(a, b_begin, kb0, n0, xr0, mrows);
#pragma unroll
  for (int c = 0; c < kSAhead; ++c) {  // chunks 0 .. kSAhead - 1 in flight
    if (c < chunks)
      stream_stage<S::TH, T, kCompact>(a, plan, c, b_begin, b_end, kb0, n0, xr0, mrows,
                                       ring + c * a.slot_bytes);
    cp_async_commit_g();
  }
  // byte path: this thread's item (w-block kb, column group cg) and columns,
  // their words in a slot and their 16-byte stores in a tile, fixed per block
  constexpr int kCols = 4 / S::SPLIT;
  const int warp = t >> 5, lane = t & 31;
  const int dkb = warp / S::SPLIT;
  const int dcg = (warp % S::SPLIT) * (32 / S::SPLIT) + lane / S::SPLIT;
  const int dc0 = (lane % S::SPLIT) * kCols;
  const int doff = dkb * a.bstride + 4 * dcg;
  uint32_t dst[kCols][2];
#pragma unroll
  for (int cc = 0; cc < kCols; ++cc)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      dst[cc][h] = smem_addr(Wt + wt_off(4 * dcg + dc0 + cc, dkb * (kCompact ? 8 : 16) + 8 * h,
                                         a.ws));
  const uint32_t code[4] = {a.code[0], a.code[1], a.code[2], a.code[3]};

  float acc[S::MT][S::NT][4];  // bf16 path: [m tile][n8 tile][fragment]
  float facc[S::FR];           // f32 path: rows rg + RG i of column t % 128
#pragma unroll
  for (int i = 0; i < S::MT; ++i)
#pragma unroll
    for (int j = 0; j < S::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
  for (int i = 0; i < S::FR; ++i) facc[i] = 0.f;

  cp_async_wait_g<kSAhead - 1>();
  __syncthreads();  // chunk 0 landed; the tables and zeroed pads are written
  for (int ch = 0; ch < chunks; ++ch) {
    const uint8_t* st = ring + (ch % kSStages) * a.slot_bytes;
    if (BYTES) {
      decode_bytes<MODE, S::SPLIT>(st + doff, sel, code, a.shift4, dc0, dst,
                                   (ch & 1) * wt_elems * 2);
    } else {
      decode_general<MODE, S::TH>(a, st, Wt + (ch & 1) * wt_elems);
    }
    if (ch > 0)
      stream_product<BM, T>(a, Wt + ((ch - 1) & 1) * wt_elems,
                            reinterpret_cast<const T*>(ring + ((ch - 1) % kSStages) * a.slot_bytes +
                                                       a.xoff),
                            mrows, acc, facc);
    // the slot of chunk ch - 2, whose decode and product barriers have closed
    const int ahead = ch + kSAhead;
    if (ahead < chunks)
      stream_stage<S::TH, T, kCompact>(a, plan, ahead, b_begin, b_end, kb0, n0, xr0, mrows,
                                       ring + (ahead % kSStages) * a.slot_bytes);
    cp_async_commit_g();
    cp_async_wait_g<kSAhead - 1>();
    __syncthreads();  // chunk ch decoded, chunk ch + 1 landed, chunk ch - 1's product done
  }
  if (chunks > 0)
    stream_product<BM, T>(a, Wt + ((chunks - 1) & 1) * wt_elems,
                          reinterpret_cast<const T*>(ring + ((chunks - 1) % kSStages) *
                                                                a.slot_bytes + a.xoff),
                          mrows, acc, facc);
  cp_async_wait_g<0>();

  // every accumulator to its (K share, row, column) of a [KH][BM][128] f32
  // tile in shared memory; the shares are then added in kh order
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kKH = kBf16 ? S::KH : 1;
  __syncthreads();  // every warp's last product is done with the ring and tiles
  float* part = reinterpret_cast<float*>(smem_raw);
  if constexpr (kBf16) {
    const int gid = lane >> 2, tig = lane & 3;
    const int kh = warp / (S::WM * S::WN), wr = warp % (S::WM * S::WN);
    const int wn = wr % S::WN, wm = wr / S::WN;
#pragma unroll
    for (int i = 0; i < S::MT; ++i)
#pragma unroll
      for (int j = 0; j < S::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[(kh * BM + (wm * S::MT + i) * 16 + gid + (e >> 1) * 8) * kSBN +
               (wn * S::NT + j) * 8 + tig * 2 + (e & 1)] = acc[i][j][e];
  } else {
#pragma unroll
    for (int i = 0; i < S::FR; ++i) part[(t / kSBN + S::RG * i) * kSBN + t % kSBN] = facc[i];
  }
  __syncthreads();
  if (kKH > 1)
    for (int e = t; e < BM * kSBN; e += S::TH)
      for (int kh = 1; kh < kKH; ++kh) part[e] += part[kh * BM * kSBN + e];
  if (!GROUPED && gridDim.z > 1) {
    // split-K, as in strum_matmul_kernel: every slice leaves its partial
    // tile in its shared memory and rank r sums elements r, r + S, ... over
    // the S partials in rank order through distributed shared memory
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int Sz = gridDim.z;
    for (int e = blockIdx.z + Sz * t; e < BM * kSBN; e += Sz * S::TH) {
      const int m = m0 + e / kSBN, n = n0 + e % kSBN;
      if (m >= a.M || n >= a.N) continue;
      float sum = *cluster.map_shared_rank(part + e, 0);
      for (int r = 1; r < Sz; ++r) sum += *cluster.map_shared_rank(part + e, r);
      a.out[(size_t)m * a.N + n] = sum * a.scale[n];
    }
    cluster.sync();  // every slice's shared memory stays alive until all are read
    return;
  }
  // each thread reads what it added; grouped rows past the live count are 0
  for (int e = t; e < BM * kSBN; e += S::TH) {
    const int m = m0 + e / kSBN, n = n0 + e % kSBN;
    if (m < a.M && n < a.N)
      out[(size_t)m * a.N + n] = GROUPED && e / kSBN >= mrows ? 0.f : part[e] * scale[n];
  }
}

// Dynamic shared memory of a launch: the ring and the two weight tiles, or
// the partial tiles of the epilogue, which reuse them.
template <int BM>
size_t stream_smem(const StreamArgs& a) {
  return std::max((size_t)kSStages * a.slot_bytes + 2 * 2 * (size_t)kSBN * a.ws,
                  (size_t)StreamTile<BM>::KH * BM * kSBN * sizeof(float));
}

template <int MODE, int BM, typename T, bool BYTES>
cudaError_t stream_launch_typed(StreamArgs a, int splits, cudaStream_t stream) {
  const size_t smem = stream_smem<BM>(a);
  auto kernel = stream_kernel<MODE, BM, T, BYTES>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const int tiles = ((a.N + kSBN - 1) / kSBN) * ((a.M + BM - 1) / BM);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(StreamTile<BM>::TH);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attr[1].val.clusterSchedulingPolicyPreference = cudaClusterSchedulingPolicyLoadBalancing;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  // Fewer slices where the card cannot hold every cluster of the launch at
  // once (at one block an SM it holds fewer clusters of 8 than SMs / 8, and
  // a second wave would double the time).  The answer depends only on the
  // launch's shape, so a repeated call takes the same split and the same
  // summation order; it is asked of the card once per shape.
  static std::mutex lock;
  static std::map<std::tuple<const void*, size_t, int, int>, int> fitted;
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel), smem, tiles, splits);
  {
    std::lock_guard<std::mutex> hold(lock);
    const auto hit = fitted.find(key);
    if (hit != fitted.end()) {
      splits = hit->second;
    } else {
      while (splits > 1) {
        attr[0].val.clusterDim.z = splits;
        cfg.gridDim = dim3((a.N + kSBN - 1) / kSBN, (a.M + BM - 1) / BM, splits);
        int fit = 0;
        e = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
        if (e != cudaSuccess) return e;
        if (fit >= tiles) break;
        --splits;
      }
      fitted[key] = splits;
    }
  }
  a.blocks_per_split = (a.nb + splits - 1) / splits;
  splits = (a.nb + a.blocks_per_split - 1) / a.blocks_per_split;  // no empty slice
  cfg.gridDim = dim3((a.N + kSBN - 1) / kSBN, (a.M + BM - 1) / BM, splits);
  if (splits == 1) {
    kernel<<<cfg.gridDim, StreamTile<BM>::TH, smem, stream>>>(a);
    return cudaGetLastError();
  }
  attr[0].val.clusterDim.z = splits;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// K8: one plain launch, grid (ceil(N / 128), ceil(M / BM), G).  No split
// and no cluster (each group's tiles stream all of K), so the split cache
// of stream_launch_typed is not asked.
template <int BM, typename T, bool BYTES>
cudaError_t stream_grouped_typed(const StreamArgs& a, int G, cudaStream_t stream) {
  const size_t smem = stream_smem<BM>(a);
  auto kernel = stream_kernel<kDense, BM, T, BYTES, true>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.N + kSBN - 1) / kSBN, (a.M + BM - 1) / BM, G);
  kernel<<<grid, StreamTile<BM>::TH, smem, stream>>>(a);
  return cudaGetLastError();
}

// groups = 0: a 2-D launch in `splits` K slices; groups >= 1 (kDense only):
// a stack of `groups` weights, K not split.
template <int MODE, bool BYTES>
cudaError_t stream_rows(const StreamArgs& a, int x_bf16, int bm, int splits, int groups,
                        cudaStream_t s) {
  if constexpr (MODE == kDense) {
    if (groups) {
      if (!x_bf16) return stream_grouped_typed<16, float, BYTES>(a, groups, s);
      return bm == 16 ? stream_grouped_typed<16, __nv_bfloat16, BYTES>(a, groups, s)
                      : stream_grouped_typed<128, __nv_bfloat16, BYTES>(a, groups, s);
    }
  }
  if (!x_bf16) return stream_launch_typed<MODE, 16, float, BYTES>(a, splits, s);
  return bm == 16 ? stream_launch_typed<MODE, 16, __nv_bfloat16, BYTES>(a, splits, s)
                  : stream_launch_typed<MODE, 128, __nv_bfloat16, BYTES>(a, splits, s);
}

template <bool BYTES>
cudaError_t stream_mode(int mode, const StreamArgs& a, int x_bf16, int bm, int splits,
                        int groups, cudaStream_t s) {
  switch (mode) {
    case kOnehot: return stream_rows<kOnehot, BYTES>(a, x_bf16, bm, splits, 0, s);
    case kHistream: return stream_rows<kHistream, BYTES>(a, x_bf16, bm, splits, 0, s);
    case kMaskfree: return stream_rows<kMaskfree, BYTES>(a, x_bf16, bm, splits, 0, s);
    case kDense: return stream_rows<kDense, BYTES>(a, x_bf16, bm, splits, groups, s);
    default: return stream_rows<kMaskfreeP, BYTES>(a, x_bf16, bm, splits, 0, s);
  }
}

// K1 (kOnehot), K2 (kMaskfree), K9 (kHistream), K10 (kMaskfreeP) and K3
// (kDense) for w <= 64, w % 8 == 0; K8 is kDense with `groups` >= 1 (x (G,
// M, K) with ldx = K, fields (G, nb, rows, N), scale (G, N), `live` (G,)
// live rows or null).  Each mode streams its fields only -- K1 mask, hi and
// lo; K9 mask and hi; K2 lo; K10 and K3 / K8 hi -- and the others may be
// null.  `tables` (host memory, 20 words: sel[16] then code[4], from
// kernels/strum_matmul.py) selects the byte path, or null.  A kOnehot call
// that reads no lo (sparsity, n_low = 0) runs as kHistream: its low
// positions are 0.
int stream_launch(int mode, const void* x, int x_bf16, const void* mask, const void* hi,
                  const void* lo, const void* scale, const int* live, void* out, int groups,
                  int M, int N, int K, int ldx, int nb, int w, int mask_rows, int hi_rows,
                  int lo_rows, int n_low, int q, int method, int splits,
                  const uint32_t* tables, cudaStream_t s) {
  const bool masked = mode == kOnehot || mode == kHistream;
  const bool reads_hi = mode != kMaskfree;
  const bool reads_lo =
      mode == kMaskfree || (mode == kOnehot && method != kSparsity && n_low > 0);
  const int n_high = w - n_low;
  if (M <= 0 || N <= 0 || K <= 0 || nb <= 0 || w <= 0 || w % 8 || w > 64 || n_low < 0 ||
      n_low > w || K > nb * w || ldx < K || splits < 1 || splits > kMaxSplits || !x ||
      !scale || !out || (masked && (!mask || mask_rows != w / 8)) ||
      (reads_hi && (!hi || hi_rows < std::max(n_high, 1))) ||
      (mode == kMaskfree && (n_low != w || (method != kDliq && method != kMip2q))) ||
      (mode == kMaskfreeP && n_high < 1) || (mode == kDense && n_low != 0) ||
      (groups && (mode != kDense || groups > 65535 || ldx != K || splits != 1)) ||
      groups < 0 || (reads_lo && (!lo || q < 1 || q > 8 || lo_rows * 8 < n_low * q)))
    return (int)cudaErrorInvalidValue;
  StreamArgs a = {};
  a.x = x;
  a.mask = masked ? static_cast<const uint8_t*>(mask) : nullptr;
  a.hi = reads_hi ? static_cast<const int8_t*>(hi) : nullptr;
  a.lo = reads_lo ? static_cast<const uint8_t*>(lo) : nullptr;
  a.dummy = masked ? a.mask : reads_hi ? reinterpret_cast<const uint8_t*>(a.hi) : a.lo;
  a.scale = static_cast<const float*>(scale);
  a.live = groups ? live : nullptr;
  a.out = static_cast<float*>(out);
  a.M = M; a.N = N; a.K = K; a.ldx = ldx;
  a.nb = nb; a.w = w;
  a.blocks_per_split = nb;  // a 2-D launch sets its own once the split is fitted
  a.mask_rows = masked ? mask_rows : 0;
  a.hi_rows = reads_hi ? hi_rows : 0;
  a.lo_rows = reads_lo ? lo_rows : 0;
  a.n_high = n_high; a.n_low = n_low; a.q = q; a.method = method;
  const int bm = !x_bf16 || M <= 16 ? 16 : 128;
  a.nbk = std::max(1, (bm == 16 ? StreamTile<16>::KC : StreamTile<128>::KC) / w);
  // K10's byte path (COMPACT) stages and multiplies only each w-block's 8
  // live positions: the other 8 weights are 0, so their x is never read
  a.kc = a.nbk * (mode == kMaskfreeP && tables ? 8 : w);
  a.kcp = (a.kc + 15) / 16 * 16;
  a.ws = (a.kcp + 63) / 64 * 64;
  a.xs = a.kcp + (x_bf16 ? 8 : 4);
  a.rows = a.mask_rows + a.hi_rows + a.lo_rows;
  a.bstride = a.rows * kSBN + 16;
  a.xoff = a.nbk * a.bstride;
  a.slot_bytes = (a.xoff + bm * a.xs * (x_bf16 ? 2 : 4) + 15) & ~15;
  const uintptr_t fields = reinterpret_cast<uintptr_t>(a.mask) |
                           reinterpret_cast<uintptr_t>(a.hi) |
                           reinterpret_cast<uintptr_t>(a.lo);
  a.vec_fields = N % 16 == 0 && fields % 16 == 0;
  const int epv = x_bf16 ? 8 : 4;
  a.vec_x = K % epv == 0 && ldx % epv == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int run = mode == kOnehot && !reads_lo ? kHistream : mode;
  if (tables) {  // the byte path's layouts: w = 16 and (but K2, K3) 8 high
    const bool fits =
        w == 16 && (mode == kMaskfree ? q == 4 && lo_rows == 8
                    : mode == kDense  ? hi_rows == 16
                                      : n_low == 8 && hi_rows == 8 &&
                                            (!reads_lo || (q == 4 && lo_rows == 4)));
    if (!fits) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < 16; ++i) a.sel[i] = tables[i];
    for (int i = 0; i < 4; ++i) a.code[i] = tables[16 + i];
    // dliq q = 4's table (code c -> c << 4 as a byte): a code is its value's top nibble
    a.shift4 = mode == kMaskfree && a.code[0] == 0x30201000u && a.code[1] == 0x70605040u &&
               a.code[2] == 0xB0A09080u && a.code[3] == 0xF0E0D0C0u;
    return (int)stream_mode<true>(run, a, x_bf16, bm, splits, groups, s);
  }
  return (int)stream_mode<false>(run, a, x_bf16, bm, splits, groups, s);
}

}  // namespace

// K1, K2, K3, K9 and K10: x (M, K) with row stride ldx, the packed fields
// the mode streams (the others null), then `tables` (host memory: the byte
// path's 16 selectors and 4 code-table words, or null) before the stream.
// w > 64 and w % 8 != 0 run on the template (tables must be null).
#define STRUM_STREAM_ENTRY(NAME, MODE)                                                \
  extern "C" int NAME(const void* x, int x_bf16, const void* mask, const void* hi,     \
                      const void* lo, const void* scale, void* out, int M, int N,     \
                      int K, int ldx, int nb, int w, int mask_rows, int hi_rows,      \
                      int lo_rows, int n_low, int q, int method, int splits,          \
                      const unsigned* tables, void* stream) {                         \
    if (w > 64 || w % 8) {                                                            \
      if (tables) return (int)cudaErrorInvalidValue;                                  \
      return launch<MODE>(x, x_bf16, mask, hi, lo, scale, out, 0, M, N, K, ldx, nb,   \
                          w, mask_rows, hi_rows, lo_rows, n_low, q, method, splits,   \
                          stream);                                                    \
    }                                                                                 \
    return stream_launch(MODE, x, x_bf16, mask, hi, lo, scale, nullptr, out, 0, M, N, \
                         K, ldx, nb, w, mask_rows, hi_rows, lo_rows, n_low, q, method, \
                         splits, tables, static_cast<cudaStream_t>(stream));         \
  }

STRUM_STREAM_ENTRY(strum_onehot_launch, kOnehot)
STRUM_STREAM_ENTRY(strum_maskfree_launch, kMaskfree)      // K2: mask and hi are null
STRUM_STREAM_ENTRY(strum_histream_launch, kHistream)      // K9: lo is null
STRUM_STREAM_ENTRY(strum_maskfree_p_launch, kMaskfreeP)   // K10: mask and lo are null
STRUM_STREAM_ENTRY(strum_dense_launch, kDense)            // K3: mask and lo are null

// K8: x (G, M, K) contiguous, hi (G, nb, hi_rows, N), scale (G, N); mask and
// lo are not read (pass null); rows (G,) int32 live rows per group, or null
// (every row live): a row tile at or past rows[g] reads nothing and writes
// zeros, and rows past the count inside a computed tile are written as 0.
// `tables` as for the 2-D entries.  w > 64 and w % 8 != 0 run on the
// template, which does not read rows (x is 0 past them, and so is y).
extern "C" int strum_grouped_dense_launch(const void* x, int x_bf16, const void* mask,
                                          const void* hi, const void* lo, const void* scale,
                                          const void* rows, void* out, int G, int M, int N,
                                          int K, int nb, int w, int mask_rows, int hi_rows,
                                          int lo_rows, int n_low, int q, int method,
                                          const unsigned* tables, void* stream) {
  if (G <= 0) return (int)cudaErrorInvalidValue;
  if (w > 64 || w % 8) {
    if (tables) return (int)cudaErrorInvalidValue;
    return launch<kDense>(x, x_bf16, mask, hi, lo, scale, out, G, M, N, K, K, nb, w,
                          mask_rows, hi_rows, lo_rows, n_low, q, method, 1, stream);
  }
  return stream_launch(kDense, x, x_bf16, mask, hi, lo, scale, static_cast<const int*>(rows),
                       out, G, M, N, K, K, nb, w, mask_rows, hi_rows, lo_rows, n_low, q,
                       method, 1, tables, static_cast<cudaStream_t>(stream));
}

// K6: x (G, M, K) contiguous, f32 or bf16; rows (G,) int32 live rows per
// group, or null (every row live).  w % 8 == 0, w <= 64.
extern "C" int strum_grouped_onehot_launch(const void* x, int x_bf16, const void* mask,
                                           const void* hi, const void* lo,
                                           const void* scale, const void* rows, void* out,
                                           int G, int M, int N, int K, int nb, int w,
                                           int mask_rows, int hi_rows, int lo_rows,
                                           int n_low, int q, int method, void* stream) {
  if (G <= 0 || G > 65535 || M <= 0 || N <= 0 || K <= 0 || nb <= 0 || w <= 0 ||
      w % 8 != 0 || w > 64 || mask_rows != w / 8 || hi_rows <= 0 || lo_rows <= 0 ||
      K > nb * w || (method != kSparsity && (q < 1 || q > 8)))
    return (int)cudaErrorInvalidValue;
  GroupedArgs a;
  set_grouped(a, x, scale, rows, out, M, N, K, nb, w, n_low, q, method);
  a.mask = static_cast<const uint8_t*>(mask);
  a.hi = static_cast<const int8_t*>(hi);
  a.lo = static_cast<const uint8_t*>(lo);
  a.mask_rows = mask_rows; a.hi_rows = hi_rows; a.lo_rows = lo_rows;
  const void* fields[] = {mask, hi, lo};
  return launch_grouped<kOnehot>(a, x_bf16, fields, 3, G,
                                 static_cast<cudaStream_t>(stream));
}

// K7 (p = 1): lo (G, nb, lo_rows, N) and scale only -- mask and hi are not
// read (pass null) and mask_rows / hi_rows are ignored; rows as for K6.
// n_low == w <= 64, dliq or mip2q, lo_rows * 8 >= w * q.
extern "C" int strum_grouped_maskfree_launch(const void* x, int x_bf16, const void* mask,
                                             const void* hi, const void* lo,
                                             const void* scale, const void* rows,
                                             void* out, int G, int M, int N, int K, int nb,
                                             int w, int mask_rows, int hi_rows,
                                             int lo_rows, int n_low, int q, int method,
                                             void* stream) {
  (void)mask; (void)hi; (void)mask_rows; (void)hi_rows;
  if (G <= 0 || G > 65535 || M <= 0 || N <= 0 || K <= 0 || nb <= 0 || w <= 0 ||
      w > 64 || n_low != w || (method != kDliq && method != kMip2q) || q < 1 || q > 8 ||
      lo_rows * 8 < w * q || K > nb * w)
    return (int)cudaErrorInvalidValue;
  GroupedArgs a;
  set_grouped(a, x, scale, rows, out, M, N, K, nb, w, n_low, q, method);
  a.mask = nullptr;
  a.hi = nullptr;
  a.lo = static_cast<const uint8_t*>(lo);
  a.mask_rows = 0; a.hi_rows = 0; a.lo_rows = lo_rows;
  const void* fields[] = {lo};
  return launch_grouped<kMaskfree>(a, x_bf16, fields, 1, G,
                                   static_cast<cudaStream_t>(stream));
}
