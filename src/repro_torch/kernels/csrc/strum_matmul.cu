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
// values are exact in bf16 and the scale comes after the sum).  What sets the
// time of every design here so far is the decode work per weight, not bytes.
//
// K1-K3, K9, K10 and K8 (one template, strum_matmul_kernel; a first version
// that is right, not yet fast): a block owns a BM x 64 output tile and a
// contiguous range of w-blocks along K.  For each K chunk it (1) decodes the
// chunk's weights into shared memory as f32, one thread per (w-block,
// column): a high position takes the next hi byte and a low one the next
// q-bit field, so a position's rank inside its set is the running count of
// set (clear) mask bits before it, with no one-hot contraction; (2) stages
// the x rows as f32 (any K past the true reduction dim reads as 0: padded-K
// weight rows decode to junk, e.g. MIP2Q code 0 is +1, and only zero
// activations null them); (3) each thread accumulates BM/4 rows of one
// column in f32; the per-column scale is applied once in the epilogue.
// At decode the output tiles alone cannot fill the card (N = 2048 gives 32
// tiles on 132 SMs), so a 2-D weight is split along K over blockIdx.z, at
// most 8 slices; the slices of one tile are one thread-block cluster, each
// leaves its partial tile in its shared memory, and rank r sums every S-th
// element of the tile over the S partials in rank order through distributed
// shared memory and writes it.  No atomics and no scratch: two calls on the
// same inputs give the same bits.  A tile takes at most 8 slices (a
// portable cluster size) where the atomics took up to 9, and a slice's time
// is close to proportional to its K range (PERF.md has the cost at decode).
// K8's stacks fill the card with their own tiles and are never split.
// K9 and K10 are the draft lowerings of self-speculative decoding: the same
// payload read at lower fidelity, a strict subset of its bytes.  K9
// (histream) walks the mask as K1 does, a set bit takes the next hi byte and
// a clear bit decodes to 0: the lo stream is never read.  K10 (maskfree_p)
// reads neither mask nor lo: position i < n_high of a block takes hi[i], the
// rest are 0.  Their wrappers pass a null pointer for every field they do not
// stream, so a stray read faults instead of going unnoticed.
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

#include <cooperative_groups.h>
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

__device__ __forceinline__ int g_lo_field(const uint8_t* col, int rows, int j, int q) {
  const int bit = j * q, byte = bit >> 3, sh = bit & 7;
  unsigned v = col[byte * kGBN];
  if (sh + q > 8 && byte + 1 < rows) v |= (unsigned)col[(byte + 1) * kGBN] << 8;
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

}  // namespace

#define STRUM_ENTRY(NAME, MODE)                                                       \
  extern "C" int NAME(const void* x, int x_bf16, const void* mask, const void* hi,     \
                      const void* lo, const void* scale, void* out, int M, int N,     \
                      int K, int ldx, int nb, int w, int mask_rows, int hi_rows,      \
                      int lo_rows, int n_low, int q, int method, int splits,          \
                      void* stream) {                                                 \
    return launch<MODE>(x, x_bf16, mask, hi, lo, scale, out, 0, M, N, K, ldx, nb, w,  \
                        mask_rows, hi_rows, lo_rows, n_low, q, method, splits,        \
                        stream);                                                      \
  }

STRUM_ENTRY(strum_onehot_launch, kOnehot)
STRUM_ENTRY(strum_maskfree_launch, kMaskfree)
STRUM_ENTRY(strum_dense_launch, kDense)
STRUM_ENTRY(strum_histream_launch, kHistream)     // K9: lo is null
STRUM_ENTRY(strum_maskfree_p_launch, kMaskfreeP)  // K10: mask and lo are null

// K8 (the 2-D kernels' template): x (G, M, K) contiguous, G >= 1, no split-K.
#define STRUM_GROUPED_ENTRY(NAME, MODE)                                               \
  extern "C" int NAME(const void* x, int x_bf16, const void* mask, const void* hi,     \
                      const void* lo, const void* scale, void* out, int G, int M,     \
                      int N, int K, int nb, int w, int mask_rows, int hi_rows,        \
                      int lo_rows, int n_low, int q, int method, void* stream) {      \
    if (G <= 0) return (int)cudaErrorInvalidValue;                                   \
    return launch<MODE>(x, x_bf16, mask, hi, lo, scale, out, G, M, N, K, K, nb, w,    \
                        mask_rows, hi_rows, lo_rows, n_low, q, method, 1, stream);    \
  }

STRUM_GROUPED_ENTRY(strum_grouped_dense_launch, kDense)

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
