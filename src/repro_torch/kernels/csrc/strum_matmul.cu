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
// K6-K8 are the same kernels over a stack of G weights (MoE expert stacks):
// y[g] = x[g] @ dequant(W[g]), x (G, M, K), every packed field (G, nb, rows,
// N), scale (G, N), y (G, M, N), all contiguous.  The group is the grid's z
// axis and each block offsets its pointers by the group's strides (a
// template flag, so the 2-D kernels compile as before).  The grouped
// entries never split K: an expert stack has G x ceil(N/64) >= 132 output
// tiles, enough to fill the card, so they need no atomicAdd and give the
// same result on every run.
// They compute every group's rows, empty experts included, as the TPU
// kernel does.
//
// K9 and K10 are the draft lowerings of self-speculative decoding: the same
// payload read at lower fidelity, a strict subset of its bytes.  K9
// (histream) walks the mask as K1 does, a set bit takes the next hi byte and
// a clear bit decodes to 0: the lo stream is never read.  K10 (maskfree_p)
// reads neither mask nor lo: position i < n_high of a block takes hi[i], the
// rest are 0.  Their wrappers pass a null pointer for every field they do not
// stream, so a stray read faults instead of going unnoticed.  At OLMo-1B
// decode (mip2q w = 16, p = 0.5) they read 10 and 8 of K1's 14 bytes per 16
// weights: bound by bytes as K1 is, with less decode work per weight.
//
// Packed layout (one [1, w] block per column, N contiguous in every field):
//   mask  (nb, w/8, N)            uint8, LSB-first, 1 = high
//   hi    (nb, hi_rows, N)        int8, the n_high high values in position order
//   lo    (nb, lo_rows, N)        uint8, n_low q-bit fields, LSB-first along the
//                                 block axis; a field may straddle two bytes
//   scale (N,)                    f32 per-column scale
//
// What bounds it: at decode (M = batch, a few rows) the op reads every packed
// byte once and does ~2 flops per weight, so it is bound by HBM bytes; the
// point of StruM is that those bytes are 14/16 of int8 (mip2q, w = 16, p = .5).
// At prefill (M = 128) the card's bound is the bf16 tensor-core rate (decoded
// values are exact in bf16 and the scale comes after the sum), which these f32
// FMAs on the CUDA cores are far from; wgmma on bf16 operands would close it.
//
// Design (a first version that is right, not yet fast): a block owns a
// BM x 64 output tile of one group and a contiguous range of w-blocks along K
// (split-K over blockIdx.z, partial sums added with atomicAdd when a weight is
// split in more than one slice).  For each K chunk
// it (1) decodes the chunk's weights into shared memory, one thread per
// (w-block, column): a high position takes the next hi byte and a low one the
// next q-bit field, so a position's rank inside its set is the running count
// of set (clear) mask bits before it -- the popcount of the lower mask bits --
// with no one-hot contraction; (2) stages the x rows as f32 (any K past the
// true reduction dim reads as 0: padded-K weight rows decode to junk, e.g.
// MIP2Q code 0 is +1, and only zero activations null them); (3) each thread
// accumulates BM/4 rows of one column in f32.  The per-column scale is applied
// once in the epilogue.  M and N are bound-checked in the kernel: no padding.
// Decoded values are integers of magnitude <= 128, exact in f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;                       // output columns per block
constexpr int kRowGroups = kThreads / kBN;    // threads sharing one column
constexpr int kTargetKC = 64;                 // K elements staged per chunk

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

  const int n = n0 + c;
  if (n >= a.N) return;
  const float s = a.scale[n];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int m = m0 + rg + kRowGroups * i;
    if (m >= a.M) continue;
    float* o = a.out + (size_t)m * a.N + n;
    if (!GROUPED && gridDim.z > 1) atomicAdd(o, acc[i] * s);
    else *o = acc[i] * s;
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
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
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

// Grouped entries (K6-K8): x (G, M, K) contiguous, G >= 1, no split-K.
#define STRUM_GROUPED_ENTRY(NAME, MODE)                                               \
  extern "C" int NAME(const void* x, int x_bf16, const void* mask, const void* hi,     \
                      const void* lo, const void* scale, void* out, int G, int M,     \
                      int N, int K, int nb, int w, int mask_rows, int hi_rows,        \
                      int lo_rows, int n_low, int q, int method, void* stream) {      \
    if (G <= 0) return (int)cudaErrorInvalidValue;                                   \
    return launch<MODE>(x, x_bf16, mask, hi, lo, scale, out, G, M, N, K, K, nb, w,    \
                        mask_rows, hi_rows, lo_rows, n_low, q, method, 1, stream);    \
  }

STRUM_GROUPED_ENTRY(strum_grouped_onehot_launch, kOnehot)
STRUM_GROUPED_ENTRY(strum_grouped_maskfree_launch, kMaskfree)
STRUM_GROUPED_ENTRY(strum_grouped_dense_launch, kDense)
