// Gather-fused COO cost with affine epilogue, float32:
//
//   out_k = sum_l L(Cx[rows_k, rows_l], Cy[cols_k, cols_l]) * t_l + off_k
//
// with L one of l1 |a-b|, l2 (a-b)^2, kl a*(log max(a,1e-10) - log max(b,1e-10)) - a + b.
// Duplicate (row, col) pairs are parallel entries: nothing is merged.
//
// Replaces spar_cost_pallas (src/repro/kernels/spar_cost/spar_cost.py, body
// _fused_kernel), the TPU kernel of the above-budget spar_cost mode.
//
// What bounds it on an H100: by its inputs, operations (s^2 loss evaluations
// and FMAs on a few MB of input). In practice the s^2 gathers bound it: each
// (k, l) pair reads two floats at data-dependent addresses.
//
// The support may come in any order. The kernel runs over it in the order
// given (rows, cols, t) and writes output k to out[perm[k]], adding
// off[perm[k]] (perm null: the identity). Callers that sort the support by
// row once (ops.make_spar_cost_fn) pass the sorted rows/cols, t gathered into
// that order, and the sorting permutation.
//
// Design, rows path (m + n rows fit in shared memory). The TPU kernel keeps
// the row panels Cx[rows], Cy[cols] of a block of outputs resident in VMEM;
// here a block takes a group of G consecutive outputs k (G up to 16, as many
// as fit in 227 KB: 14 at m = n = 2048) and stages their rows Cx[r_k, :] and
// Cy[c_k, :] in shared memory once. Consecutive outputs with the same r_k
// share one staged Cx row (with a support sorted by row, most of a group
// does). Then the block streams (r_l, c_l, t_l) through registers, one l
// per thread per step, and every thread evaluates its l against all G
// outputs: each stream element is loaded once per block and used G times,
// and each pair costs two shared-memory gathers instead of two L1 gathers.
// With the support sorted by row, the lanes of a warp mostly share r_l, so
// the Cx gather is a broadcast and only the Cy gather (random columns of one
// row, conflicts set by the data, not by the row stride, so padding does not
// help) pays bank conflicts. Each thread keeps G accumulators; the block
// reduces them per output in a fixed order (warp shuffles, then warps in
// order), so runs are identical. kl takes __logf (MUFU lg2; absolute error
// ~1e-6 of |log|, far inside the kernel's tolerance) of both gathered values.
//
// Global path (m + n rows exceed shared memory: m + n > ~58000): the first
// port's kernel, one warp per output row k, blockDim/32 rows per block; the
// block stages chunks of (rows, cols, t) in shared memory and each lane
// reads Cx[rows_k, rows_l] and Cy[cols_k, cols_l] through the read-only
// path (L1/L2). The launcher picks the path by shape; both are exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 2048;   // global path: stream chunk staged per block
constexpr int kMaxG = 16;      // rows path: outputs per block at most

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int LOSS>
__device__ __forceinline__ float ground_loss(float a, float b) {
  if (LOSS == 0) return fabsf(a - b);
  if (LOSS == 1) {
    const float d = a - b;
    return d * d;
  }
  const float eps = 1e-10f;  // core/ground_cost._KL_EPS
  return a * (logf(fmaxf(a, eps)) - logf(fmaxf(b, eps))) - a + b;
}

template <int LOSS>
__device__ __forceinline__ float ground_loss_fast(float a, float b) {
  if (LOSS != 2) return ground_loss<LOSS>(a, b);
  const float eps = 1e-10f;
  return a * (__logf(fmaxf(a, eps)) - __logf(fmaxf(b, eps))) - a + b;
}

__device__ __forceinline__ long long out_index(const int* perm, long long k) {
  return perm ? (long long)perm[k] : k;
}

// ---------------------------------------------------------------------------
// rows path
// ---------------------------------------------------------------------------

// len floats from src to shared dst, the whole block
__device__ __forceinline__ void stage_row(float* dst, const float* src,
                                          long long len) {
  if ((len & 3) == 0 && ((uintptr_t)src & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (long long i = threadIdx.x; i < (len >> 2); i += blockDim.x)
      d4[i] = __ldg(s4 + i);
  } else {
    for (long long i = threadIdx.x; i < len; i += blockDim.x)
      dst[i] = __ldg(src + i);
  }
}

// shared layout: Cy rows [G][np], Cx rows [G][mp], partial sums
// [warps][kMaxG], then per output (kMaxG each): the slot of its Cx row,
// its r_k and its c_k
template <int LOSS>
__global__ void __launch_bounds__(1024)
    spar_cost_rows_kernel(const float* __restrict__ Cx, long long m,
                          const float* __restrict__ Cy, long long n,
                          const int* __restrict__ rows,
                          const int* __restrict__ cols,
                          const float* __restrict__ t,
                          const float* __restrict__ off,
                          const int* __restrict__ perm,
                          float* __restrict__ out, long long s, int G,
                          int mp, int np) {
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  float* sy = smem;
  float* sx = sy + (size_t)G * np;
  float* red = sx + (size_t)G * mp;
  int* slot = reinterpret_cast<int*>(red + warps * kMaxG);
  int* rk = slot + kMaxG;
  int* ck = rk + kMaxG;

  const long long k0 = (long long)blockIdx.x * G;
  const int gk = (int)(s - k0 < G ? s - k0 : G);
  if (threadIdx.x < gk) {
    rk[threadIdx.x] = rows[k0 + threadIdx.x];
    ck[threadIdx.x] = cols[k0 + threadIdx.x];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int d = -1;
    for (int i = 0; i < gk; ++i) {
      if (i == 0 || rk[i] != rk[i - 1]) ++d;
      slot[i] = d;
    }
  }
  __syncthreads();
  for (int i = 0; i < gk; ++i) {
    if (i == 0 || slot[i] != slot[i - 1])
      stage_row(sx + (size_t)slot[i] * mp, Cx + (long long)rk[i] * m, m);
    stage_row(sy + (size_t)i * np, Cy + (long long)ck[i] * n, n);
  }
  __syncthreads();

  int xo[kMaxG];
  bool fresh[kMaxG];   // output i reads another Cx row than output i - 1
#pragma unroll
  for (int i = 0; i < kMaxG; ++i) {
    const int si = slot[i < gk ? i : gk - 1];
    xo[i] = si * mp;
    fresh[i] = i == 0 || (i < gk && si != slot[i - 1]);
  }
  float acc[kMaxG];
#pragma unroll
  for (int i = 0; i < kMaxG; ++i) acc[i] = 0.f;

  long long l = threadIdx.x;
  int r = 0, c = 0;
  float tl = 0.f;
  if (l < s) {
    r = __ldg(rows + l);
    c = __ldg(cols + l);
    tl = __ldg(t + l);
  }
  while (l < s) {
    const long long ln = l + blockDim.x;   // prefetch the next element
    int rn = 0, cn = 0;
    float tn = 0.f;
    if (ln < s) {
      rn = __ldg(rows + ln);
      cn = __ldg(cols + ln);
      tn = __ldg(t + ln);
    }
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxG; ++i) {
      if (i < gk) {
        if (fresh[i]) a = sx[xo[i] + r];
        const float b = sy[i * np + c];
        acc[i] = fmaf(ground_loss_fast<LOSS>(a, b), tl, acc[i]);
      }
    }
    l = ln;
    r = rn;
    c = cn;
    tl = tn;
  }

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kMaxG; ++i) {
    if (i < gk) {
      const float v = warp_sum(acc[i]);
      if (lane == 0) red[w * kMaxG + i] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < gk) {
    float v = 0.f;
    for (int i = 0; i < warps; ++i) v += red[i * kMaxG + threadIdx.x];
    const long long o = out_index(perm, k0 + threadIdx.x);
    out[o] = v + off[o];
  }
}

// ---------------------------------------------------------------------------
// global path
// ---------------------------------------------------------------------------
template <int LOSS>
__global__ void spar_cost_global_kernel(const float* __restrict__ Cx,
                                        long long m,
                                        const float* __restrict__ Cy,
                                        long long n,
                                        const int* __restrict__ rows,
                                        const int* __restrict__ cols,
                                        const float* __restrict__ t,
                                        const float* __restrict__ off,
                                        const int* __restrict__ perm,
                                        float* __restrict__ out, long long s) {
  __shared__ int s_rows[kChunk];
  __shared__ int s_cols[kChunk];
  __shared__ float s_t[kChunk];
  const int lane = threadIdx.x & 31;
  const long long k =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const bool active = k < s;
  const float* xrow = Cx + (active ? (long long)rows[k] * m : 0);
  const float* yrow = Cy + (active ? (long long)cols[k] * n : 0);
  float acc = 0.f;
  for (long long l0 = 0; l0 < s; l0 += kChunk) {
    const int len = (int)(s - l0 < kChunk ? s - l0 : kChunk);
    __syncthreads();  // the previous chunk is consumed by every warp
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      s_rows[i] = rows[l0 + i];
      s_cols[i] = cols[l0 + i];
      s_t[i] = t[l0 + i];
    }
    __syncthreads();
    if (active) {
      for (int i = lane; i < len; i += 32) {
        const float a = __ldg(xrow + s_rows[i]);
        const float b = __ldg(yrow + s_cols[i]);
        acc = fmaf(ground_loss<LOSS>(a, b), s_t[i], acc);
      }
    }
  }
  acc = warp_sum(acc);
  if (active && lane == 0) {
    const long long o = out_index(perm, k);
    out[o] = acc + off[o];
  }
}

// Outputs per block of the rows path for this shape; 0 where one output's
// two rows do not fit in shared memory (the global path runs); -1 if the
// device could not be queried.
int rows_per_block(long long m, long long n, long long s, int threads,
                   size_t* bytes, int* mp, int* np) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  *mp = (int)((m + 3) & ~3LL);   // 16-byte aligned rows
  *np = (int)((n + 3) & ~3LL);
  const long long per = 4LL * (*mp + *np);
  const long long fixed = 4LL * ((threads / 32) * kMaxG + 3 * kMaxG);
  long long G = (limit - fixed) / per;
  if (G > kMaxG) G = kMaxG;
  if (G > s) G = s;
  if (G < 1) return 0;
  *bytes = (size_t)(G * per + fixed);
  return (int)G;
}

template <int LOSS>
int launch(const float* Cx, long long m, const float* Cy, long long n,
           const int* rows, const int* cols, const float* t, const float* off,
           const int* perm, float* out, long long s, int threads,
           cudaStream_t st) {
  size_t bytes = 0;
  int mp = 0, np = 0;
  const int G = rows_per_block(m, n, s, threads, &bytes, &mp, &np);
  if (G < 0) return (int)cudaGetLastError();
  if (G > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        spar_cost_rows_kernel<LOSS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)((s + G - 1) / G);
    spar_cost_rows_kernel<LOSS><<<blocks, threads, bytes, st>>>(
        Cx, m, Cy, n, rows, cols, t, off, perm, out, s, G, mp, np);
  } else {
    const long long per_block = threads / 32;
    const unsigned blocks = (unsigned)((s + per_block - 1) / per_block);
    spar_cost_global_kernel<LOSS><<<blocks, threads, 0, st>>>(
        Cx, m, Cy, n, rows, cols, t, off, perm, out, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Outputs per block of the rows path at this shape, 0 where the global
// path runs, -1 if the device could not be queried.
extern "C" int spar_cost_fused_rows_per_block(long long m, long long n,
                                              long long s, int threads) {
  size_t bytes = 0;
  int mp = 0, np = 0;
  return rows_per_block(m, n, s, threads, &bytes, &mp, &np);
}

// loss: 0 = l1, 1 = l2, 2 = kl. threads: threads per block, a multiple of 32.
// perm: null, or the output position of each support entry. Returns the
// cudaError_t of the launch (0 on success), or cudaErrorInvalidValue for an
// unknown loss.
extern "C" int spar_cost_fused_launch(const float* Cx, long long m,
                                      const float* Cy, long long n,
                                      const int* rows, const int* cols,
                                      const float* t, const float* off,
                                      const int* perm, float* out,
                                      long long s, int loss, int threads,
                                      void* stream) {
  if (s <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (loss) {
    case 0:
      return launch<0>(Cx, m, Cy, n, rows, cols, t, off, perm, out, s,
                       threads, st);
    case 1:
      return launch<1>(Cx, m, Cy, n, rows, cols, t, off, perm, out, s,
                       threads, st);
    case 2:
      return launch<2>(Cx, m, Cy, n, rows, cols, t, off, perm, out, s,
                       threads, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
