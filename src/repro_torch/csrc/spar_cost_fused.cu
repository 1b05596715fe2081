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
// (k, l) pair reads two floats at data-dependent addresses. The TPU kernel
// keeps the (bk, m) and (bk, n) row panels Cx[rows], Cy[cols] resident in
// VMEM; here those panels are s*(m+n)*4 bytes (512 MiB at n = 2048) and a
// (bk, m) block does not fit in shared memory. Cx and Cy together are
// (m^2 + n^2)*4 bytes, 32 MiB at n = 2048, which fits in the 50 MB L2.
//
// Design: one warp per output row k, blockDim/32 rows per block. The block
// stages chunks of rows[l], cols[l], t[l] in shared memory, shared by its
// warps; each lane walks l with stride 32 and reads Cx[rows_k, rows_l] and
// Cy[cols_k, cols_l] straight from device memory through the read-only path,
// where a warp's row of Cx (m floats) and of Cy stay in L1 and the whole
// matrices in L2. fp32 accumulation per lane, warp-shuffle reduction, off
// added in the epilogue. The ragged tail of l is masked by the chunk length,
// and rows k >= s do no work but still take part in the block's barriers.
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 2048;

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
__global__ void spar_cost_fused_kernel(const float* __restrict__ Cx, long long m,
                                       const float* __restrict__ Cy, long long n,
                                       const int* __restrict__ rows,
                                       const int* __restrict__ cols,
                                       const float* __restrict__ t,
                                       const float* __restrict__ off,
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
  if (active && lane == 0) out[k] = acc + off[k];
}

}  // namespace

// loss: 0 = l1, 1 = l2, 2 = kl. threads: threads per block, a multiple of 32.
// Returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue for an unknown loss.
extern "C" int spar_cost_fused_launch(const float* Cx, long long m,
                                      const float* Cy, long long n,
                                      const int* rows, const int* cols,
                                      const float* t, const float* off,
                                      float* out, long long s, int loss,
                                      int threads, void* stream) {
  if (s <= 0) return 0;
  const long long rows_per_block = threads / 32;
  const unsigned blocks = (unsigned)((s + rows_per_block - 1) / rows_per_block);
  cudaStream_t st = (cudaStream_t)stream;
  switch (loss) {
    case 0:
      spar_cost_fused_kernel<0><<<blocks, threads, 0, st>>>(Cx, m, Cy, n, rows,
                                                            cols, t, off, out, s);
      break;
    case 1:
      spar_cost_fused_kernel<1><<<blocks, threads, 0, st>>>(Cx, m, Cy, n, rows,
                                                            cols, t, off, out, s);
      break;
    case 2:
      spar_cost_fused_kernel<2><<<blocks, threads, 0, st>>>(Cx, m, Cy, n, rows,
                                                            cols, t, off, out, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
