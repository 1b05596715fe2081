// Plain-domain Sinkhorn scaling on a dense kernel matrix, float32:
//
//   u = a / (K v),  v = b / (K^T u)   (0 where the denominator is <= 0),
//   H times from v = 1, then T = diag(u) K diag(v).
//
// Replaces sinkhorn_pallas (src/repro/kernels/sinkhorn/sinkhorn.py, body
// _kernel), which keeps K resident in VMEM for all H iterations.
//
// Subnormals are flushed exactly where the plain version
// (kernels/sinkhorn/ref.py, the dense core loop) flushes them, reproducing
// XLA's flush in the reference: K, a and b on input, every product K_ij x_j
// inside a matvec, the inputs and the result of each division, and both
// products of the final coupling. The flush is written out (flush()), not
// left to -ftz, so this source builds with the same flags as the others.
//
// What bounds it on an H100: neither bytes nor operations. The function
// reads K once and writes T once (2*m*n*4 bytes) and does 4*m*n*H operations
// (two matvecs per iteration): at the grid path's 181 x 181, H = 50, that is
// 0.26 MB and 6.6 MFLOP, well under a microsecond at 3.35 TB/s or
// 67 TFLOP/s. What rules is latency: 2H dependent half-steps, each a
// reduction followed by a barrier.
//
// Design, two kernels, one launch per call either way:
//
// * sinkhorn_resident_kernel: one block of 1024 threads holds K in shared
//   memory for all H iterations, like the TPU kernel holds it in VMEM, with a
//   __syncthreads() between half-steps. Row half-step: one warp per row,
//   lanes stride over the columns, a shuffle tree adds the lanes. Column
//   half-step: 8 row groups x 32 columns per warp write partial column sums,
//   which a second pass adds in row-group order. It takes K while
//   4*(m*n + m + 9n) bytes fit in a block's shared memory (227 KB on the
//   H100: 138 KB at 181 x 181).
// * sinkhorn_grid_kernel: for larger K. One block cannot hold it, and one SM
//   alone would stream it from L2 2H times. So a cooperative grid of 256-
//   thread blocks reads K through L2 (an 8 MiB K, the TPU kernel's VMEM
//   budget, sits easily in the 50 MB L2) with a grid-wide barrier between
//   half-steps; u and v live in device memory. The row half-step is one warp
//   per row; the column half-step gives each block 32 columns, its 8 warps
//   stride over the rows and the block adds their partials in warp order.
//   It takes every size, so the wrapper needs no fallback.
//
// Every sum is taken in a fixed order in both kernels (no atomics), so the
// result is the same from run to run and from one grid size to another.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kResidentThreads = 1024;
constexpr int kRowGroups = 8;  // column half-step: row groups per column
constexpr int kGridThreads = 256;
constexpr float kFltMin = 1.17549435e-38f;  // smallest normal float32

__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < kFltMin ? 0.f : x;  // NaN passes, as in the plain version
}

__device__ __forceinline__ float safe_div(float num, float den) {
  num = flush(num);
  den = flush(den);
  return den > 0.f ? flush(num / den) : 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kResidentThreads)
    sinkhorn_resident_kernel(const float* __restrict__ a,
                             const float* __restrict__ b,
                             const float* __restrict__ K,
                             float* __restrict__ T, int m, int n, int iters) {
  extern __shared__ float smem[];
  float* Ks = smem;                // (m, n)
  float* us = Ks + m * n;          // (m,)
  float* vs = us + m;              // (n,)
  float* part = vs + n;            // (kRowGroups, n)
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int mn = m * n;

  for (int i = tid; i < mn; i += nthr) Ks[i] = flush(K[i]);
  for (int i = tid; i < m; i += nthr) us[i] = 1.f;
  for (int j = tid; j < n; j += nthr) vs[j] = 1.f;
  __syncthreads();

  const int col_tiles = nwarps / kRowGroups;  // 32-column tiles in flight
  const int grp = warp % kRowGroups, tile = warp / kRowGroups;
  for (int it = 0; it < iters; ++it) {
    for (int i = warp; i < m; i += nwarps) {  // u = a / (K v)
      const float* row = Ks + i * n;
      float acc = 0.f;
      for (int j = lane; j < n; j += 32) acc += flush(row[j] * vs[j]);
      acc = warp_sum(acc);
      if (lane == 0) us[i] = safe_div(a[i], acc);
    }
    __syncthreads();
    for (int j0 = tile * 32; j0 < n; j0 += col_tiles * 32) {  // K^T u
      const int j = j0 + lane;
      if (j < n) {
        float acc = 0.f;
        for (int i = grp; i < m; i += kRowGroups)
          acc += flush(Ks[i * n + j] * us[i]);
        part[grp * n + j] = acc;
      }
    }
    __syncthreads();
    for (int j = tid; j < n; j += nthr) {  // v = b / (K^T u)
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kRowGroups; ++q) acc += part[q * n + j];
      vs[j] = safe_div(b[j], acc);
    }
    __syncthreads();
  }
  for (int i = tid; i < mn; i += nthr) {
    const int r = i / n, c = i - r * n;
    T[i] = flush(flush(us[r] * Ks[i]) * vs[c]);
  }
}

// u and v are written by other blocks between barriers: plain loads, never
// the read-only path.
__global__ void __launch_bounds__(kGridThreads)
    sinkhorn_grid_kernel(const float* __restrict__ a,
                         const float* __restrict__ b,
                         const float* __restrict__ K, float* __restrict__ T,
                         float* u, float* v, long long m, long long n,
                         int iters) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float part[kGridThreads / 32][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = kGridThreads / 32;
  const long long gwarp = (long long)blockIdx.x * wpb + warp;
  const long long nwarps = (long long)gridDim.x * wpb;
  const long long tiles = (n + 31) / 32;

  for (int it = 0; it < iters; ++it) {
    for (long long i = gwarp; i < m; i += nwarps) {  // u = a / (K v)
      const float* row = K + i * n;
      float acc = 0.f;
      for (long long j = lane; j < n; j += 32)
        acc += flush(flush(__ldg(row + j)) * v[j]);
      acc = warp_sum(acc);
      if (lane == 0) u[i] = safe_div(a[i], acc);
    }
    grid.sync();
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {  // K^T u
      const long long j = t * 32 + lane;
      float acc = 0.f;
      if (j < n)
        for (long long i = warp; i < m; i += wpb)
          acc += flush(flush(__ldg(K + i * n + j)) * u[i]);
      part[warp][lane] = acc;
      __syncthreads();
      if (warp == 0 && j < n) {
        float tot = 0.f;
#pragma unroll
        for (int q = 0; q < wpb; ++q) tot += part[q][lane];
        v[j] = safe_div(b[j], tot);
      }
      __syncthreads();  // part is reused by the next tile
    }
    grid.sync();
  }
  const long long mn = m * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += stride) {
    const long long r = i / n, c = i - r * n;
    T[i] = flush(flush(u[r] * flush(__ldg(K + i))) * v[c]);
  }
}

}  // namespace

// Largest dynamic shared memory one block of the resident kernel may use on
// `device`, in bytes (the opt-in limit, 232448 on the H100), or -1.
extern "C" long long sinkhorn_resident_max_bytes(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return bytes;
}

// Shared memory the resident kernel needs for an (m, n) K, in bytes.
extern "C" long long sinkhorn_resident_bytes(long long m, long long n) {
  return 4 * (m * n + m + n + (long long)kRowGroups * n);
}

// One launch of the resident kernel. Returns the cudaError_t (0 on
// success), cudaErrorInvalidValue when K does not fit in shared memory.
extern "C" int sinkhorn_resident_launch(const float* a, const float* b,
                                        const float* K, float* T, int m, int n,
                                        int iters, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const long long bytes = sinkhorn_resident_bytes(m, n);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (bytes > sinkhorn_resident_max_bytes(dev))
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(sinkhorn_resident_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  sinkhorn_resident_kernel<<<1, kResidentThreads, (size_t)bytes,
                             (cudaStream_t)stream>>>(a, b, K, T, m, n, iters);
  return (int)cudaGetLastError();
}

// One cooperative launch of the grid kernel; u (m,) and v (n,) must hold
// ones. The grid is as large as can be resident at once (the
// cooperative launch refuses more), capped by the rows' and columns' work.
// Returns the cudaError_t (0 on success).
extern "C" int sinkhorn_grid_launch(const float* a, const float* b,
                                    const float* K, float* T, float* u,
                                    float* v, long long m, long long n,
                                    int iters, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sinkhorn_grid_kernel, kGridThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const long long wpb = kGridThreads / 32;
  long long want = (m + wpb - 1) / wpb;         // one warp per row
  const long long tiles = (n + 31) / 32;        // one block per column tile
  if (tiles > want) want = tiles;
  long long blocks = (long long)sms * per_sm;
  if (want < blocks) blocks = want;
  if (blocks < 1) blocks = 1;
  void* args[] = {(void*)&a, (void*)&b, (void*)&K, (void*)&T,
                  (void*)&u, (void*)&v, (void*)&m, (void*)&n, (void*)&iters};
  err = cudaLaunchCooperativeKernel((void*)sinkhorn_grid_kernel,
                                    dim3((unsigned)blocks),
                                    dim3(kGridThreads), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
