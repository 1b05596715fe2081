// Materialized-support matvec: out = Lmat @ t + off, float32, Lmat (s, s) row-major.
//
// Replaces spar_matvec_pallas (src/repro/kernels/spar_cost/spar_cost.py, body
// _matvec_kernel), the TPU kernel of the materialized spar_cost mode.
//
// What bounds it on an H100: bytes. Every call reads the whole (s, s) loss
// matrix once and does 2 flops per element, 0.5 flop per byte, far below the
// card's ~20 flop/byte fp32 balance point. At the main path's s = 32768 that
// is 4 GiB per call, 1.28 ms at 3.35 TB/s.
//
// Design: one warp per output row, so a row is one contiguous stream.
// Each lane loads 16 bytes at a time (float4) with the streaming cache hint,
// since Lmat is read once per call and would only evict t from L1/L2. t is
// small (128 KiB at s = 32768) and read through the read-only cache. The sum
// is kept in fp32 per lane, reduced with warp shuffles, and off is added
// once in the epilogue. A ragged s is handled in the kernel: rows of an
// s that is not a multiple of 4 start off a 16-byte boundary, so each row
// takes up to 3 scalar head elements, then float4s, then a scalar tail.
// Nothing is padded: padding would copy the s² matrix.
//
// Lanes: spar_matvec_lanes_launch runs B independent matvecs (B lanes of a
// server flush) in one launch, blockIdx.y being the lane; lane b reads its
// matrix at L + b * lane_stride and its t, off and out at b * s. A lane's row
// is summed exactly as the single-lane launch sums it: the same warp, the same
// head (taken from the row's address), the same order. So a lane's output is
// bitwise that of a single-lane launch on a matrix with the same address mod
// 16 bytes, whatever its mates and whatever B; the lanes' wrapper keeps every
// lane's matrix 16-byte aligned (lane_stride a multiple of 4 floats) for that.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void spar_matvec_kernel(const float* __restrict__ L,
                                   long long lane_stride,
                                   const float* __restrict__ t,
                                   const float* __restrict__ off,
                                   float* __restrict__ out, long long s) {
  const int lane = threadIdx.x & 31;
  const long long k =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (k >= s) return;  // whole warps leave together: k is uniform per warp
  const long long b = blockIdx.y;  // the lane
  L += b * lane_stride;
  t += b * s;
  off += b * s;
  out += b * s;
  const float* row = L + k * s;
  long long head = (long long)(((16u - ((uintptr_t)row & 15u)) & 15u) >> 2);
  if (head > s) head = s;
  float acc = 0.f;
  if (lane < head) acc = row[lane] * __ldg(t + lane);
  const long long n4 = (s - head) >> 2;
  const float4* row4 = reinterpret_cast<const float4*>(row + head);
  const float* th = t + head;
#pragma unroll 4
  for (long long j = lane; j < n4; j += 32) {
    const float4 v = __ldcs(row4 + j);
    const float* tj = th + 4 * j;
    acc = fmaf(v.x, __ldg(tj), acc);
    acc = fmaf(v.y, __ldg(tj + 1), acc);
    acc = fmaf(v.z, __ldg(tj + 2), acc);
    acc = fmaf(v.w, __ldg(tj + 3), acc);
  }
  for (long long l = head + 4 * n4 + lane; l < s; l += 32)
    acc = fmaf(row[l], __ldg(t + l), acc);
  acc = warp_sum(acc);
  if (lane == 0) out[k] = acc + off[k];
}

}  // namespace

// threads: threads per block, a multiple of 32 (one warp per output row);
// lanes: 1 to 65535. Returns the cudaError_t of the launch (0 on success).
extern "C" int spar_matvec_lanes_launch(const float* L, long long lane_stride,
                                        const float* t, const float* off,
                                        float* out, long long s, int lanes,
                                        int threads, void* stream) {
  if (s <= 0 || lanes <= 0) return 0;
  const long long rows_per_block = threads / 32;
  const long long blocks = (s + rows_per_block - 1) / rows_per_block;
  const dim3 grid((unsigned)blocks, (unsigned)lanes);
  spar_matvec_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      L, lane_stride, t, off, out, s);
  return (int)cudaGetLastError();
}

// One matvec: the lanes launch with a single lane.
extern "C" int spar_matvec_launch(const float* L, const float* t,
                                  const float* off, float* out, long long s,
                                  int threads, void* stream) {
  return spar_matvec_lanes_launch(L, s * s, t, off, out, s, 1, threads,
                                  stream);
}
