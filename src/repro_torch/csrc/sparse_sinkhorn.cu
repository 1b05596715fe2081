// Sparse log-domain Sinkhorn half-step (K7), float32:
//
//   out_i = _finite(lmarg_i - lse_{e in segment i}(lv_e + pot[idx_e]))
//
// over the segments of a COO support made contiguous: segment i holds
// entries off[i] .. off[i+1]-1, lv and idx in that order. With the support
// sorted by row (lv, cols, row offsets) it is the update of f from g; sorted
// by column (lv, rows, column offsets), the update of g from f.
//
// Replaces no TPU kernel: the reference's sparse Sinkhorn is plain jnp
// segment ops (src/repro/core/sinkhorn.py, sparse_sinkhorn_logdomain). On the
// card its plain version (core/sinkhorn.py, segment_logsumexp) is ~32 small
// kernels a half-step, so a solve's 1000 iterations were paced by the host
// launching them. This kernel is one launch a half-step.
//
// What bounds it on an H100: launch latency. A half-step at s = 131072 needs
// 8 bytes an entry (lv, idx), 12 a segment (off, lmarg, out) and the gathered
// potential once: ~1.2 MB, ~0.35 us of HBM bandwidth; the second pass over lv
// and idx and the potential's repeated reads come from L1/L2.
//
// Design: a fixed group of G lanes (a power of two up to the warp, chosen by
// the wrapper from the mean segment length) reduces one segment. Lane k of
// the group takes entries off[i] + k, + k + G, ...; the group takes the
// maximum (NaN propagating, as torch's amax), then the sum of
// exp(x - max) in that fixed order, each closed by a shuffle butterfly over
// the group. No atomics: a segment's result depends on its own entries and G
// alone, never on where it sits in the grid, so the results are the same
// from run to run, and a lane of a server flush (a segment space of B·m rows,
// lane b's offset by b·m) is bitwise its single-lane solve at the same G.
//
// The branches are the plain version's, one for one: an empty segment gives
// _NEG_INF; a maximum <= _NEG_INF/2 is replaced by 0 (maxs_safe); the sum's
// log is log_floor's (-inf below the smallest normal, subnormals flushed);
// sums > 0 else _NEG_INF; then _finite. expf and logf, not the fast
// intrinsics, and no fast-math: the plain version's exp and log on the card
// are these functions, so the two differ only in the order of the sum.
//
// Indices out of range trap, as torch's index kernels assert on the card.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;        // core/utils.py's NEG_INF
constexpr float kHalfNegInf = kNegInf * 0.5f;
constexpr float kFltMin = 1.17549435e-38f;  // smallest normal float32
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

template <int G>
__global__ void sparse_sinkhorn_half_kernel(
    const int* __restrict__ off, const float* __restrict__ lv,
    const int* __restrict__ idx, const float* __restrict__ pot,
    const float* __restrict__ lmarg, float* __restrict__ out,
    float* __restrict__ lse_out, long long num, long long s,
    long long other) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long seg = t / G;
  const int k = (int)(t & (G - 1));
  if (t == 0 && (off[0] != 0 || off[num] != s)) __trap();  // keys in range
  // every lane of the warp reaches the shuffles: a group past the last
  // segment reduces an empty range
  long long lo = 0, hi = 0;
  if (seg < num) {
    lo = off[seg];
    hi = off[seg + 1];
  }
  float mx = -INFINITY;
  for (long long e = lo + k; e < hi; e += G) {
    const int j = idx[e];
    if ((unsigned long long)(long long)j >= (unsigned long long)other) __trap();
    mx = nan_max(mx, lv[e] + __ldg(pot + j));
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    mx = nan_max(mx, __shfl_xor_sync(kFull, mx, o));
  const float ms = mx > kHalfNegInf ? mx : 0.f;  // maxs_safe
  float acc = 0.f;
  for (long long e = lo + k; e < hi; e += G)
    acc += expf((lv[e] + __ldg(pot + idx[e])) - ms);
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
  if (k != 0 || seg >= num) return;
  const float lf = acc < kFltMin ? -INFINITY : logf(acc);  // log_floor
  const float lse = acc > 0.f ? lf + ms : kNegInf;
  const float v = lmarg[seg] - lse;
  out[seg] = (isfinite(v) && v > kHalfNegInf) ? v : 0.f;  // _finite
  if (lse_out != nullptr) lse_out[seg] = lse;
}

template <int G>
cudaError_t launch(const int* off, const float* lv, const int* idx,
                   const float* pot, const float* lmarg, float* out,
                   float* lse, long long num, long long s, long long other,
                   int threads, cudaStream_t stream) {
  const long long blocks = (num * G + threads - 1) / threads;
  sparse_sinkhorn_half_kernel<G><<<(unsigned)blocks, threads, 0, stream>>>(
      off, lv, idx, pot, lmarg, out, lse, num, s, other);
  return cudaGetLastError();
}

}  // namespace

// One half-step over num segments of a support of s entries whose gathered
// index runs over [0, other). off (num + 1) int32 segment starts, lv and idx
// (s) in segment order, pot (other), lmarg and out (num); lse (num) or null:
// where given, each segment's logsumexp as the update used it (_NEG_INF for
// an empty one), for the backward. group: lanes a segment, 1 to 32, a power
// of two; threads: a multiple of 32, at most 1024. Returns the cudaError_t
// of the launch (0 on success); 1 (cudaErrorInvalidValue) for a group or
// threads it does not take.
extern "C" int sparse_sinkhorn_half_launch(const int* off, const float* lv,
                                           const int* idx, const float* pot,
                                           const float* lmarg, float* out,
                                           float* lse, long long num,
                                           long long s, long long other,
                                           int group, int threads,
                                           void* stream) {
  if (num <= 0) return 0;
  if (threads <= 0 || threads % 32 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (group) {
    case 1: return (int)launch<1>(off, lv, idx, pot, lmarg, out, lse, num, s, other, threads, st);
    case 2: return (int)launch<2>(off, lv, idx, pot, lmarg, out, lse, num, s, other, threads, st);
    case 4: return (int)launch<4>(off, lv, idx, pot, lmarg, out, lse, num, s, other, threads, st);
    case 8: return (int)launch<8>(off, lv, idx, pot, lmarg, out, lse, num, s, other, threads, st);
    case 16: return (int)launch<16>(off, lv, idx, pot, lmarg, out, lse, num, s, other, threads, st);
    case 32: return (int)launch<32>(off, lv, idx, pot, lmarg, out, lse, num, s, other, threads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
