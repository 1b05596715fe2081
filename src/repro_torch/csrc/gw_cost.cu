// Grid GW cost assembly, float32:
//
//   C[k, m] = sum_{l, p} L(A[k, l], B[m, p]) * T[l, p]
//
// A (K, L), B (M, P), T (L, P) and C (K, M), all row-major, with L one of
// l1 |a-b|, l2 (a-b)^2, kl a*(log max(a,1e-10) - log max(b,1e-10)) - a + b.
//
// Replaces gw_cost_pallas (src/repro/kernels/gw_cost/gw_cost.py, body
// _kernel), the TPU kernel of the grid path's arbitrary-loss cost assembly.
//
// What bounds it on an H100: operations. At the grid main path's 181^4 the
// inputs are three 131 KB matrices and the output one more, but the work is
// K*L*M*P = 1.07e9 loss evaluations. For l1 each is a subtraction and a
// multiply-add on |d|, 4 fp32 operations counting the FMA as 2: 0.064 ms at
// 67 TFLOP/s. |a-b| has no product form, so the tensor cores do not apply.
//
// Design. The TPU grid carries the (l, p) sum in its output block across
// sequential grid steps; CUDA blocks run in no order, so each block owns a
// 16 x 16 tile of outputs and the whole (l, p) reduction of that tile. The
// block walks (l, p) in chunks of 64 x 32 and stages A[k-tile, l-chunk] and
// B[m-tile, p-chunk] transposed, so that a thread reads 4 consecutive k (or m)
// as one float4, and T[l-chunk, p-chunk] with rows padded to 33 floats against
// bank conflicts. Thread (g, s) of the block keeps a 4 x 4 register tile of
// outputs (g in [0, 16)) for one slice of l (l = s, s + S, ... with
// S = blockDim / 16 slices). Per (l, p) a thread reads one T value and one
// float4 of B for 16 loss evaluations, so shared-memory traffic stays well
// under the FMA rate. After the last chunk the S partial sums of each output
// are added in a fixed order in shared memory: no atomics, and the result is
// the same from run to run. For kl the logs of A and B are taken once per
// staged element, not once per pair. Ragged edges are masked when staging
// (zeros for k and m out of range, l cut at L, T = 0 for p beyond P), so
// nothing is padded in device memory.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;        // outputs per block side
constexpr int kCL = 64;          // l per chunk
constexpr int kCP = 32;          // p per chunk
constexpr int kTP = kCP + 1;     // padded row of the staged T
constexpr float kKlEps = 1e-10f; // core/ground_cost._KL_EPS

constexpr int kAs = kCL * kTile;               // staged A (and its logs)
constexpr int kBs = kCP * kTile;               // staged B (and its logs)
constexpr int kTs = kCL * kTP;                 // staged T
constexpr int kSmem = 2 * kAs + 2 * kBs + kTs; // 5184 floats, 20.7 KB
constexpr int kMaxThreads = 256;               // reduction: S*256 <= kSmem
static_assert((kMaxThreads / 16) * kTile * kTile <= kSmem,
              "the reduction reuses the staging buffers");

template <int LOSS>
__device__ __forceinline__ float pair_loss(float a, float la, float b,
                                           float lb) {
  if (LOSS == 0) return fabsf(a - b);
  if (LOSS == 1) {
    const float d = a - b;
    return d * d;
  }
  return a * (la - lb) - a + b;
}

template <int LOSS>
__global__ void __launch_bounds__(kMaxThreads)
    gw_cost_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   const float* __restrict__ T, float* __restrict__ C, int K,
                   int L, int M, int P) {
  __shared__ __align__(16) float smem[kSmem];
  float* As = smem;      // A[k0 + kk, l0 + ll] at ll * kTile + kk
  float* Bs = As + kAs;  // B[m0 + mm, p0 + pp] at pp * kTile + mm
  float* Al = Bs + kBs;  // kl: log max(A, eps), laid out as As
  float* Bl = Al + kAs;  // kl: log max(B, eps), laid out as Bs
  float* Ts = Bl + kBs;  // T[l0 + ll, p0 + pp] at ll * kTP + pp

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int S = nthr >> 4;
  const int g = tid & 15, s = tid >> 4;
  const int gk = (g >> 2) * 4, gm = (g & 3) * 4;
  const int k0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int l0 = 0; l0 < L; l0 += kCL) {
    const int nl = min(kCL, L - l0);
    __syncthreads();  // every thread is done with the previous A chunk
    for (int i = tid; i < kTile * kCL; i += nthr) {
      const int kk = i / kCL, ll = i % kCL, k = k0 + kk;
      const float a = (k < K && ll < nl) ? A[(long long)k * L + l0 + ll] : 0.f;
      As[ll * kTile + kk] = a;
      if (LOSS == 2) Al[ll * kTile + kk] = logf(fmaxf(a, kKlEps));
    }
    for (int p0 = 0; p0 < P; p0 += kCP) {
      const int np = min(kCP, P - p0);
      __syncthreads();  // the previous B/T chunk is consumed
      for (int i = tid; i < kTile * kCP; i += nthr) {
        const int mm = i / kCP, pp = i % kCP, m = m0 + mm;
        const float b = (m < M && pp < np) ? B[(long long)m * P + p0 + pp] : 0.f;
        Bs[pp * kTile + mm] = b;
        if (LOSS == 2) Bl[pp * kTile + mm] = logf(fmaxf(b, kKlEps));
      }
      for (int i = tid; i < kCL * kCP; i += nthr) {
        const int ll = i / kCP, pp = i % kCP;
        Ts[ll * kTP + pp] = (ll < nl && pp < np)
                                ? T[(long long)(l0 + ll) * P + p0 + pp]
                                : 0.f;
      }
      __syncthreads();
      for (int ll = s; ll < nl; ll += S) {
        const float4 a4 = *reinterpret_cast<const float4*>(As + ll * kTile + gk);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        float lav[4] = {0.f, 0.f, 0.f, 0.f};
        if (LOSS == 2) {
          const float4 l4 = *reinterpret_cast<const float4*>(Al + ll * kTile + gk);
          lav[0] = l4.x; lav[1] = l4.y; lav[2] = l4.z; lav[3] = l4.w;
        }
        const float* trow = Ts + ll * kTP;
#pragma unroll 4
        for (int pp = 0; pp < np; ++pp) {
          const float t = trow[pp];
          const float4 b4 = *reinterpret_cast<const float4*>(Bs + pp * kTile + gm);
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
          float lbv[4] = {0.f, 0.f, 0.f, 0.f};
          if (LOSS == 2) {
            const float4 l4 = *reinterpret_cast<const float4*>(Bl + pp * kTile + gm);
            lbv[0] = l4.x; lbv[1] = l4.y; lbv[2] = l4.z; lbv[3] = l4.w;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(pair_loss<LOSS>(av[i], lav[i], bv[j], lbv[j]),
                               t, acc[i][j]);
        }
      }
    }
  }

  // the S partial sums of each output, added in slice order
  __syncthreads();
  float* red = smem;  // [S][kTile][kTile]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[s * kTile * kTile + (gk + i) * kTile + gm + j] = acc[i][j];
  __syncthreads();
  for (int o = tid; o < kTile * kTile; o += nthr) {
    float v = 0.f;
    for (int q = 0; q < S; ++q) v += red[q * kTile * kTile + o];
    const int k = k0 + o / kTile, m = m0 + o % kTile;
    if (k < K && m < M) C[(long long)k * M + m] = v;
  }
}

}  // namespace

// loss: 0 = l1, 1 = l2, 2 = kl. threads: 32, 64, 128 or 256 per block
// (16 output groups x threads/16 slices of l). Returns the cudaError_t of
// the launch (0 on success), or cudaErrorInvalidValue for an unknown loss, a
// thread count the kernel does not take, or an M beyond the grid's y axis.
extern "C" int gw_cost_launch(const float* A, const float* B, const float* T,
                              float* C, int K, int L, int M, int P, int loss,
                              int threads, void* stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  if (K <= 0 || M <= 0) return 0;
  const long long m_tiles = (M + kTile - 1) / kTile;
  if (m_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((K + kTile - 1) / kTile), (unsigned)m_tiles);
  cudaStream_t st = (cudaStream_t)stream;
  switch (loss) {
    case 0:
      gw_cost_kernel<0><<<grid, threads, 0, st>>>(A, B, T, C, K, L, M, P);
      break;
    case 1:
      gw_cost_kernel<1><<<grid, threads, 0, st>>>(A, B, T, C, K, L, M, P);
      break;
    case 2:
      gw_cost_kernel<2><<<grid, threads, 0, st>>>(A, B, T, C, K, L, M, P);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
