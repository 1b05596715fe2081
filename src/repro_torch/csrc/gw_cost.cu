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
// K*L*M*P = 1.07e9 loss evaluations. For l1 each is one FADD (a - b) and one
// FFMA on |a - b| (the abs is an operand modifier of the FFMA): 4 fp32
// operations counting the FMA as 2, 0.064 ms at 67 TFLOP/s. |a-b| has no
// product form, so the tensor cores do not apply.
//
// Design. The TPU grid carries the (l, p) sum in its output block across
// sequential grid steps; here the sum is split three ways so that every SM
// gets the same work and no sum needs atomics:
//   - over blocks: a block owns a 32 x 32 output tile and one of S ranges of
//     l (S from gw_cost_splits: the split count that deals the tiles x S
//     blocks most evenly over the card's SMs, 11 at 181^4 on 132 SMs: 396
//     blocks, 3 a SM). Each block writes its partial tile to a workspace
//     (S x K x M floats) and a second small kernel adds the S partials of
//     each output in split order; with S = 1 the block writes C itself;
//   - over the warps of a block: warp w takes the w-th of threads/32 ranges
//     of p, and the warps' partial tiles are added in warp order in shared
//     memory at the end;
//   - a thread keeps 8 k x 4 m outputs in registers: per (l, p) one float4
//     of B and one (broadcast) T value feed 32 loss evaluations.
// B is staged once per chunk of 192 p, transposed (m fastest) with rows
// padded to 36 floats, so that both the staging stores (a warp covers 8 p x
// 4 m, read as 4 rows of 32 bytes) and the float4 reads are free of bank
// conflicts; for kl its logs are staged beside it. A and T are staged in
// chunks of at most 16 l (a block's range cut into near-equal chunks) by
// cp.async into two buffers: the next chunk loads while the current one is
// used. Ragged edges are masked when staging (zeros for k and m out of
// range; l and p loops stop at L and P), so nothing is
// padded in device memory. Every sum runs in a fixed order: the same inputs
// give the same bits on every run on a card.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;         // outputs per block side
constexpr int kCL = 16;           // most l per staged chunk of A and T
constexpr int kCP = 192;          // p per staged chunk of B and T
constexpr int kMaxThreads = 256;  // 8 warps: 8 ranges of p
constexpr int kMaxSplits = 64;
constexpr float kKlEps = 1e-10f;  // core/ground_cost._KL_EPS

constexpr int kBr = kTile + 4;          // padded row of the staged B
constexpr int kBs = kCP * kBr;          // staged B (and, for kl, its logs)
constexpr int kAs = kCL * kTile;        // one buffer of staged A
constexpr int kTs = kCL * kCP;          // one buffer of staged T
constexpr int kRed = (kMaxThreads / 32) * kTile * kTile;

__host__ __device__ constexpr int smem_floats(bool kl) {
  return (kl ? 2 : 1) * kBs + 2 * kAs + 2 * kTs > kRed
             ? (kl ? 2 : 1) * kBs + 2 * kAs + 2 * kTs
             : kRed;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 4-byte asynchronous copy; ok == false writes a zero and reads nothing
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

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
    gw_cost_partial(const float* __restrict__ A, const float* __restrict__ B,
                    const float* __restrict__ T, float* __restrict__ out,
                    int K, int L, int M, int P, int tiles_m) {
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;                                 // [kCP][kBr]
  float* Bl = Bs + kBs;                             // kl: log max(B, eps)
  float* As = smem + (LOSS == 2 ? 2 : 1) * kBs;     // [2][kCL][32]
  float* Ts = As + 2 * kAs;                         // [2][kCL][kCP]

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warps = nthr >> 5, w = tid >> 5, lane = tid & 31;
  const int gk = lane >> 3, gm = lane & 7;          // rows 8gk.., cols 4gm..
  const int k0 = (blockIdx.x / tiles_m) * kTile;
  const int m0 = (blockIdx.x % tiles_m) * kTile;
  const int S = gridDim.y, split = blockIdx.y;
  const int l_lo = (int)((long long)L * split / S);
  const int l_hi = (int)((long long)L * (split + 1) / S);
  // the block's l range in n_chunks chunks of near-equal length <= kCL
  const int n_chunks = (l_hi - l_lo + kCL - 1) / kCL;
  auto chunk_lo = [&](int c) {
    return l_lo + (l_hi - l_lo) * c / max(n_chunks, 1);
  };

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int p0 = 0; p0 < P; p0 += kCP) {
    const int np = min(kCP, P - p0);
    // -- B[m-tile, p-chunk], transposed (plain loads) ---------------------
    __syncthreads();  // the previous chunk's B is consumed
    for (int q = w; q < 8 * ((np + 7) / 8); q += warps) {
      const int m = (q & 7) * 4 + (lane >> 3), p = (q >> 3) * 8 + (lane & 7);
      const bool in = m0 + m < M && p < np;
      const float b = in ? B[(long long)(m0 + m) * P + p0 + p] : 0.f;
      Bs[p * kBr + m] = b;
      if (LOSS == 2) Bl[p * kBr + m] = logf(fmaxf(b, kKlEps));
    }
    // this warp's range of p within the chunk
    const int p_lo = np * w / warps, p_hi = np * (w + 1) / warps;

    // -- A and T in chunks of kCL l, two buffers filled by cp.async -------
    auto issue = [&](int c) {
      const int l0 = chunk_lo(c), nl = chunk_lo(c + 1) - l0;
      float* as = As + (c & 1) * kAs;
      float* ts = Ts + (c & 1) * kTs;
      for (int i = tid; i < kCL * kTile; i += nthr) {
        const int l = i >> 5, k = i & 31;           // consecutive k per warp
        const bool in = l < nl && k0 + k < K;
        cp_async4(as + i, in ? A + (long long)(k0 + k) * L + l0 + l : A, in);
      }
      for (int i = tid; i < nl * np; i += nthr) {
        const int l = i / np, p = i - l * np;
        cp_async4(ts + l * kCP + p, T + (long long)(l0 + l) * P + p0 + p,
                  true);
      }
    };
    if (n_chunks > 0) issue(0);
    cp_async_commit();
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks) issue(c + 1);
      cp_async_commit();
      cp_async_wait_one();       // chunk c has landed (this thread's part)
      __syncthreads();           // ... and every thread's, and B
      const int nl = chunk_lo(c + 1) - chunk_lo(c);
      const float* as = As + (c & 1) * kAs;
      const float* ts = Ts + (c & 1) * kTs;
      for (int l = 0; l < nl; ++l) {
        const float4 a0 = *reinterpret_cast<const float4*>(as + l * kTile + 8 * gk);
        const float4 a1 = *reinterpret_cast<const float4*>(as + l * kTile + 8 * gk + 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float la[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          la[i] = LOSS == 2 ? logf(fmaxf(av[i], kKlEps)) : 0.f;
        const float* trow = ts + l * kCP;
#pragma unroll 4
        for (int p = p_lo; p < p_hi; ++p) {
          const float t = trow[p];
          const int bi = p * kBr + 4 * gm;
          const float4 b4 = *reinterpret_cast<const float4*>(Bs + bi);
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
          float lb[4] = {0.f, 0.f, 0.f, 0.f};
          if (LOSS == 2) {
            const float4 l4 = *reinterpret_cast<const float4*>(Bl + bi);
            lb[0] = l4.x; lb[1] = l4.y; lb[2] = l4.z; lb[3] = l4.w;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(pair_loss<LOSS>(av[i], la[i], bv[j], lb[j]),
                               t, acc[i][j]);
        }
      }
      __syncthreads();           // buffer c & 1 is free for chunk c + 2
    }
  }

  // -- the warps' partial tiles, added in warp order ------------------------
  __syncthreads();
  float* red = smem;  // [warps][32][32]
#pragma unroll
  for (int i = 0; i < 8; ++i)
    *reinterpret_cast<float4*>(red + w * kTile * kTile +
                               (8 * gk + i) * kTile + 4 * gm) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  float* dst = out + (long long)split * K * M;
  for (int o = tid; o < kTile * kTile; o += nthr) {
    float v = red[o];
    for (int q = 1; q < warps; ++q) v += red[q * kTile * kTile + o];
    const int k = k0 + o / kTile, m = m0 + o % kTile;
    if (k < K && m < M) dst[(long long)k * M + m] = v;
  }
}

// C[o] = sum over s of ws[s][o], in split order
__global__ void gw_cost_sum_splits(const float* __restrict__ ws,
                                   float* __restrict__ C, long long n,
                                   int S) {
  for (long long o = blockIdx.x * (long long)blockDim.x + threadIdx.x; o < n;
       o += (long long)gridDim.x * blockDim.x) {
    float v = ws[o];
    for (int s = 1; s < S; ++s) v += ws[s * n + o];
    C[o] = v;
  }
}

template <int LOSS>
cudaError_t launch_partial(dim3 grid, int threads, cudaStream_t st,
                           const float* A, const float* B, const float* T,
                           float* out, int K, int L, int M, int P,
                           int tiles_m) {
  const int bytes = (int)sizeof(float) * smem_floats(LOSS == 2);
  cudaError_t err = cudaFuncSetAttribute(
      gw_cost_partial<LOSS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  gw_cost_partial<LOSS><<<grid, threads, bytes, st>>>(A, B, T, out, K, L, M,
                                                      P, tiles_m);
  return cudaGetLastError();
}

long long tiles(int K, int M) {
  return (long long)((K + kTile - 1) / kTile) * ((M + kTile - 1) / kTile);
}

}  // namespace

// The number of l ranges S a launch at this shape splits the sum into on the
// current device: the S in [1, min(L, 64)] whose tiles x S blocks, dealt
// evenly over the SMs, give the least work to the busiest SM,
// ceil(tiles·S / SMs) blocks of ceil(L / S) l each plus about one l's worth
// of staging and reduction a block; the largest such S on a tie (more warps
// a SM). 11 at 181^4 on 132 SMs. The wrapper sizes the workspace from it.
extern "C" int gw_cost_splits(int K, int L, int M) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms <= 0)
    return -1;
  const long long nt = tiles(K, M);
  int best = 1;
  long long best_cost = -1;
  for (int S = 1; S <= kMaxSplits && S <= L; ++S) {
    const long long cost = (nt * S + sms - 1) / sms * ((L + S - 1) / S + 1);
    if (best_cost < 0 || cost <= best_cost) best = S, best_cost = cost;
  }
  return best;
}

// loss: 0 = l1, 1 = l2, 2 = kl. threads: 32, 64, 128 or 256 per block (one
// warp per range of p). splits: S from gw_cost_splits; with S > 1, ws holds
// S x K x M floats of partial sums and a second kernel adds them into C.
// Returns the cudaError_t of the launches (0 on success), or
// cudaErrorInvalidValue for an unknown loss, a thread count the kernel does
// not take, or a split count out of range.
extern "C" int gw_cost_launch(const float* A, const float* B, const float* T,
                              float* C, float* ws, int K, int L, int M, int P,
                              int loss, int threads, int splits,
                              void* stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 || loss < 0 ||
      loss > 2 || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && (splits > L || ws == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (K <= 0 || M <= 0) return 0;
  const long long nt = tiles(K, M);
  if (nt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nt, (unsigned)splits);
  const int tiles_m = (M + kTile - 1) / kTile;
  cudaStream_t st = (cudaStream_t)stream;
  float* out = splits > 1 ? ws : C;
  cudaError_t err =
      loss == 0 ? launch_partial<0>(grid, threads, st, A, B, T, out, K, L, M, P, tiles_m)
      : loss == 1 ? launch_partial<1>(grid, threads, st, A, B, T, out, K, L, M, P, tiles_m)
                  : launch_partial<2>(grid, threads, st, A, B, T, out, K, L, M, P, tiles_m);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long n = (long long)K * M;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  gw_cost_sum_splits<<<blocks, 256, 0, st>>>(ws, C, n, splits);
  return (int)cudaGetLastError();
}
