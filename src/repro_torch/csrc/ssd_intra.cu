// Mamba2 SSD intra-chunk (diagonal block) output, float32:
//
//   y[g, s, h, :] = sum_{t <= s} (C[g, s, :] . B[g, t, :])
//                   * exp(cs[g, s, h] - cs[g, t, h]) * xdt[g, t, h, :]
//
// xdt (G, k, H, P), cs (G, k, H), B and C (G, k, N), y (G, k, H, P), all
// row-major; G = batch * chunks, k the chunk length (<= 128).
//
// Replaces ssd_intra_pallas (src/repro/kernels/ssd/ssd.py, body _kernel),
// the TPU kernel of the intra-chunk block of models/ssm._ssd_chunked.
//
// What bounds it on an H100: bytes. At zamba2-7b's layer shape (G = 32,
// k = 128, H = 112, P = 64, N = 64) xdt and y are 117 MB each: 0.070 ms at
// 3.35 TB/s, against ~4 GFLOP (0.06 ms at the fp32 peak).
//
// Design. One block of 256 threads owns one chunk g and a tile of 14 heads
// (112 = 8 x 14: one wave of two blocks per SM at zamba2's shape). It forms
// the Gram matrix C B^T once: thread (gy, gx), gx <= gy, keeps the 8 x 8
// tile at rows 8gy.., columns 8gx.. in registers, summed over N in chunks
// of 32 staged transposed in shared memory. Then, head by head:
//   1. stage xdt[g, :, h, :] (rows padded to a multiple of 4 floats) and
//      cs[g, :, h] in shared memory, four 16-byte loads in flight a thread;
//   2. each Gram tile's owner writes its part of the masked decay block
//      M[s, t] = (C B^T)[s, t] * exp(cs_s - cs_t) for t <= s, 0 above, into
//      shared memory transposed (t-major, rows padded to 132 floats): exp
//      is formed once per (s, t) and never for t > s, where it can
//      overflow in float32 (the TPU kernel forms it and masks it with a
//      where);
//   3. thread (row-group pair, 4 columns) computes y for 4 rows x 4
//      columns as a register-tiled product over t <= its last row, first
//      for row group r, then for row group n - 1 - r: every thread sums
//      over about k + 4 values of t, so no warp waits for the chunk's last
//      rows. Per t one 16-byte load of M (2 addresses a warp) and one of
//      xdt (contiguous) feed 16 FMAs; each row's outputs go out as one
//      16-byte store.
// The TPU grid's (k, k, heads) decay block lives in VMEM; here one head's
// (k, k) block at a time lives in shared memory (100 KB a block with the
// staged xdt: two blocks per SM). Ragged N, P, H and k < 128 are masked in
// the kernel; nothing is padded in device memory.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 128;        // chunk length the Gram tiles cover
constexpr int kTs = kMaxK + 4;    // padded row of the transposed tiles
constexpr int kNc = 32;           // N per staged chunk
constexpr int kThreads = 256;
constexpr int kHeadTile = 14;
constexpr int kRows = 4;              // rows of a thread's 4 x 4 outputs
constexpr int kInFlight = 4;          // staged loads in flight per thread

__host__ __device__ int padded_p(int P) { return (P + 3) & ~3; }

__host__ __device__ size_t smem_floats(int k, int P) {
  return (size_t)kMaxK * kTs + (size_t)k * padded_p(P) + kMaxK;
}

// vec: P is a multiple of 4 and xdt and y are 16-byte aligned, so rows are
// read and written in 16-byte pieces
__global__ void __launch_bounds__(kThreads, 2)
    ssd_intra_kernel(const float* __restrict__ xdt, const float* __restrict__ cs,
                     const float* __restrict__ Bm, const float* __restrict__ Cm,
                     float* __restrict__ y, int k, int H, int P, int N,
                     bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* Mt = smem;                       // M[s, t] at t * kTs + s
  const int Pp = padded_p(P);
  float* Xs = Mt + kMaxK * kTs;           // xdt[g, t, h, p] at t * Pp + p
  float* css = Xs + k * Pp;               // cs[g, t, h] at t

  const int tid = threadIdx.x;
  const int g = blockIdx.x;
  const int h0 = blockIdx.y * kHeadTile;

  // -- Gram matrix C B^T: thread (gy, gx) keeps rows 8gy.., columns 8gx.. --
  const int gy = tid >> 4, gx = tid & 15;
  const bool owner = gx <= gy && 8 * gy < k;
  float gram[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) gram[i][j] = 0.f;
  {
    float* Cs = Mt;                 // C[g, s, n0 + n] at n * kTs + s
    float* Bs = Mt + kNc * kTs;     // B[g, t, n0 + n] at n * kTs + t
    const float* cg = Cm + (size_t)g * k * N;
    const float* bg = Bm + (size_t)g * k * N;
    for (int n0 = 0; n0 < N; n0 += kNc) {
      const int nn = min(kNc, N - n0);
      __syncthreads();
      for (int idx = tid; idx < kMaxK * kNc; idx += kThreads) {
        const int s = idx / kNc, n = idx - s * kNc;
        const bool in = s < k && n < nn;
        Cs[n * kTs + s] = in ? cg[(size_t)s * N + n0 + n] : 0.f;
        Bs[n * kTs + s] = in ? bg[(size_t)s * N + n0 + n] : 0.f;
      }
      __syncthreads();
      if (owner) {
        for (int n = 0; n < nn; ++n) {
          const float4 c0 = *reinterpret_cast<const float4*>(&Cs[n * kTs + 8 * gy]);
          const float4 c1 = *reinterpret_cast<const float4*>(&Cs[n * kTs + 8 * gy + 4]);
          const float4 b0 = *reinterpret_cast<const float4*>(&Bs[n * kTs + 8 * gx]);
          const float4 b1 = *reinterpret_cast<const float4*>(&Bs[n * kTs + 8 * gx + 4]);
          const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) gram[i][j] = fmaf(cv[i], bv[j], gram[i][j]);
        }
      }
    }
  }

  // a unit of step 3: 4 columns of row groups rg and n_rg - 1 - rg, so
  // every unit sums over about k + 4 values of t
  const int n_rg = (k + kRows - 1) / kRows;
  const int n_cg = Pp / 4;
  const int n_units = (n_rg + 1) / 2 * n_cg;
  for (int h = h0; h < min(h0 + kHeadTile, H); ++h) {
    __syncthreads();  // the last head's M and xdt (or the Gram staging) are read

    // -- 1. stage xdt[g, :, h, :] and cs[g, :, h] ---------------------------
    const int q = Pp / 4;                 // 16-byte pieces of a staged row
    for (int base = tid; base < k * q; base += kThreads * kInFlight) {
      float4 piece[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int idx = base + u * kThreads;
        piece[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (idx < k * q) {
          const int t = idx / q, p = 4 * (idx - t * q);
          const float* src = xdt + (((size_t)g * k + t) * H + h) * P + p;
          if (vec) {
            if (p < P) piece[u] = *reinterpret_cast<const float4*>(src);
          } else {
            float v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] = p + e < P ? src[e] : 0.f;
            piece[u] = make_float4(v[0], v[1], v[2], v[3]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int idx = base + u * kThreads;
        if (idx < k * q) reinterpret_cast<float4*>(Xs)[idx] = piece[u];
      }
    }
    for (int t = tid; t < k; t += kThreads)
      css[t] = cs[((size_t)g * k + t) * H + h];
    __syncthreads();

    // -- 2. masked decay block, t-major -----------------------------------
    if (owner) {
      float cs_s[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        cs_s[i] = 8 * gy + i < k ? css[8 * gy + i] : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = 8 * gx + j;
        const float cs_t = t < k ? css[t] : 0.f;
        float m[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int s = 8 * gy + i;
          m[i] = (t <= s && s < k) ? gram[i][j] * expf(cs_s[i] - cs_t) : 0.f;
        }
        *reinterpret_cast<float4*>(&Mt[t * kTs + 8 * gy]) =
            make_float4(m[0], m[1], m[2], m[3]);
        *reinterpret_cast<float4*>(&Mt[t * kTs + 8 * gy + 4]) =
            make_float4(m[4], m[5], m[6], m[7]);
      }
    }
    __syncthreads();

    // -- 3. y[s, p] = sum_{t <= s} M[s, t] xdt[t, p] --------------------------
    for (int unit = tid; unit < n_units; unit += kThreads) {
      const int pair = unit / n_cg, p0 = (unit % n_cg) * 4;
#pragma unroll 1
      for (int side = 0; side < 2; ++side) {
        const int rg = side ? n_rg - 1 - pair : pair;
        if (side && rg == pair) break;
        const int s0 = kRows * rg;
        float acc[kRows][4];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
        const int t_end = min(s0 + kRows, k);
#pragma unroll 2
        for (int t = 0; t < t_end; ++t) {
          const float4 mv = *reinterpret_cast<const float4*>(&Mt[t * kTs + s0]);
          const float4 xv = *reinterpret_cast<const float4*>(&Xs[t * Pp + p0]);
          const float mr[kRows] = {mv.x, mv.y, mv.z, mv.w};
          const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(mr[i], xr[c], acc[i][c]);
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int s = s0 + i;
          if (s >= k) continue;
          float* dst = y + (((size_t)g * k + s) * H + h) * P + p0;
          if (vec && p0 + 4 <= P) {
            *reinterpret_cast<float4*>(dst) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (p0 + c < P) dst[c] = acc[i][c];
          }
        }
      }
    }
  }
}

}  // namespace

// One launch. Returns the cudaError_t (0 on success), cudaErrorInvalidValue
// for a shape the kernel does not take (k > 128), and the attribute call's
// error when P needs more shared memory than the card gives a block.
extern "C" int ssd_intra_launch(const float* xdt, const float* cs,
                                const float* Bm, const float* Cm, float* y,
                                int G, int k, int H, int P, int N,
                                void* stream) {
  if (G <= 0 || k <= 0 || H <= 0 || P <= 0) return 0;
  if (k > kMaxK || N < 0 || (H + kHeadTile - 1) / kHeadTile > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * smem_floats(k, P);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_intra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const bool vec = (P & 3) == 0 && ((size_t)xdt & 15) == 0 &&
                   ((size_t)y & 15) == 0;
  const dim3 grid(G, (H + kHeadTile - 1) / kHeadTile);
  ssd_intra_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      xdt, cs, Bm, Cm, y, k, H, P, N, vec);
  return (int)cudaGetLastError();
}
