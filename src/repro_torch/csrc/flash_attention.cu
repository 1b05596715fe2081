// Causal GQA attention forward (flash attention), float32 or bfloat16 in,
// float32 arithmetic, output in the input's type:
//
//   out[i, s, :] = sum_{t <= s} softmax_t(q[i, s, :] . k[i / G, t, :] / sqrt(hd))
//                  * v[i / G, t, :]
//
// q (BH, S, hd), k and v (BH / G, S, hd), out (BH, S, hd), row-major, with
// BH = batch * heads flattened head-major, so q head i reads kv head i / G.
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention/
// flash_attention.py, body _kernel), the TPU kernel of the LM stack's causal
// attention.
//
// What bounds it on an H100: operations. At zamba2-7b's prefill shape
// (BH = 32, S = 4096, hd = 112) the kernel moves 117 MB (q, k, v, out in
// bf16) but does 4 * BH * hd * S(S+1)/2 = 120 GFLOP: 0.12 ms at the bf16
// tensor-core peak, 1.8 ms at the fp32 peak this kernel computes at. This
// first version runs on the fp32 cores (no mma/wgmma); the tensor cores are
// a later change.
//
// Design. One block of 256 threads owns one (head, tile of 64 query rows)
// and walks the key/value tiles of 64 from the first to the one holding the
// tile's last row: tiles above the diagonal are never loaded. The TPU grid
// carries (m, l, acc) in VMEM scratch across its sequential kv axis; here the
// block's loop carries them in registers. Thread (ty, tx), ty, tx in [0, 16),
// owns query rows 4ty..4ty+3: their running max m and sum l, a 4 x 4 tile of
// scores (keys 4tx..4tx+3 of the current tile) and a 4 x 8 tile of the
// output accumulator (columns tx + 16j). The 16 threads of a row group are
// one half-warp, so the row max and row sum are shuffle reductions.
// Q and K are staged transposed (d-major, rows padded to 68 floats) so a
// thread reads 4 rows or 4 keys as one float4; P goes through shared memory
// transposed for the same reason; V is staged row-major. K and V take turns
// in one buffer, which keeps shared memory at (2 hd + 64) * 68 * 4 bytes
// (87 KB at hd = 128): two blocks per SM. Masked scores are -inf and the
// running max starts at -1e30, so exp never sees inf - inf. Rows and keys
// past S are masked and rows past S never written: a ragged S and a ragged
// last tile in both dimensions are handled in the kernel, nothing is padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kStride = 68;       // padded row of the transposed tiles
constexpr int kThreads = 256;
constexpr int kMaxHd = 128;
constexpr int kAccCols = kMaxHd / 16;
constexpr float kNegInit = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

size_t smem_bytes(int hd) {
  return sizeof(float) * (size_t)(2 * hd + kBK) * kStride;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int S, int hd, int groups, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // Q[q0 + r, d] at d * kStride + r
  float* KV = Qs + hd * kStride;    // K[k0 + c, d] at d * kStride + c, then
                                    // V[k0 + c, d] at c * hd + d
  float* Ps = KV + hd * kStride;    // P[r, c] at c * kStride + r

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y;
  // the heaviest (last) query tiles start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const size_t head = (size_t)S * hd;
  const T* qp = q + bh * head;
  const T* kp = k + (bh / groups) * head;
  const T* vp = v + (bh / groups) * head;

  for (int idx = tid; idx < kBQ * hd; idx += kThreads) {
    const int r = idx / hd, d = idx - r * hd;
    Qs[d * kStride + r] = q0 + r < S ? to_f32(qp[(size_t)(q0 + r) * hd + d])
                                     : 0.f;
  }

  float m[4], l[4], acc[4][kAccCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInit;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kAccCols; ++j) acc[i][j] = 0.f;
  }

  const int last_row = min(q0 + kBQ, S) - 1;
  for (int k0 = 0; k0 <= last_row; k0 += kBK) {
    const int nk = min(kBK, S - k0);
    __syncthreads();  // the last tile's P and V are read
    for (int idx = tid; idx < kBK * hd; idx += kThreads) {
      const int c = idx / hd, d = idx - c * hd;
      KV[d * kStride + c] = c < nk ? to_f32(kp[(size_t)(k0 + c) * hd + d])
                                   : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qs[d * kStride + 4 * ty]);
      const float4 ka = *reinterpret_cast<const float4*>(&KV[d * kStride + 4 * tx]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 4 * tx + j;
        s[i][j] = (col <= row && col < S) ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kAccCols; ++j) acc[i][j] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Ps[(4 * tx + j) * kStride + 4 * ty]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();  // K is read, P is written

    for (int idx = tid; idx < kBK * hd; idx += kThreads) {
      const int c = idx / hd;
      KV[idx] = c < nk ? to_f32(vp[(size_t)k0 * hd + idx]) : 0.f;
    }
    __syncthreads();

    for (int c = 0; c < nk; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(&Ps[c * kStride + 4 * ty]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int j = 0; j < kAccCols; ++j) {
        const int d = tx + 16 * j;
        if (d < hd) {
          const float vv = KV[c * hd + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

  T* op = out + bh * head;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kAccCols; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) store(&op[(size_t)row * hd + d], acc[i][j] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int S, int hd, int groups, cudaStream_t stream) {
  const size_t bytes = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, BH);
  flash_attention_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, hd, groups,
      1.0f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

}  // namespace

// One launch. dtype 0 = float32, 1 = bfloat16. Returns the cudaError_t (0
// on success), cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int BH, int S,
                                      int hd, int groups, int dtype,
                                      void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  if (hd < 1 || hd > kMaxHd || groups < 1 || BH % groups != 0 || BH > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(q, k, v, out, BH, S, hd, groups, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, BH, S, hd, groups, st);
  return (int)cudaErrorInvalidValue;
}
