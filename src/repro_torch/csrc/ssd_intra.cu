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
// 3.35 TB/s, against ~4 GFLOP (0.06 ms at the fp32 SIMT peak, so the
// products run on the tensor cores and the loads overlap them).
//
// Design. One block of 256 threads (8 warps) owns one chunk g and a tile of
// 14 heads (112 = 8 x 14: 256 blocks, two a SM, one wave on 132 SMs).
//   1. Gram matrix C B^T, once a block, on the tensor cores: C and B are
//      staged in chunks of 32 of N; each warp computes whole 16 x 16 blocks
//      of the lower triangle (36 blocks, t-block <= s-block) with
//      mma.sync m16n8k8 TF32 and stores them, unmasked, in shared memory in
//      the order of the A-operand fragments of step 3 (one float4 a thread
//      per 8 columns, no bank conflicts).
//   2. The block's units (head h, 64 columns of P) stream through a
//      two-stage ring: cp.async copies xdt[g, :, h, p0 : p0 + 64] and
//      cs[g, :, h] of unit u + 1 while unit u computes. Rows are padded to
//      72 floats, so the B-operand reads below hit 32 banks. Two load
//      routes, chosen by shape and alignment: 16-byte copies when P is a
//      multiple of 4 and xdt is 16-byte aligned, else 4-byte copies; both
//      zero-fill rows t >= k and columns past P.
//   3. y = M xdt with M[s, t] = G[s, t] exp(cs_s - cs_t) for t <= s, 0
//      above, on the tensor cores. The masked decay block is never stored:
//      each warp builds it straight into its A-operand fragments from the
//      stored Gram fragments and cs, and forms exp only where t <= s (the
//      TPU kernel forms it everywhere and masks it; above the diagonal it
//      can overflow). Warp w takes the 16-row tiles r = w % 4 and 7 - r
//      (2(r + 1) + 2(8 - r) = 18 k-steps of 8 for every warp) and 32 of the
//      64 columns; tiles above the diagonal are skipped, not computed. The
//      B fragments of xdt are shared by the warp's two row tiles, and each
//      of the three passes of a k-step runs over the 4 column tiles before
//      the next, so no accumulator waits on its own last product.
// Accuracy: both products use the 3xTF32 split, a = a_hi + a_lo with a_hi
// and a_lo rounded to TF32 (to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds finite values, in two integer instructions),
// a.b ~ a_hi b_lo + a_lo b_hi + a_hi b_hi: each product is within
// ~3 * 2^-22 = 12 * 2^-24 of |a||b| (the dropped a_lo b_lo and the rounding
// of the two lo parts). The three mma of a k-step (8 terms) sum into a fresh
// partial, which an fp32 add then puts into the running sum: a running sum
// kept inside the mma accumulators rounds less well than an fp32 add and
// came out farther from a float64 evaluation than the plain fp32 version
// (chip_smoke.py prints both distances). Plain single-pass TF32 (2^-11 a
// product) would not hold the float32 reference's accuracy.
// Ragged N, P, H and k < 128 are masked in the kernel; nothing is padded in
// device memory. No atomics: the same inputs give the same bits every run.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 128;        // chunk length the row tiles cover
constexpr int kThreads = 256;
constexpr int kHeadTile = 14;
constexpr int kPT = 64;           // columns of P a unit covers
constexpr int kXr = kPT + 8;      // padded row of a staged xdt tile
constexpr int kNc = 32;           // N per staged chunk of C and B
constexpr int kCr = kNc + 4;      // padded row of staged C and B
constexpr int kGramBlocks = 36;   // 16 x 16 blocks with t-block <= s-block
constexpr int kGf = kGramBlocks * 256;   // Gram fragments
constexpr int kXs = kMaxK * kXr;         // one stage of xdt
constexpr int kSmemFloats = kGf + 2 * kXs + 2 * kMaxK;
static_assert(2 * kMaxK * kCr <= kXs, "C and B stage in one xdt stage");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// asynchronous copies; ok == false writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
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

// x rounded to TF32 (10 bits of mantissa), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 rounds a finite x; two integer instructions
// where cvt.rna takes four (it also tests for inf and NaN)
__device__ __forceinline__ unsigned to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

// vec: P is a multiple of 4 and xdt is 16-byte aligned (16-byte copies,
// ssd_intra_load_route); vec2: P is even (8-byte stores: y is the
// wrapper's own allocation, so it starts on a 256-byte boundary)
__global__ void __launch_bounds__(kThreads, 2)
    ssd_intra_kernel(const float* __restrict__ xdt, const float* __restrict__ cs,
                     const float* __restrict__ Bm, const float* __restrict__ Cm,
                     float* __restrict__ y, int k, int H, int P, int N,
                     bool vec, bool vec2) {
  extern __shared__ __align__(16) float smem[];
  float* Gf = smem;                 // Gram fragments, [block][kstep][lane][4]
  float* Xs = Gf + kGf;             // [2][kMaxK][kXr]
  float* css = Xs + 2 * kXs;        // [2][kMaxK]

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, q = lane & 3;   // fragment row group, column
  const int g = blockIdx.x;
  const int h0 = blockIdx.y * kHeadTile;
  const int n_heads = min(kHeadTile, H - h0);
  const int n_pt = (P + kPT - 1) / kPT;
  const int n_units = n_heads * n_pt;
  const int kr = (k + 7) & ~7;              // rows the k-steps cover

  // -- unit u: xdt[g, :, h, p0 : p0 + 64] and cs[g, :, h] into stage u & 1 --
  auto issue = [&](int u) {
    const int h = h0 + u / n_pt, p0 = (u % n_pt) * kPT;
    float* xs = Xs + (u & 1) * kXs;
    const float* src = xdt + ((size_t)g * k * H + h) * P + p0;
    const size_t row = (size_t)H * P;       // stride of t
    if (vec) {
      for (int i = tid; i < kr * (kPT / 4); i += kThreads) {
        const int t = i >> 4, c = (i & 15) * 4;
        const bool ok = t < k && p0 + c < P;
        cp_async16(xs + t * kXr + c, ok ? src + t * row + c : xdt, ok);
      }
    } else {
      for (int i = tid; i < kr * kPT; i += kThreads) {
        const int t = i >> 6, c = i & 63;
        const bool ok = t < k && p0 + c < P;
        cp_async4(xs + t * kXr + c, ok ? src + t * row + c : xdt, ok);
      }
    }
    if (tid < kr)
      cp_async4(css + (u & 1) * kMaxK + tid,
                tid < k ? cs + ((size_t)g * k + tid) * H + h : cs, tid < k);
  };

  issue(0);
  cp_async_commit();

  // -- 1. Gram blocks b = w, w + 8, ... of the lower triangle ---------------
  {
    float gacc[5][2][4];
#pragma unroll
    for (int e = 0; e < 5; ++e)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int c = 0; c < 4; ++c) gacc[e][jj][c] = 0.f;
    float* Cs = Xs + kXs;                   // stage 1: C[s, n0 + n]
    float* Bs = Cs + kMaxK * kCr;           //          B[t, n0 + n]
    const float* cg = Cm + (size_t)g * k * N;
    const float* bg = Bm + (size_t)g * k * N;
    for (int n0 = 0; n0 < N; n0 += kNc) {
      const int nn = min(kNc, N - n0);
      __syncthreads();
      for (int i = tid; i < kMaxK * kNc; i += kThreads) {
        const int s = i >> 5, n = i & 31;
        const bool in = s < k && n < nn;
        Cs[s * kCr + n] = in ? cg[(size_t)s * N + n0 + n] : 0.f;
        Bs[s * kCr + n] = in ? bg[(size_t)s * N + n0 + n] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < 5; ++e) {
        const int b = w + 8 * e;
        if (b >= kGramBlocks) break;
        int i = 0;                          // b = tri(i) + j, j <= i
        while (tri(i + 1) <= b) ++i;
        const int j = b - tri(i);
        if (16 * i >= k) continue;          // rows past the chunk stay 0
        for (int ks = 0; ks < (nn + 7) / 8; ++ks) {
          const float* ca = Cs + (16 * i + gr) * kCr + 8 * ks + q;
          unsigned ahi[4], alo[4];
          split(ca[0], ahi[0], alo[0]);
          split(ca[8 * kCr], ahi[1], alo[1]);
          split(ca[4], ahi[2], alo[2]);
          split(ca[8 * kCr + 4], ahi[3], alo[3]);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const float* bb = Bs + (16 * j + 8 * jj + gr) * kCr + 8 * ks + q;
            unsigned bh0, bl0, bh1, bl1;
            split(bb[0], bh0, bl0);
            split(bb[4], bh1, bl1);
            float part[4] = {0.f, 0.f, 0.f, 0.f};  // 3xTF32, as in step 3
            mma(part, alo, bh0, bh1);
            mma(part, ahi, bl0, bl1);
            mma(part, ahi, bh0, bh1);
#pragma unroll
            for (int c = 0; c < 4; ++c) gacc[e][jj][c] += part[c];
          }
        }
      }
    }
    // accumulator (row gr (+8), columns 8jj + 2q, +1) -> A-fragment order:
    // element (r, c) of a block at ((c / 8) * 32 + (r % 8) * 4 + c % 4) * 4
    //                                + r / 8 + 2 * ((c % 8) / 4)
#pragma unroll
    for (int e = 0; e < 5; ++e) {
      const int b = w + 8 * e;
      if (b >= kGramBlocks) break;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = gr + 8 * (c >> 1), col = 2 * q + (c & 1);
          Gf[b * 256 + (jj * 32 + (r & 7) * 4 + (col & 3)) * 4 + (r >> 3) +
             2 * (col >> 2)] = gacc[e][jj][c];
        }
    }
  }
  __syncthreads();                          // Gram stored, stage 1 free
  if (n_units > 1) issue(1);
  cp_async_commit();

  // -- 3. y for each unit ---------------------------------------------------
  const int r_lo = w & 3, r_hi = 7 - r_lo;  // this warp's row tiles
  const int c0 = (w >> 2) * 32;             // and its 32 columns of 64
  const int n_ks_max = kr / 8;
  const int ks_hi = 16 * r_hi < k ? min(2 * (r_hi + 1), n_ks_max) : 0;
  const int ks_lo = 16 * r_lo < k ? min(2 * (r_lo + 1), n_ks_max) : 0;
  const int ks_end = max(ks_hi, ks_lo);

  for (int u = 0; u < n_units; ++u) {
    cp_async_wait_one();                    // unit u has landed (this thread)
    __syncthreads();                        // ... every thread's
    const float* xs = Xs + (u & 1) * kXs;
    const float* cst = css + (u & 1) * kMaxK;
    const int h = h0 + u / n_pt, p0 = (u % n_pt) * kPT;

    float cs_s[2][2];                       // [row tile][row gr, gr + 8]
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int rt = a ? r_hi : r_lo;
      cs_s[a][0] = cst[16 * rt + gr];
      cs_s[a][1] = cst[16 * rt + gr + 8];
    }

    float acc[2][4][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][n][c] = 0.f;

    for (int ks = 0; ks < ks_end; ++ks) {
      // B fragments of xdt: rows 8ks + q (+4), columns c0 + 8n + gr
      unsigned bh[4][2], bl[4][2];
      const float* xb = xs + (8 * ks + q) * kXr + c0 + gr;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        split(xb[8 * n], bh[n][0], bl[n][0]);
        split(xb[4 * kXr + 8 * n], bh[n][1], bl[n][1]);
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int rt = a ? r_hi : r_lo;
        if (ks >= (a ? ks_hi : ks_lo)) continue;
        // A fragment of M: G[s, t] exp(cs_s - cs_t) for rows s0 (+8),
        // columns t0 (+4); exp only where t <= s
        const float4 gv = reinterpret_cast<const float4*>(
            Gf)[((tri(rt) + (ks >> 1)) * 2 + (ks & 1)) * 32 + lane];
        const int s0 = 16 * rt + gr, t0 = 8 * ks + q;
        const float ct0 = cst[t0], ct1 = cst[t0 + 4];
        float4 mv;
        if ((ks >> 1) < rt) {               // below the diagonal: t < s
          mv.x = gv.x * expf(cs_s[a][0] - ct0);
          mv.y = gv.y * expf(cs_s[a][1] - ct0);
          mv.z = gv.z * expf(cs_s[a][0] - ct1);
          mv.w = gv.w * expf(cs_s[a][1] - ct1);
        } else {                            // the diagonal block: exp(-inf)
          mv.x = gv.x * expf(t0 <= s0 ? cs_s[a][0] - ct0 : -INFINITY);
          mv.y = gv.y * expf(t0 <= s0 + 8 ? cs_s[a][1] - ct0 : -INFINITY);
          mv.z = gv.z * expf(t0 + 4 <= s0 ? cs_s[a][0] - ct1 : -INFINITY);
          mv.w = gv.w * expf(t0 + 4 <= s0 + 8 ? cs_s[a][1] - ct1 : -INFINITY);
        }
        unsigned ahi[4], alo[4];
        split(mv.x, ahi[0], alo[0]);
        split(mv.y, ahi[1], alo[1]);
        split(mv.z, ahi[2], alo[2]);
        split(mv.w, ahi[3], alo[3]);
        // 3xTF32 into a fresh partial sum of this k-step, one pass over the
        // 4 column tiles at a time (no accumulator waits on its own last
        // product), then added to the running sum by an fp32 add
        float part[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) part[n][c] = 0.f;
#pragma unroll
        for (int n = 0; n < 4; ++n) mma(part[n], alo, bh[n][0], bh[n][1]);
#pragma unroll
        for (int n = 0; n < 4; ++n) mma(part[n], ahi, bl[n][0], bl[n][1]);
#pragma unroll
        for (int n = 0; n < 4; ++n) mma(part[n], ahi, bh[n][0], bh[n][1]);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][n][c] += part[n][c];
      }
    }

    // y rows 16rt + gr (+8), columns p0 + c0 + 8n + 2q (+1)
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int rt = a ? r_hi : r_lo;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int s = 16 * rt + gr + 8 * half;
        if (s >= k) continue;
        float* dst = y + (((size_t)g * k + s) * H + h) * P;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int p = p0 + c0 + 8 * n + 2 * q;
          const float v0 = acc[a][n][2 * half], v1 = acc[a][n][2 * half + 1];
          if (vec2) {
            if (p < P) *reinterpret_cast<float2*>(dst + p) = make_float2(v0, v1);
          } else {
            if (p < P) dst[p] = v0;
            if (p + 1 < P) dst[p + 1] = v1;
          }
        }
      }
    }

    __syncthreads();                        // stage u & 1 is consumed
    if (u + 2 < n_units) issue(u + 2);
    cp_async_commit();
  }
}

}  // namespace

// The load route the launcher takes for xdt: 1 for 16-byte copies (P a
// multiple of 4 and xdt 16-byte aligned), 0 for 4-byte copies.
extern "C" int ssd_intra_load_route(const float* xdt, int P) {
  return (P & 3) == 0 && ((size_t)xdt & 15) == 0;
}

// One launch; y must start on an 8-byte boundary. Returns the cudaError_t
// (0 on success), or cudaErrorInvalidValue for a shape the kernel does not
// take (k > 128).
extern "C" int ssd_intra_launch(const float* xdt, const float* cs,
                                const float* Bm, const float* Cm, float* y,
                                int G, int k, int H, int P, int N,
                                void* stream) {
  if (G <= 0 || k <= 0 || H <= 0 || P <= 0) return 0;
  if (k > kMaxK || N < 0 || (H + kHeadTile - 1) / kHeadTile > 65535)
    return (int)cudaErrorInvalidValue;
  const int bytes = (int)sizeof(float) * kSmemFloats;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_intra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_intra_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const bool vec = ssd_intra_load_route(xdt, P) != 0;
  const bool vec2 = (P & 1) == 0;
  const dim3 grid(G, (H + kHeadTile - 1) / kHeadTile);
  ssd_intra_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      xdt, cs, Bm, Cm, y, k, H, P, N, vec, vec2);
  return (int)cudaGetLastError();
}
