// Causal GQA attention forward (flash attention), float32 or bfloat16 in,
// float32 accumulation, output in the input's type:
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
// tensor-core peak.
//
// Two kernels, chosen by the inputs' dtype in the launcher (a dispatch on
// the type, not a fallback: each dtype has exactly one kernel).
//
// bfloat16 (the LM main path): the tensor cores, through wgmma. A block of
// two consumer warpgroups and one producer warp owns one (head, tile of 128
// query rows); each warpgroup owns 64 of the rows and walks the key/value
// tiles of 64 up to the one holding its last row, so tiles above the
// diagonal are never loaded, and the heaviest query tiles start first.
// Per tile:
//   S = Q K^T   wgmma m64n64k16, A = Q and B = K both from shared memory,
//               K-major, hd/16 steps, fp32 accumulators in registers;
//   online softmax on the accumulator fragment in registers (m, l fp32;
//               a row's 64 scores sit in the 4 lanes of a quad, so the row
//               max is two shuffles); masked scores are -inf against a
//               -1e30 running max, so exp never sees inf - inf;
//   O += P V    wgmma m64n{hd}k16 with P rounded to bf16 as the A operand
//               in registers (the S fragment's layout is the A fragment's)
//               and V the MN-major ("transposed") B operand in shared
//               memory, 4 steps of 16 keys.
// l sums the fp32 p, so the only new rounding is bf16(p) in the product:
// at most 2^-9 of sum_t p_st |v_t| per output.
// Loads: the producer warp fills a four-stage K/V ring with TMA (one box
// per tile, from a 4-D view of the tensor whose box lands in the layout
// below; it zero-fills rows past S and columns past hd) and signals a
// "full" mbarrier per stage; each consumer warp releases a stage on its
// "empty" mbarrier once its products have read it. No block-wide barrier follows the first, so
// the two warpgroups drift apart and one's softmax overlaps the other's
// products; inside a warpgroup, S of tile j+1 is issued before the softmax
// of tile j and runs under it. The tensor maps are encoded on the host
// through the driver entry point the runtime hands out (no link against
// libcuda).
// Tiles live in shared memory in the no-swizzle core-matrix layout (8 rows
// x 16 bytes per 128-byte core matrix, column-major over 16-byte columns),
// which takes any hd that is a multiple of 8 (zamba2-7b's 224-byte rows of
// hd = 112 do not tile the 128-byte swizzle atom). hd is zero-padded in
// shared memory to a multiple of 16, the wgmma depth (no padding at 64,
// 112 or 128; at most 8 columns of extra work). An hd that is not a
// multiple of 8, or a base pointer not 16-byte aligned, cannot be described
// to TMA: there the producer warp stores the tiles itself. Rows past S are
// never written.
//
// float32 (the full-width fp32 forward check and tests, on no main path):
// the fp32 SIMT kernel of the first port, unchanged (a TF32 tensor-core
// path would change fp32 results). One block of 256 threads owns one
// (head, tile of 64 query rows); thread (ty, tx) owns 4 rows' m, l, a 4 x 4
// score tile and a 4 x 8 output tile in registers; Q, K, P staged
// transposed for float4 reads.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

// ---------------------------------------------------------------------------
// float32: SIMT kernel
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kStride = 68;       // padded row of the transposed tiles
constexpr int kThreads = 256;
constexpr int kMaxHd = 128;
constexpr int kAccCols = kMaxHd / 16;
constexpr float kNegInit = -1e30f;

size_t smem_bytes(int hd) {
  return sizeof(float) * (size_t)(2 * hd + kBK) * kStride;
}

__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_f32(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
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
  const float* qp = q + bh * head;
  const float* kp = k + (bh / groups) * head;
  const float* vp = v + (bh / groups) * head;

  for (int idx = tid; idx < kBQ * hd; idx += kThreads) {
    const int r = idx / hd, d = idx - r * hd;
    Qs[d * kStride + r] = q0 + r < S ? qp[(size_t)(q0 + r) * hd + d]
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
      KV[d * kStride + c] = c < nk ? kp[(size_t)(k0 + c) * hd + d]
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
      KV[idx] = c < nk ? vp[(size_t)k0 * hd + idx] : 0.f;
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

  float* op = out + bh * head;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kAccCols; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) op[(size_t)row * hd + d] = acc[i][j] / denom;
    }
  }
}


}  // namespace simt

// ---------------------------------------------------------------------------
// bfloat16: wgmma kernel
// ---------------------------------------------------------------------------
namespace hopper {

constexpr int kRows = 64;                 // query rows per warpgroup
constexpr int kGroups = 2;                // consumer warpgroups per block
constexpr int kBQ = kRows * kGroups;      // query rows per block
constexpr int kBK = 64;                   // keys per tile
constexpr int kStages = 4;                // K/V ring depth
constexpr int kConsumers = 128 * kGroups;
constexpr int kThreads = kConsumers + 32; // + one producer warp
constexpr float kNegInit = -1e30f;

// A tile of 64 rows x HDP columns: 16-byte chunk c of row r at byte
// c * 1024 + r * 16. Each chunk column is 8 core matrices (8 rows x 16 bytes)
// stacked along the rows; it is what one TMA box of 8 columns x 64 rows
// writes.
template <int HDP>
__host__ __device__ constexpr int tile_bytes() {
  return kBK * HDP * 2;
}

template <int HDP>
constexpr size_t smem_bytes() {   // Q (kGroups tiles), K and V rings, barriers
  return (size_t)(kGroups + 2 * kStages) * tile_bytes<HDP>() +
         8 * (1 + 2 * kStages);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// wgmma shared-memory descriptor, no swizzle: start address, leading byte
// offset and stride byte offset, in 16-byte units. For a K-major operand
// LBO steps between core matrices along K and SBO between 8-row groups
// along M/N; for an MN-major one LBO steps along K, SBO along N.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// spin until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// one tile of a (8, S, hd / 8, heads) tensor map (see make_map): rows
// [y, y + 64) of head z into shared memory, completing on the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int y, int z, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(y), "r"(0), "r"(z),
      "r"(bar)
      : "memory");
}
// make this thread's generic-proxy shared-memory stores visible to the
// async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// ties accumulator registers to the asm stream, so the compiler neither
// reads them before wgmma.wait_group nor writes them after wgmma issues
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

#define FA_ACC8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// S (64 x 64, fp32) = A (64 x 16) . B (64 x 16)^T, A and B bf16 K-major in
// shared memory; scale_d = 0 overwrites d, 1 adds to it.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_ACC8(0), FA_ACC8(8), FA_ACC8(16), FA_ACC8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N, fp32) += A (64 x 16, bf16 in registers) . B (16 x N), B bf16
// MN-major in shared memory (imm-trans-b = 1). One specialisation per N.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : FA_ACC8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : FA_ACC8(0), FA_ACC8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : FA_ACC8(0), FA_ACC8(8), FA_ACC8(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_ACC8(0), FA_ACC8(8), FA_ACC8(16), FA_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : FA_ACC8(0), FA_ACC8(8), FA_ACC8(16), FA_ACC8(24),
        FA_ACC8(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : FA_ACC8(0), FA_ACC8(8), FA_ACC8(16), FA_ACC8(24),
        FA_ACC8(32), FA_ACC8(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<112>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : FA_ACC8(0), FA_ACC8(8), FA_ACC8(16), FA_ACC8(24),
        FA_ACC8(32), FA_ACC8(40), FA_ACC8(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FA_ACC8(0), FA_ACC8(8), FA_ACC8(16), FA_ACC8(24),
        FA_ACC8(32), FA_ACC8(40), FA_ACC8(48), FA_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef FA_ACC8

// The block's mbarriers, 8 bytes each: q_full at bars, then full[st] (the
// tile of stage st has arrived), then empty[st] (the 8 consumer warps are
// done with it).
__device__ __forceinline__ uint32_t full_bar(uint32_t bars, int st) {
  return bars + 8 * (1 + st);
}
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int st) {
  return bars + 8 * (1 + kStages + st);
}

__device__ __forceinline__ float ex2(float x) {   // 2^x, flushes subnormals
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// every wait is for all groups: ptxas then sees which accumulators are
// settled, and does not serialize the products
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// What a consumer warpgroup's thread needs to multiply a tile.
struct Consumer {
  uint64_t dq;            // descriptor of the warpgroup's Q tile
  uint32_t ks, vs;        // shared addresses of the K and V rings
  uint32_t bars;          // the barriers (see flash_attention_bf16)
  int row0, ra, rb, quad_col, lane, S;
  float scale_log2;
};

// S = Q K^T of the tile in stage st into s (issued, not waited for).
// Q and K: K-major, LBO = one 16-byte column (1024 bytes), SBO = one 8-row
// group (128 bytes); a step of 16 columns moves 2048 bytes.
template <int HDP>
__device__ __forceinline__ void issue_scores(float* s, const Consumer& c,
                                             int st) {
  const uint64_t dk =
      make_desc(c.ks + st * tile_bytes<HDP>(), 1024, 128);
  // no register fence here: it would define s while PV_{j-1} runs (the
  // wgmma's own "+f" operands keep earlier reads of s before it)
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk)
    wgmma_ss_n64(s, c.dq + kk * 128, dk + kk * 128, kk > 0);
  wgmma_commit();
}

// Tile j of nj: sc holds its raw scores S_j, PV_{j-1} may be in flight.
// Issues S_{j+1} into sn first, so the tensor cores compute it and
// PV_{j-1} while this thread runs the softmax of S_j; then waits for both
// (releasing tile j-1's stage), rescales O and issues PV_j, and returns
// with S_{j+1} complete and PV_j in flight. The last tile issues a product
// on its own stage all the same, whose result goes unused: a wgmma issued
// under a condition leaves ptxas a join of accumulators in flight, which
// it answers by serializing every wgmma.
template <int HDP>
__device__ __forceinline__ void attend(float* sc, float* sn, float* o,
                                       float& ma, float& mb, float& la,
                                       float& lb, int j, int nj,
                                       const Consumer& c) {
  constexpr int kAcc = HDP / 2;
  const bool next = j + 1 < nj;
  if (next) mbar_wait(full_bar(c.bars, (j + 1) % kStages),
                      ((j + 1) / kStages) & 1);
  issue_scores<HDP>(sn, c, (j + next) % kStages);

  // sc[i] is (row i & 2 ? rb : ra, key k0 + (i / 4) * 8 + quad_col + i % 2)
  const int k0 = j * kBK;
  const bool mask = k0 + kBK - 1 > c.row0 || k0 + kBK > c.S;
  float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (mask) {
      const int col = k0 + (i >> 2) * 8 + c.quad_col + (i & 1);
      if (col > ((i & 2) ? c.rb : c.ra) || col >= c.S) sc[i] = -INFINITY;
    }
    if (i & 2) mxb = fmaxf(mxb, sc[i]);
    else mxa = fmaxf(mxa, sc[i]);
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, off));
    mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, off));
  }
  // running maxima in units of log2: scores times scale * log2(e)
  const float na = fmaxf(ma, mxa * c.scale_log2);
  const float nb = fmaxf(mb, mxb * c.scale_log2);
  const float ca = ex2(ma - na), cb = ex2(mb - nb);
  ma = na;
  mb = nb;
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float p = ex2(fmaf(sc[i], c.scale_log2, (i & 2) ? -nb : -na));
    sc[i] = p;
    if (i & 2) sb += p;
    else sa += p;
  }
  la = la * ca + sa;
  lb = lb * cb + sb;

  wgmma_wait();   // PV_{j-1} and S_{j+1}
  fence_regs<kAcc>(o);
  fence_regs<32>(sn);
  if (j > 0 && c.lane == 0) mbar_arrive(empty_bar(c.bars, (j - 1) % kStages));
#pragma unroll
  for (int i = 0; i < kAcc; ++i) o[i] *= (i & 2) ? cb : ca;

  // P as four bf16 A fragments of 16 keys: regs {(ra, k), (rb, k),
  // (ra, k + 8), (rb, k + 8)} with k = 16 kk + quad_col
  uint32_t pa[16];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[4 * kk + 0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[4 * kk + 1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[4 * kk + 2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[4 * kk + 3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
  // V: MN-major B (N = hd, K = keys), LBO = one 8-key group (128 bytes),
  // SBO = one 16-byte column of hd (1024 bytes); 16 keys move 256 bytes
  const uint64_t dv =
      make_desc(c.vs + (j % kStages) * tile_bytes<HDP>(), 128, 1024);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<HDP>(o, pa + 4 * kk, dv + kk * 16);
  wgmma_commit();
}

// The producer warp fills one 64-row tile (rows [r0, r0 + 64) of one head)
// and completes its share of the barrier. vec: one TMA box, issued by lane
// 0 (the box zero-fills rows past S and columns past hd; the barrier
// expects 2 tiles' bytes per K/V stage, set by the caller).
// Otherwise (hd not a multiple of 8, or an unaligned base) every lane
// stores its elements and arrives (32 arrivals per tile).
template <int HDP>
__device__ __forceinline__ void fill_tile(unsigned char* tile,
                                          const CUtensorMap* map,
                                          const __nv_bfloat16* src, int r0,
                                          int head, int S, int hd, bool vec,
                                          uint32_t bar) {
  const int lane = threadIdx.x & 31;
  if (vec) {
    if (lane == 0) tma_load(smem_addr(tile), map, r0, head, bar);
    return;
  }
  const __nv_bfloat16* hp = src + (size_t)head * S * hd;
  for (int i = lane; i < kBK * HDP; i += 32) {
    const int r = i / HDP, d = i - r * HDP;
    const __nv_bfloat16 x = r0 + r < S && d < hd
                                ? hp[(size_t)(r0 + r) * hd + d]
                                : __float2bfloat16(0.f);
    *reinterpret_cast<__nv_bfloat16*>(tile + (d >> 3) * 1024 + r * 16 +
                                      (d & 7) * 2) = x;
  }
  fence_proxy_async();
  mbar_arrive(bar);
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bf16(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ out, int S, int hd,
                         int groups, float scale_log2, int vec) {
  constexpr int kTile = tile_bytes<HDP>();
  constexpr int kAcc = HDP / 2;           // output accumulators per thread
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Qs = smem;                          // kGroups tiles
  unsigned char* Ks = Qs + kGroups * kTile;          // kStages tiles
  unsigned char* Vs = Ks + kStages * kTile;          // kStages tiles
  const uint32_t bars = smem_addr(Vs + kStages * kTile);
  const uint32_t q_full = bars;                      // Q has arrived

  const int bh = blockIdx.y, kvh = bh / groups;
  // the heaviest (last) query tiles start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int n_tiles = (min(q0 + kBQ, S) - 1) / kBK + 1;

  if (threadIdx.x == 0) {
    // TMA: the producer's one expect_tx arrival, the bytes complete the
    // phase; plain stores: 32 lanes arrive once per tile filled, and each
    // barrier covers two tiles (the two Q tiles, or K and V)
    static_assert(kGroups == 2, "q_full covers kGroups tiles");
    const int arrivals = vec ? 1 : 2 * 32;
    mbar_init(q_full, arrivals);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_bar(bars, st), arrivals);
      mbar_init(empty_bar(bars, st), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer warp: Q once, then K/V tile j into stage j % kStages as soon
    // as the consumers have released that stage's previous tile
    const bool lead = vec && (threadIdx.x & 31) == 0;
    if (lead) mbar_expect_tx(q_full, kGroups * kTile);
    for (int g = 0; g < kGroups; ++g)
      fill_tile<HDP>(Qs + g * kTile, &tq, q, q0 + g * kRows, bh, S, hd, vec,
                     q_full);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages, use = j / kStages;
      const uint32_t bar = full_bar(bars, st);
      if (use > 0) mbar_wait(empty_bar(bars, st), (use - 1) & 1);
      if (lead) mbar_expect_tx(bar, 2 * kTile);
      fill_tile<HDP>(Ks + st * kTile, &tk, k, j * kBK, kvh, S, hd, vec, bar);
      fill_tile<HDP>(Vs + st * kTile, &tv, v, j * kBK, kvh, S, hd, vec, bar);
    }
    return;
  }

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  Consumer c;
  c.row0 = q0 + wg * kRows;                    // the warpgroup's first row
  c.lane = threadIdx.x & 31;
  c.ra = c.row0 + warp * 16 + (c.lane >> 2);   // the thread's two rows
  c.rb = c.ra + 8;
  c.quad_col = (c.lane & 3) * 2;
  c.S = S;
  c.scale_log2 = scale_log2;
  c.dq = make_desc(smem_addr(Qs + wg * kTile), 1024, 128);
  c.ks = smem_addr(Ks);
  c.vs = smem_addr(Vs);
  c.bars = bars;
  // tiles this warpgroup multiplies: up to its last row. The first
  // warpgroup skips at most the block's last tile, whose release nobody
  // waits for, so it does not arrive for it.
  const int nj = (min(c.row0 + kRows, S) - 1) / kBK + 1;

  float o[kAcc], sA[32], sB[32];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sA[i] = sB[i] = 0.f;
  float ma = kNegInit, mb = kNegInit, la = 0.f, lb = 0.f;

  mbar_wait(q_full, 0);
  mbar_wait(full_bar(bars, 0), 0);
  issue_scores<HDP>(sA, c, 0);
  wgmma_wait();
  fence_regs<32>(sA);
  for (int j = 0; j + 1 < nj; j += 2) {  // sA and sB take turns
    attend<HDP>(sA, sB, o, ma, mb, la, lb, j, nj, c);
    attend<HDP>(sB, sA, o, ma, mb, la, lb, j + 1, nj, c);
  }
  if (nj & 1) {   // each branch retires its products before the join
    attend<HDP>(sA, sB, o, ma, mb, la, lb, nj - 1, nj, c);
    wgmma_wait();
  } else {
    wgmma_wait();
  }
  fence_regs<kAcc>(o);

  const int ra = c.ra, rb = c.rb, quad_col = c.quad_col;

  // the row sums are split over the quad's 4 lanes
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    la += __shfl_xor_sync(0xffffffffu, la, off);
    lb += __shfl_xor_sync(0xffffffffu, lb, off);
  }
  const float ia = 1.f / fmaxf(la, 1e-30f), ib = 1.f / fmaxf(lb, 1e-30f);
  __nv_bfloat16* op = out + (size_t)bh * S * hd;
  const bool pairs = (hd & 1) == 0;
#pragma unroll
  for (int i = 0; i < kAcc; i += 2) {
    const int col = (i >> 2) * 8 + quad_col;
    const int row = (i & 2) ? rb : ra;
    const float inv = (i & 2) ? ib : ia;
    if (row >= S || col >= hd) continue;
    __nv_bfloat16* dst = op + (size_t)row * hd + col;
    if (pairs) {
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(o[i] * inv, o[i + 1] * inv);
    } else {
      dst[0] = __float2bfloat16(o[i] * inv);
      if (col + 1 < hd) dst[1] = __float2bfloat16(o[i + 1] * inv);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (the
// library links only the CUDA runtime)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (heads, S, hd) bf16 tensor seen as (8, S, hd / 8, heads): the 8
// columns of a 16-byte chunk, the rows, the chunks (16 bytes apart) and the
// heads. One box of (8, 64, HDP / 8, 1) lands in shared memory chunk by
// chunk, 64 rows x 16 bytes each: the tile layout the kernel reads.
bool make_map(CUtensorMap* map, const void* base, int hd, int S, int heads,
              int hdp) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {8, (cuuint64_t)S, (cuuint64_t)hd / 8,
                              (cuuint64_t)heads};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, 16,
                                 (cuuint64_t)hd * 2 * S};
  const cuuint32_t box[4] = {8, (cuuint32_t)kBK, (cuuint32_t)hdp / 8, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int S, int hd, int groups, cudaStream_t stream) {
  const size_t bytes = smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bf16<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // TMA needs 16-byte aligned bases and row strides; otherwise the
  // producer warp stores the tiles itself
  const int vec = hd % 8 == 0 &&
                  (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15) == 0;
  CUtensorMap tq, tk, tv;
  memset(&tq, 0, sizeof(tq));
  memset(&tk, 0, sizeof(tk));
  memset(&tv, 0, sizeof(tv));
  if (vec && !(make_map(&tq, q, hd, S, BH, HDP) &&
               make_map(&tk, k, hd, S, BH / groups, HDP) &&
               make_map(&tv, v, hd, S, BH / groups, HDP)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((S + kBQ - 1) / kBQ, BH);
  flash_attention_bf16<HDP><<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      S, hd, groups, 1.4426950408889634f / sqrtf((float)hd), vec);
  return (int)cudaGetLastError();
}

int launch_any(const void* q, const void* k, const void* v, void* out, int BH,
               int S, int hd, int groups, cudaStream_t st) {
  switch ((hd + 15) / 16) {
    case 1: return launch<16>(q, k, v, out, BH, S, hd, groups, st);
    case 2: return launch<32>(q, k, v, out, BH, S, hd, groups, st);
    case 3: return launch<48>(q, k, v, out, BH, S, hd, groups, st);
    case 4: return launch<64>(q, k, v, out, BH, S, hd, groups, st);
    case 5: return launch<80>(q, k, v, out, BH, S, hd, groups, st);
    case 6: return launch<96>(q, k, v, out, BH, S, hd, groups, st);
    case 7: return launch<112>(q, k, v, out, BH, S, hd, groups, st);
    case 8: return launch<128>(q, k, v, out, BH, S, hd, groups, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace hopper

int launch_f32(const void* q, const void* k, const void* v, void* out, int BH,
               int S, int hd, int groups, cudaStream_t stream) {
  using namespace simt;
  const size_t bytes = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, BH);
  flash_attention_f32<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, hd, groups,
      1.0f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

}  // namespace

// One launch. dtype 0 = float32 (SIMT kernel), 1 = bfloat16 (wgmma kernel).
// Returns the cudaError_t (0 on success), cudaErrorInvalidValue for a shape
// the kernels do not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int BH, int S,
                                      int hd, int groups, int dtype,
                                      void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  if (hd < 1 || hd > 128 || groups < 1 || BH % groups != 0 || BH > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_f32(q, k, v, out, BH, S, hd, groups, st);
  if (dtype == 1)
    return hopper::launch_any(q, k, v, out, BH, S, hd, groups, st);
  return (int)cudaErrorInvalidValue;
}
