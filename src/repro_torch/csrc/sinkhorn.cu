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
// products of the final coupling. A product is one mul.rn.ftz.f32
// (fmul_ftz), which flushes subnormal operands and a subnormal product; it
// can differ from flushing the IEEE product only for a product within 2^-24
// of the smallest normal, where the two roundings disagree on which side of
// it the product lies. Every other flush is written out (flush()), so this
// source builds with the same flags as the others.
//
// What bounds it on an H100: neither bytes nor operations. The function
// reads K once and writes T once (2*m*n*4 bytes) and does 4*m*n*H operations
// (two matvecs per iteration): at the grid path's 181 x 181, H = 50, that is
// 0.26 MB and 6.6 MFLOP, well under a microsecond at 3.35 TB/s or
// 67 TFLOP/s. What rules is latency: 2H dependent half-steps, each a
// reduction over the whole of K that ends in a barrier; and once K is held
// in shared memory, that memory's rate (128 B a cycle an SM), which each
// half-step's pass over K's band takes.
//
// Design: three kernels, one launch per call, chosen by size (the wrapper's
// sinkhorn_route; the byte counts below are cluster_bytes / card_bytes).
// Each keeps K where the most SMs can walk it with the fewest barriers:
//
// * sinkhorn_cluster_kernel (A), while K fits the shared memory of a thread
//   block cluster of C = 16 (or 8) CTAs: CTA r holds rows [r*band,
//   (r+1)*band) of K (band = ceil(m/C)), and the whole of v, in its shared
//   memory for all H iterations. The row half-step is local. In the column
//   half-step each CTA sends its partial column sums over its rows to every
//   CTA of the cluster (st.async into distributed shared memory), into the
//   slot for its rank in one of two buffers (by iteration parity); each
//   store counts its bytes on an mbarrier of the receiving CTA. A CTA waits
//   on that mbarrier's phase, the one barrier of the iteration, then adds
//   the C partial vectors from its own shared memory in rank order, so each
//   ends up with the whole new v. A cluster barrier would do the same, but
//   its release is a GPU-wide memory fence and its acquire empties L1, both
//   on every iteration's critical path; the stores' completion on the
//   mbarrier needs neither. A buffer of parity p is written again only two
//   iterations on, by CTAs that have received every CTA's partials of the
//   iteration between, which each sends after reading buffer p. H mbarrier
//   waits a call, and two cluster barriers: one after the mbarriers are
//   set up, one before exit.
// * sinkhorn_card_kernel (B), while K fits the card's shared memory but no
//   cluster's: a cooperative grid, at most one CTA an SM, CTA c holding a
//   band of ceil(m/SMs) rows, loaded once. The row half-step is local; the
//   column half-step is a reduce-scatter through L2: each CTA writes its
//   partial column sums to device memory, a grid barrier, each CTA adds its
//   slice of columns over all CTAs (in a fixed order) and writes that slice
//   of v, a grid barrier, every CTA gathers v. 2H grid barriers a call; the
//   partial and v buffers need no second copy, since two barriers separate
//   every write from the reads of the previous iteration.
// * sinkhorn_stream_kernel (C), for larger K: a cooperative grid of
//   256-thread blocks reads K through L2 with a grid barrier between
//   half-steps; u and v live in device memory. The row half-step is one
//   warp per row; the column half-step gives each block 32 columns, its 8
//   warps stride over the rows and the block adds their partials in warp
//   order. It takes every size.
//
// In A and B rows sit ld = n rounded up to 4 floats apart in shared memory,
// zero-padded (v too), so both half-steps read K as float4: a warp walks a
// row with a lane a strided set of 4-column groups and a shuffle tree adds
// the lanes; a thread owns a 4-column group in the column half-step and
// walks the band's rows in order.
//
// Every sum is taken in a fixed order in all three kernels (no atomics), so
// two runs give the same bits.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;                 // A and B
constexpr int kWarps = kThreads / 32;
constexpr int kStreamThreads = 256;           // C
constexpr float kFltMin = 1.17549435e-38f;    // smallest normal float32

__host__ __device__ constexpr long long round4(long long x) {
  return (x + 3) & ~3LL;
}

// Shared memory of A and B, in bytes; kept in step with the wrapper's
// cluster_bytes / card_bytes, which choose the route.
long long card_bytes(long long m, long long n, long long ctas) {
  const long long band = (m + ctas - 1) / ctas, ld = round4(n);
  return 4 * (band * ld + 2 * round4(band) + 2 * ld);   // K, u, a, v, b
}

long long cluster_bytes(long long m, long long n, long long ctas) {
  // + the partials of every CTA, two iterations' worth, and two mbarriers
  return card_bytes(m, n, ctas) + 4 * 2 * ctas * round4(n) + 16;
}

__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < kFltMin ? 0.f : x;  // NaN passes, as in the plain version
}

// x * y with subnormal operands and a subnormal result flushed to zero
__device__ __forceinline__ float fmul_ftz(float x, float y) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
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

__device__ __forceinline__ void add4(float4& acc, float4 p) {
  acc.x += p.x;
  acc.y += p.y;
  acc.z += p.z;
  acc.w += p.w;
}

// A band of `rows` rows of K in shared memory, rows `ld` floats apart
// (zero-padded), with its scalings u and its share of a, and the whole of v
// and b (zero-padded). a and b sit in shared memory because every barrier
// invalidates L1, so a read of them through L1 would wait on L2 twice an
// iteration.
struct Band {
  float* K;       // (rows, ld)
  float* u;       // (round4(band),)
  float* a;       // (round4(band),)
  float* v;       // (ld,)
  float* b;       // (ld,)
  long long r0;   // the band's first row of K
  int rows, n, ld;
};

// The band starting at row r0 of an (m, n) K, in `smem`: the layout that
// card_bytes counts, ending with b.
__device__ __forceinline__ Band make_band(float* smem, int band, long long r0,
                                          long long m, int n) {
  const int ld = (int)round4(n);
  const long long left = m - r0;
  const int rows = left <= 0 ? 0 : (left < band ? (int)left : band);
  float* u = smem + (long long)band * ld;
  float* a = u + round4(band);
  float* v = a + round4(band);
  return {smem, u, a, v, v + ld, r0, rows, n, ld};
}

// K's band (flushed) and a, b into shared memory; u = 1, v = 1 (0 in the
// padding)
__device__ __forceinline__ void load_band(const Band& s,
                                          const float* __restrict__ a,
                                          const float* __restrict__ b,
                                          const float* __restrict__ K) {
  const int count = s.rows * s.ld;
  const float* src = K + s.r0 * s.n;
#pragma unroll 4
  for (int e = threadIdx.x; e < count; e += kThreads) {
    const int i = e / s.ld, j = e - i * s.ld;
    s.K[e] = j < s.n ? flush(__ldg(src + (long long)i * s.n + j)) : 0.f;
  }
  for (int i = threadIdx.x; i < s.rows; i += kThreads) {
    s.u[i] = 1.f;
    s.a[i] = __ldg(a + s.r0 + i);
  }
  for (int j = threadIdx.x; j < s.ld; j += kThreads) {
    s.v[j] = j < s.n ? 1.f : 0.f;
    s.b[j] = j < s.n ? __ldg(b + j) : 0.f;
  }
}

// u = a / (K v) on the band's rows: a warp a row, a lane a strided set of
// 4-column groups summed in four running sums (one a column of the group),
// then a shuffle tree over the lanes
__device__ __forceinline__ void row_pass(const Band& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nq = s.ld / 4;
  const float4* v4 = reinterpret_cast<const float4*>(s.v);
  for (int i = warp; i < s.rows; i += kWarps) {
    const float4* k4 = reinterpret_cast<const float4*>(s.K + i * s.ld);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int q = lane; q < nq; q += 32) {
      const float4 k = k4[q], v = v4[q];
      acc.x += fmul_ftz(k.x, v.x);
      acc.y += fmul_ftz(k.y, v.y);
      acc.z += fmul_ftz(k.z, v.z);
      acc.w += fmul_ftz(k.w, v.w);
    }
    const float sum = warp_sum((acc.x + acc.y) + (acc.z + acc.w));
    if (lane == 0) s.u[i] = safe_div(s.a[i], sum);
  }
}

// emit(q, the band's share of (K^T u) for columns 4q..4q+3, rows in order)
template <class Emit>
__device__ __forceinline__ void col_pass(const Band& s, Emit emit) {
  const int nq = s.ld / 4;
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int i = 0; i < s.rows; ++i) {
      const float4 k = reinterpret_cast<const float4*>(s.K + i * s.ld)[q];
      const float u = s.u[i];
      acc.x += fmul_ftz(k.x, u);
      acc.y += fmul_ftz(k.y, u);
      acc.z += fmul_ftz(k.z, u);
      acc.w += fmul_ftz(k.w, u);
    }
    emit(q, acc);
  }
}

// v[4q..4q+3] = b / den (0 in the padding, where b is 0)
__device__ __forceinline__ float4 divide4(const Band& s, int q, float4 den) {
  const float4 b = reinterpret_cast<const float4*>(s.b)[q];
  return make_float4(safe_div(b.x, den.x), safe_div(b.y, den.y),
                     safe_div(b.z, den.z), safe_div(b.w, den.w));
}

// the band's rows of T = diag(u) K diag(v)
__device__ __forceinline__ void write_band(const Band& s,
                                           float* __restrict__ T) {
  const int count = s.rows * s.n;
  float* dst = T + s.r0 * s.n;
  for (int e = threadIdx.x; e < count; e += kThreads) {
    const int i = e / s.n, j = e - i * s.n;
    dst[e] = fmul_ftz(fmul_ftz(s.u[i], s.K[i * s.ld + j]), s.v[j]);
  }
}

// Shared-memory addresses, the mbarriers and the remote stores of the
// cluster kernel.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the address `addr` of this CTA's shared memory has in CTA `rank`'s
__device__ __forceinline__ unsigned peer(unsigned addr, unsigned rank) {
  unsigned out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// the barrier's one arrival for its next phase, which then waits for
// `bytes` of remote stores
__device__ __forceinline__ void arm(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void wait_phase(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "WAIT_PHASE:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "%1;\n\t"
      "@!done bra WAIT_PHASE;\n}"
      :: "r"(bar), "r"(parity) : "memory");
}

// x into shared::cluster address `addr`, counted by the mbarrier at `bar`
// (an address in the same CTA)
__device__ __forceinline__ void send4(unsigned addr, float4 x, unsigned bar) {
  asm volatile(
      "st.async.weak.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(addr), "r"(__float_as_uint(x.x)), "r"(__float_as_uint(x.y)),
         "r"(__float_as_uint(x.z)), "r"(__float_as_uint(x.w)), "r"(bar)
      : "memory");
}

template <int CTAS>
__global__ void __launch_bounds__(kThreads)
    sinkhorn_cluster_kernel(const float* __restrict__ a,
                            const float* __restrict__ b,
                            const float* __restrict__ K,
                            float* __restrict__ T, int m, int n, int iters) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int band = (m + CTAS - 1) / CTAS;
  extern __shared__ float4 smem4[];
  const Band s = make_band(reinterpret_cast<float*>(smem4), band,
                           (long long)rank * band, m, n);
  const int nq = s.ld / 4;
  // recv[p][r][q]: CTA r's partial column sums of iteration parity p
  float4* recv = reinterpret_cast<float4*>(s.b + s.ld);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(recv + 2 * CTAS * nq);
  const unsigned bytes = 16u * CTAS * nq;     // a phase of full[p]
  float4* v4 = reinterpret_cast<float4*>(s.v);

  load_band(s, a, b, K);
  if (threadIdx.x == 0) {
    for (int p = 0; p < 2; ++p) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_u32(full + p)) : "memory");
      if (p < iters) arm(smem_u32(full + p), bytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();      // every CTA's barriers are set before any store
  for (int it = 0; it < iters; ++it) {
    const int p = it & 1;
    row_pass(s);
    __syncthreads();
    const unsigned slot = smem_u32(recv + (p * CTAS + rank) * nq);
    const unsigned bar = smem_u32(full + p);
    col_pass(s, [&](int q, float4 acc) {
#pragma unroll
      for (int r = 0; r < CTAS; ++r)
        send4(peer(slot + 16u * q, r), acc, peer(bar, r));
    });
    // the C partial vectors of this parity have all landed here; the next
    // stores into them come two iterations on, after every CTA has sent
    // this CTA its partials of the iteration between, which it does only
    // after its gather below
    wait_phase(bar, (it >> 1) & 1);
    if (threadIdx.x == 0 && it + 2 < iters) arm(bar, bytes);
    const float4* mine = recv + p * CTAS * nq;
    for (int q = threadIdx.x; q < nq; q += kThreads) {
      float4 den = mine[q];
#pragma unroll
      for (int r = 1; r < CTAS; ++r) add4(den, mine[r * nq + q]);
      v4[q] = divide4(s, q, den);
    }
    __syncthreads();
  }
  write_band(s, T);
  // no CTA leaves while its stores to another may be in flight
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n\t"
               "barrier.cluster.wait.aligned;" ::: "memory");
}

// The partials and v are written by other blocks between grid barriers:
// read through L2 (__ldcg), never L1.
__global__ void __launch_bounds__(kThreads)
    sinkhorn_card_kernel(const float* __restrict__ a,
                         const float* __restrict__ b,
                         const float* __restrict__ K, float* __restrict__ T,
                         float* part, float* vglob, int m, int n, int iters) {
  cg::grid_group grid = cg::this_grid();
  const int c = blockIdx.x, ctas = gridDim.x;
  const int band = (m + ctas - 1) / ctas;
  extern __shared__ float4 smem4[];
  const Band s = make_band(reinterpret_cast<float*>(smem4), band,
                           (long long)c * band, m, n);
  const int nq = s.ld / 4, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float4* part4 = reinterpret_cast<float4*>(part);        // (ctas, nq)
  float4* v4g = reinterpret_cast<float4*>(vglob);         // (nq,)
  float4* v4 = reinterpret_cast<float4*>(s.v);
  // this CTA's slice of 4-column groups of v: [q0, q1)
  const int per = (nq + ctas - 1) / ctas;
  const int q0 = min(c * per, nq), q1 = min(q0 + per, nq);

  load_band(s, a, b, K);
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    row_pass(s);
    __syncthreads();
    float4* mine = part4 + (long long)c * nq;
    col_pass(s, [&](int q, float4 acc) { mine[q] = acc; });
    grid.sync();
    // v on the slice: a warp a 4-column group, a lane the CTAs lane,
    // lane + 32, ... in order (four loads in flight), then a shuffle tree
    // over the lanes
    for (int q = q0 + warp; q < q1; q += kWarps) {
      float4 den = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r0 = lane; r0 < ctas; r0 += 128) {
        float4 p[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = r0 + 32 * k;
          p[k] = r < ctas ? __ldcg(part4 + (long long)r * nq + q)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) add4(den, p[k]);
      }
      den = make_float4(warp_sum(den.x), warp_sum(den.y), warp_sum(den.z),
                        warp_sum(den.w));
      if (lane == 0) v4g[q] = divide4(s, q, den);
    }
    grid.sync();
    for (int q = threadIdx.x; q < nq; q += kThreads) v4[q] = __ldcg(v4g + q);
    __syncthreads();
  }
  write_band(s, T);
}

// u and v are written by other blocks between barriers: plain loads, never
// the read-only path.
__global__ void __launch_bounds__(kStreamThreads)
    sinkhorn_stream_kernel(const float* __restrict__ a,
                           const float* __restrict__ b,
                           const float* __restrict__ K, float* __restrict__ T,
                           float* u, float* v, long long m, long long n,
                           int iters) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float part[kStreamThreads / 32][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = kStreamThreads / 32;
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

cudaError_t set_shared_bytes(const void* kernel, long long bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// The current card's numbers the route is chosen by: out[0] the shared
// memory one block may use (the opt-in limit, 232448 on the H100), out[1]
// its SMs, out[2] the largest cluster of the cluster kernel at that shared
// memory, non-portable sizes allowed. Returns the cudaError_t.
extern "C" int sinkhorn_card_numbers(long long* out) {
  int dev = 0, smem = 0, sms = 0, cluster = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sinkhorn_cluster_kernel<16>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err == cudaSuccess)
    err = set_shared_bytes((const void*)sinkhorn_cluster_kernel<16>, smem);
  if (err == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(16);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = (size_t)smem;
    err = cudaOccupancyMaxPotentialClusterSize(
        &cluster, (const void*)sinkhorn_cluster_kernel<16>, &cfg);
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = smem;
  out[1] = sms;
  out[2] = cluster;
  return 0;
}

// One launch of the cluster kernel: one cluster of `ctas` CTAs, 8 or 16
// (16 where the card allows non-portable sizes). Returns the cudaError_t,
// cudaErrorInvalidValue for another size or when a CTA's band does not fit
// its shared memory.
extern "C" int sinkhorn_cluster_launch(const float* a, const float* b,
                                       const float* K, float* T, int m, int n,
                                       int ctas, int iters, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (ctas != 8 && ctas != 16) return (int)cudaErrorInvalidValue;
  auto kernel = ctas == 16 ? sinkhorn_cluster_kernel<16>
                           : sinkhorn_cluster_kernel<8>;
  const long long bytes = cluster_bytes(m, n, ctas);
  cudaError_t err = set_shared_bytes((const void*)kernel, bytes);
  if (err == cudaSuccess && ctas > 8)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a, b, K, T, m, n, iters);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// One cooperative launch of the card kernel, `ctas` CTAs, with `work`
// holding (ctas + 1) * round4(n) floats (the partials and v). Returns the
// cudaError_t: cudaErrorInvalidValue when a band does not fit shared
// memory or `work` is short, cudaErrorCooperativeLaunchTooLarge when the
// CTAs cannot all be resident.
extern "C" int sinkhorn_card_launch(const float* a, const float* b,
                                    const float* K, float* T, float* work,
                                    long long work_floats, int m, int n,
                                    int ctas, int iters, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const long long ld = round4(n);
  if (ctas < 1 || work_floats < (ctas + 1LL) * ld)
    return (int)cudaErrorInvalidValue;
  const long long bytes = card_bytes(m, n, ctas);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = set_shared_bytes((const void*)sinkhorn_card_kernel, bytes);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sinkhorn_card_kernel, kThreads, (size_t)bytes);
  if (err != cudaSuccess) return (int)err;
  if ((long long)sms * per_sm < ctas)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  float* part = work;
  float* vglob = work + (long long)ctas * ld;
  void* args[] = {(void*)&a,    (void*)&b,     (void*)&K,
                  (void*)&T,    (void*)&part,  (void*)&vglob,
                  (void*)&m,    (void*)&n,     (void*)&iters};
  err = cudaLaunchCooperativeKernel((void*)sinkhorn_card_kernel,
                                    dim3((unsigned)ctas), dim3(kThreads), args,
                                    (size_t)bytes, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// One cooperative launch of the stream kernel; u (m,) and v (n,) must hold
// ones. The grid is as large as can be resident at once (the cooperative
// launch refuses more), capped by the rows' and columns' work; the kernel
// has no dynamic shared memory. Returns the cudaError_t (0 on success).
extern "C" int sinkhorn_stream_launch(const float* a, const float* b,
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
        &per_sm, sinkhorn_stream_kernel, kStreamThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const long long wpb = kStreamThreads / 32;
  long long want = (m + wpb - 1) / wpb;         // one warp per row
  const long long tiles = (n + 31) / 32;        // one block per column tile
  if (tiles > want) want = tiles;
  long long blocks = (long long)sms * per_sm;
  if (want < blocks) blocks = want;
  if (blocks < 1) blocks = 1;
  void* args[] = {(void*)&a, (void*)&b, (void*)&K, (void*)&T,
                  (void*)&u, (void*)&v, (void*)&m, (void*)&n, (void*)&iters};
  err = cudaLaunchCooperativeKernel((void*)sinkhorn_stream_kernel,
                                    dim3((unsigned)blocks),
                                    dim3(kStreamThreads), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
