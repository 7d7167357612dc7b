// bf16 GEMM with f32 accumulation and an optional hardtanh epilogue, for
// Hopper (sm_90a): BEANNA's float mode.
//
// Replaces the TPU kernel repro/kernels/bf16_matmul.py::bf16_matmul_pallas
// (body _kernel): out = a @ w for a (M, K) and w (K, N) bf16, in f32, then
// clamped to [-1, 1] when hardtanh is set.
//
// What bounds it on an H100: it reads 2*(M*K + K*N) bytes, writes 4*M*N and
// does 2*M*N*K flops; against 989 TFLOP/s (bf16 tensor cores) and 3.35 TB/s
// the MNIST float layers are bound by bytes at every batch: a row of fc0
// (784 -> 1024) moves 5,664 bytes for 1.6 MFLOP, 283 flops per byte, below
// the card's 295; at small batch the weight's bytes dominate. At these sizes
// (a few MB) a call is in practice bound by latency: one launch, the chain
// of stages a block runs, the reduction of a K split, the store.
//
// Design: bf16 tensor cores fed by a ring of 4 shared-memory stages of 64
// values of K, filled by cp.async, so the next stages are in flight while
// one multiplies. Two tile designs, picked with the K split by the host (the
// wrapper's plan):
//
//   LARGE  64 x 64 outputs a block, one warpgroup on wgmma m64n64k16. It
//          computes the tile transposed, out^T = w^T a^T: wgmma's A operand
//          (64 rows) is w^T, loaded from w's staged tile (k rows, n
//          contiguous) into registers by ldmatrix.trans; its B operand is
//          a's tile, K-major in shared memory in the 128-byte swizzle (16-byte
//          chunk c of row r at chunk c ^ (r & 7)), read through a matrix
//          descriptor. So neither operand needs an MN-major descriptor.
//   SMALL  16 x 8 outputs a block, one warp on mma.sync m16n8k16 (M <= 16 or
//          N <= 16: M = 1, fc3's N = 10, where 64-row tiles would be mostly
//          padding and leave most SMs idle); a's tile by ldmatrix, w's by
//          ldmatrix.trans, which hands each thread the k-pairs of one column
//          that the B fragment wants.
//
// On the H100 this LARGE ran faster than an mma.sync one (4 warps of 32 x
// 32) at every MNIST shape; 128 x 64 and 64 x 128 wgmma tiles were slower,
// and so, in the mma.sync design, were a 32 x 32 tile and rings of 2, 3 or 8
// stages (PERF.md section 6).
// Staged rows of the padded tiles are 8 or 16 values longer than the tile,
// so the 8 rows of an ldmatrix fall in 8 distinct bank groups.
//
// The K range may be split over a thread block cluster of 1, 2, 4 or 8
// blocks, so that a small output still spreads over the SMs. Each block
// leaves its tile of partial sums in its shared memory, and the cluster's
// blocks add the partials through distributed shared memory, always in rank
// order 0, 1, ..., so two calls give the same bits; each rank then clamps
// (when hardtanh is set) and stores a slice of the tile, four columns at a
// time as a float4 where N % 4 == 0.
//
// Ragged edges: rows past M, columns past N and values of K past the
// block's range load as 0 (cp.async zero-fill) and add nothing; outputs past
// M or N are not stored. Rows of a (K values) and of w (N values) take
// 16-byte copies when their length is a multiple of 8 values, 4-byte copies
// when it is even, else 2-byte loads through registers (the host passes
// the width). Base pointers must be 16-byte aligned (the wrapper checks).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;             // values of K per stage
constexpr int STAGES = 4;          // ring depth
constexpr int MAX_SPLITS = 8;      // portable thread block cluster size

struct Large {  // wgmma: 64 x 64 outputs, one warpgroup
  static constexpr int BM = 64, BN = 64, THREADS = 128;
  static constexpr int LDW = BN + 8;                  // padded w row: 9 x 16 B
  static constexpr int A_STAGE = BM * BK * 2;         // swizzled rows of 128 B
  static constexpr int STAGE = A_STAGE + BK * LDW * 2;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + alignment slack
  static_assert(A_STAGE % 1024 == 0 && STAGE % 1024 == 0, "128-byte swizzle atoms");
};
struct Small {  // mma.sync: 16 x 8 outputs, one warp
  static constexpr int BM = 16, BN = 8, THREADS = 32;
  static constexpr int LDA = BK + 8;                  // padded a row: 9 x 16 B
  static constexpr int LDW = BN + 16;                 // padded w row: 3 x 16 B
  static constexpr int A_STAGE = BM * LDA * 2;
  static constexpr int STAGE = A_STAGE + BK * LDW * 2;
  static constexpr int SMEM = STAGES * STAGE;
};
static_assert(Large::BM * Large::BN * 4 <= STAGES * Large::STAGE &&
                  Small::BM * Small::BN * 4 <= Small::SMEM,
              "the partial tile reuses the ring");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// cp.async of 16 or 4 bytes; src_bytes 0 zero-fills without reading
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
// c (16 x 8 f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// wgmma shared-memory descriptor of a K-major tile of 128-byte rows with the
// 128-byte swizzle (8-row atoms 1024 B apart), starting at `p`
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  const uint32_t addr = smem_u32(p);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// d (64 x 64 f32 over the warpgroup) += a (64 x 16 bf16, registers: each
// warp's 16 rows in mma.sync's A layout) * b (16 x 64 bf16, K-major tile)
#define WG_D8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, 1, 1, 1, 0;\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
#undef WG_D8

// Copy a rows x cols tile of a row-major bf16 matrix (row stride ld values)
// into shared memory (row stride lds values): rows [r0, r0 + rows) limited
// to rmax, columns [c0, c0 + cols) limited to cmax; the rest is zero.
// vec is the copy width in values: 8 (16 B), 2 (4 B) or 1 (through
// registers).
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_tile(bf16* s, int lds, const bf16* __restrict__ g,
                                          int ld, int r0, int rmax, int c0, int cmax,
                                          int vec) {
  const int tid = threadIdx.x;
  if (vec == 8) {
    constexpr int CH = COLS / 8;
    for (int i = tid; i < ROWS * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = r0 + r < rmax && c0 + c < cmax;
      const bf16* src = ok ? g + (size_t)(r0 + r) * ld + c0 + c : g;
      cp_async16(smem_u32(s + r * lds + c), src, ok ? 16 : 0);
    }
  } else if (vec == 2) {
    constexpr int CH = COLS / 2;
    for (int i = tid; i < ROWS * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 2;
      const bool ok = r0 + r < rmax && c0 + c < cmax;
      const bf16* src = ok ? g + (size_t)(r0 + r) * ld + c0 + c : g;
      cp_async4(smem_u32(s + r * lds + c), src, ok ? 4 : 0);
    }
  } else {
    for (int i = tid; i < ROWS * COLS; i += THREADS) {
      const int r = i / COLS, c = i % COLS;
      const bool ok = r0 + r < rmax && c0 + c < cmax;
      s[r * lds + c] = ok ? g[(size_t)(r0 + r) * ld + c0 + c] : __float2bfloat16(0.f);
    }
  }
}

// The same for a tile of ROWS rows of BK values in the 128-byte swizzle:
// value c of row r at byte r * 128 + ((c / 8) ^ (r & 7)) * 16 + (c % 8) * 2.
template <int ROWS, int THREADS, int VEC>
__device__ __forceinline__ void load_swizzled(unsigned char* s, const bf16* __restrict__ g,
                                              int ld, int r0, int rmax, int c0, int cmax) {
  for (int i = threadIdx.x; i < ROWS * (BK / VEC); i += THREADS) {
    const int r = i / (BK / VEC), c = (i % (BK / VEC)) * VEC;
    const bool ok = r0 + r < rmax && c0 + c < cmax;
    const bf16* src = ok ? g + (size_t)(r0 + r) * ld + c0 + c : g;
    unsigned char* dst = s + r * 128 + (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
    if (VEC == 8)
      cp_async16(smem_u32(dst), src, ok ? 16 : 0);
    else if (VEC == 2)
      cp_async4(smem_u32(dst), src, ok ? 4 : 0);
    else
      *reinterpret_cast<bf16*>(dst) = ok ? *src : __float2bfloat16(0.f);
  }
}
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_swizzled(unsigned char* s,
                                                   const bf16* __restrict__ g, int ld,
                                                   int r0, int rmax, int c0, int cmax,
                                                   int vec) {
  if (vec == 8)
    load_swizzled<ROWS, THREADS, 8>(s, g, ld, r0, rmax, c0, cmax);
  else if (vec == 2)
    load_swizzled<ROWS, THREADS, 2>(s, g, ld, r0, rmax, c0, cmax);
  else
    load_swizzled<ROWS, THREADS, 1>(s, g, ld, r0, rmax, c0, cmax);
}

__device__ __forceinline__ float clamp1(float v, int hardtanh) {
  return hardtanh ? fminf(fmaxf(v, -1.f), 1.f) : v;
}

// The epilogue of both designs: each block of the cluster (one block when
// K is not split) holds its BM x BN tile of partial sums, row-major, at
// `part` in its shared memory; each rank adds a slice of the tile over all
// ranks in rank order, four columns at a time, clamps and stores it.
template <int BM, int BN, int THREADS>
__device__ __forceinline__ void reduce_store(float* part, float* __restrict__ out, int M,
                                             int N, int m0, int n0, int hardtanh) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every rank's partial is written
  const int nranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const bool quad = (N % 4) == 0;
  for (int e = rank * THREADS + (int)threadIdx.x; e < BM * BN / 4; e += nranks * THREADS) {
    const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    float4 sum = reinterpret_cast<const float4*>(cluster.map_shared_rank(part, 0))[e];
    for (int q = 1; q < nranks; ++q) {
      const float4 x = reinterpret_cast<const float4*>(cluster.map_shared_rank(part, q))[e];
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    const float v4[4] = {clamp1(sum.x, hardtanh), clamp1(sum.y, hardtanh),
                         clamp1(sum.z, hardtanh), clamp1(sum.w, hardtanh)};
    float* dst = out + (size_t)gm * N + gn;
    if (quad && gn + 3 < N) {
      *reinterpret_cast<float4*>(dst) = make_float4(v4[0], v4[1], v4[2], v4[3]);
    } else {
      for (int q = 0; q < 4 && gn + q < N; ++q) dst[q] = v4[q];
    }
  }
  cluster.sync();  // no block leaves while another still reads its partial
}

// grid (splits, N tiles, M tiles); the splits of one tile are a cluster
struct Range {
  int m0, n0, kbeg, kend, nsteps;
  template <class C>
  __device__ static Range of(int K, int kchunk) {
    Range x;
    x.m0 = blockIdx.z * C::BM;
    x.n0 = blockIdx.y * C::BN;
    x.kbeg = blockIdx.x * kchunk;
    x.kend = min(x.kbeg + kchunk, K);
    x.nsteps = (x.kend - x.kbeg + BK - 1) / BK;
    return x;
  }
};

__global__ void __launch_bounds__(Large::THREADS)
bf16_matmul_wgmma_kernel(const bf16* __restrict__ a,   // (M, K)
                         const bf16* __restrict__ w,   // (K, N)
                         float* __restrict__ out,      // (M, N)
                         int M, int N, int K, int kchunk, int vec_a, int vec_w,
                         int hardtanh) {
  using C = Large;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Range x = Range::of<C>(K, kchunk);

  auto load_stage = [&](int slot, int k0) {
    unsigned char* As = smem + slot * C::STAGE;
    load_tile_swizzled<C::BM, C::THREADS>(As, a, K, x.m0, M, k0, x.kend, vec_a);
    load_tile<BK, C::BN, C::THREADS>(reinterpret_cast<bf16*>(As + C::A_STAGE), C::LDW, w, N,
                                     k0, x.kend, x.n0, N, vec_w);
  };

  // d[4 j + 2 h + e] = out^T[n = 16 warp + g + 8 h][m = 8 j + 2 t + e]
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < x.nsteps) load_stage(s, x.kbeg + s * BK);
    cp_async_commit();
  }
  for (int ks = 0; ks < x.nsteps; ++ks) {
    cp_async_wait<STAGES - 2>();
    // the tensor cores read shared memory through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // stage ks landed for every thread; slot ks - 1 consumed
    {
      const int pre = ks + STAGES - 1;
      if (pre < x.nsteps) load_stage(pre % STAGES, x.kbeg + pre * BK);
      cp_async_commit();
    }
    const unsigned char* As = smem + (ks % STAGES) * C::STAGE;
    const bf16* Ws = reinterpret_cast<const bf16*>(As + C::A_STAGE);
    // this warp's 16 rows of w^T (columns 16 warp .. of w), one k16 step
    // each: matrix q of the x4 load is rows k 8 (q / 2) .., columns 8 (q % 2)
    uint32_t af[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const int q = lane >> 3;
      ldmatrix_x4_trans(af[kk], smem_u32(Ws + (kk * 16 + (q >> 1) * 8 + (lane & 7)) * C::LDW +
                                         warp * 16 + (q & 1) * 8));
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_bf16(d, af[kk], wgmma_desc(As + kk * 32));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  cp_async_wait<0>();

  __syncthreads();  // every warp is done reading the ring
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < C::BM / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        part[(8 * j + 2 * t + e) * C::BN + 16 * warp + g + 8 * h] = d[4 * j + 2 * h + e];
  reduce_store<C::BM, C::BN, C::THREADS>(part, out, M, N, x.m0, x.n0, hardtanh);
}

__global__ void __launch_bounds__(Small::THREADS)
bf16_matmul_mma_kernel(const bf16* __restrict__ a,   // (M, K)
                       const bf16* __restrict__ w,   // (K, N)
                       float* __restrict__ out,      // (M, N)
                       int M, int N, int K, int kchunk, int vec_a, int vec_w, int hardtanh) {
  using C = Small;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int g = lane >> 2, t = lane & 3;
  const Range x = Range::of<C>(K, kchunk);

  auto load_stage = [&](int slot, int k0) {
    bf16* As = reinterpret_cast<bf16*>(smem + slot * C::STAGE);
    load_tile<C::BM, BK, C::THREADS>(As, C::LDA, a, K, x.m0, M, k0, x.kend, vec_a);
    load_tile<BK, C::BN, C::THREADS>(reinterpret_cast<bf16*>(smem + slot * C::STAGE +
                                                             C::A_STAGE),
                                     C::LDW, w, N, k0, x.kend, x.n0, N, vec_w);
  };

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < x.nsteps) load_stage(s, x.kbeg + s * BK);
    cp_async_commit();
  }
  for (int ks = 0; ks < x.nsteps; ++ks) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage ks landed for every lane; slot ks - 1 consumed
    {
      const int pre = ks + STAGES - 1;
      if (pre < x.nsteps) load_stage(pre % STAGES, x.kbeg + pre * BK);
      cp_async_commit();
    }
    const bf16* As = reinterpret_cast<const bf16*>(smem + (ks % STAGES) * C::STAGE);
    const bf16* Ws = reinterpret_cast<const bf16*>(smem + (ks % STAGES) * C::STAGE +
                                                   C::A_STAGE);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4], bfr[2];
      ldmatrix_x4(af, smem_u32(As + (lane & 15) * C::LDA + kk * 16 + (lane >> 4) * 8));
      ldmatrix_x2_trans(bfr, smem_u32(Ws + (kk * 16 + (lane & 15)) * C::LDW));
      mma_bf16(acc, af, bfr);
    }
  }
  cp_async_wait<0>();

  __syncthreads();  // the warp is done reading the ring
  float* part = reinterpret_cast<float*>(smem);
  *reinterpret_cast<float2*>(part + g * C::BN + 2 * t) = make_float2(acc[0], acc[1]);
  *reinterpret_cast<float2*>(part + (g + 8) * C::BN + 2 * t) = make_float2(acc[2], acc[3]);
  reduce_store<C::BM, C::BN, C::THREADS>(part, out, M, N, x.m0, x.n0, hardtanh);
}

template <class C>
int launch(void (*kernel)(const bf16*, const bf16*, float*, int, int, int, int, int, int, int),
           const bf16* a, const bf16* w, float* o, int M, int N, int K, int kchunk,
           int hardtanh, cudaStream_t stream) {
  const int splits = (K + kchunk - 1) / kchunk;
  if (splits > MAX_SPLITS || (splits > 1 && kchunk % BK != 0))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr_err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr_err != cudaSuccess) return (int)attr_err;
  const int vec_a = K % 8 == 0 ? 8 : K % 2 == 0 ? 2 : 1;
  const int vec_w = N % 8 == 0 ? 8 : N % 2 == 0 ? 2 : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a, w, o, M, N, K, kchunk, vec_a,
                                             vec_w, hardtanh);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// a: (M, K), w: (K, N) bf16, out: (M, N) f32; all contiguous on the device,
// a and w 16-byte aligned. design 0 runs the LARGE tile (wgmma), 1 the
// SMALL one (mma.sync); the K range is split into ceil(K / kchunk) chunks
// of kchunk values (a multiple of 64 when there are several), at most 8,
// one block of a cluster each. hardtanh != 0 clamps the output to [-1, 1].
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int bf16_matmul_launch(const void* a, const void* w, void* out, int M, int N,
                                  int K, int hardtanh, int design, int kchunk,
                                  void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || kchunk <= 0) return (int)cudaErrorInvalidValue;
  const bf16* a16 = static_cast<const bf16*>(a);
  const bf16* w16 = static_cast<const bf16*>(w);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (design) {
    case 0:
      return launch<Large>(bf16_matmul_wgmma_kernel, a16, w16, o, M, N, K, kchunk, hardtanh,
                           st);
    case 1:
      return launch<Small>(bf16_matmul_mma_kernel, a16, w16, o, M, N, K, kchunk, hardtanh, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
