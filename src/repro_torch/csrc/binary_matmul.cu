// XNOR-popcount GEMM on bit-packed signs -> exact int32, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/binary_matmul.py::binary_matmul_pallas
// (body _kernel): out[m, n] = K - 2 * sum_j popcount(pa[m, j] ^ pw[n, j]),
// where pa (M, Kp) and pw (N, Kp) hold 32 signs per 32-bit word, bit i of
// word j set <=> value 32 j + i is +1, and the pad bits of a last partial
// word are 1 in both operands, so they XOR to 0 and need no mask.
//
// What bounds it on an H100: it reads 4*(M*Kp + N*Kp) bytes and writes
// 4*M*N, and does 2*M*N*K operations counted as the +-1 dot it computes.
// Against the int8 tensor-core peak (1,979 TOP/s) and 3.35 TB/s, the MNIST
// layers (N = K = 1024) are bound by bytes at every batch: 4,224 bytes
// against 2M operations per row of output, almost all of it the int32
// output itself; at batch 1 the 128 KiB packed weight is most of it. At
// these sizes a call is in practice bound by latency: one launch, one trip
// to device memory, the reduction of a K split, the store.
//
// Design: the tensor cores' 1-bit product, mma.sync m16n8k256 b1 with
// .and.popc (SASS BMMA.168256.AND.POPC). Hopper has no XOR form: ptxas
// takes .xor.popc but emits two AND products on complemented operands for
// it. The AND form is exact through
//   popc(a ^ w) = popc(a) + popc(w) - 2 popc(a & w),  so
//   out[m, n] = K - 2 (Pa[m] + Pw[n]) + 4 AND[m, n],
// Pa and Pw the set bits of each packed row over the K range, pad bits
// included (1 in both operands, they cancel), words past Kp zero in both
// (they add nothing to any of the three). Each warp counts Pa and Pw from
// the A and B fragments it multiplies (a quad of threads holds a row's 8
// words of a k256 step), adds them over the quad with shuffles, and folds
// them into its accumulators in the epilogue.
//
// A stage of the cp.async ring is one k256 step: 8 words of every row of
// the block's pa and pw tiles, rows padded to 12 words (48 B) so the 8 rows
// of an ldmatrix fall in 8 distinct bank groups. The fragments of the b1
// product have the layout of m16n8k32 s8's with a 32-bit word in place of
// four bytes, so ldmatrix (b16, not transposed: both operands are K-major)
// loads them. A block computes 32 x 32 outputs with 4 warps of 16 x 16:
// on the H100 this tile was as fast as or faster than 64 x 64 (4 warps of
// 32 x 32) and 16 x 8 (one warp) at every MNIST shape, and within 0.3 us
// of the faster at the rest (PERF.md, section 6): at these sizes more, smaller
// blocks buy nothing, since a call is one round trip to memory whatever
// its grid.
//
// The K range may be split over a thread block cluster of 1, 2, 4 or 8
// blocks (the wrapper's plan: only where a block's K range is long, as at
// the spec draft's K = 2560): each block leaves its partial tile (4 AND -
// 2 (Pa + Pw) over its K range) in its shared memory, and the cluster's
// blocks add the partials through distributed shared memory and add K.
// Integer sums are exact in any order.
//
// Rows past M and N load as 0 and are not stored; words past the block's K
// range load as 0. Packed rows whose byte length is a multiple of 16
// (Kp % 4 == 0) take 16-byte copies, others 4-byte ones. Any M, N and Kp
// run (the TPU kernel asserts M % bm, N % bn and Kp % bk). Base pointers
// must be 16-byte aligned (the wrapper checks).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BKW = 8;            // packed words of K per stage (one k256 step)
constexpr int LDW = 12;           // padded shared row stride, words (3 x 16 B)
constexpr int MAX_SPLITS = 8;     // portable thread block cluster size

// 2 x 2 warps, each one m16 tile by two n8 tiles of outputs
struct C {
  static constexpr int WM = 2, WN = 2, MI = 1, NI = 2, STAGES = 8;
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int TM = 16 * MI, TN = 8 * NI;      // warp tile
  static constexpr int BM = WM * TM, BN = WN * TN;     // block tile
  static constexpr int A_STAGE = BM * LDW * 4;         // bytes
  static constexpr int STAGE = (BM + BN) * LDW * 4;
  static constexpr int SMEM = STAGES * STAGE;          // 24,576 B: every stage of K 2048
  static_assert(BM * BN * 4 <= SMEM, "the split's partial tile reuses the ring");
};

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
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
// c (16 x 8 s32) += popc(a (16 x 256 bits) & b (256 x 8 bits)) per output
__device__ __forceinline__ void mma_and_popc(int (&c)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy words [kw, kw + BKW) (limited to kend) of `rows` packed rows from
// row r0 (limited to rmax) into shared memory, rows LDW words apart; the
// rest is zero. w16: 16-byte copies (Kp % 4 == 0), else 4-byte ones.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(uint32_t* s, const uint32_t* __restrict__ g,
                                          int kp, int r0, int rmax, int kw, int kend,
                                          bool w16) {
  const int tid = threadIdx.x;
  if (w16) {
    for (int i = tid; i < ROWS * (BKW / 4); i += THREADS) {
      const int r = i / (BKW / 4), c = (i % (BKW / 4)) * 4;
      const bool ok = r0 + r < rmax && kw + c < kend;
      const uint32_t* src = ok ? g + (size_t)(r0 + r) * kp + kw + c : g;
      cp_async16(smem_u32(s + r * LDW + c), src, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < ROWS * BKW; i += THREADS) {
      const int r = i / BKW, c = i % BKW;
      const bool ok = r0 + r < rmax && kw + c < kend;
      const uint32_t* src = ok ? g + (size_t)(r0 + r) * kp + kw + c : g;
      cp_async4(smem_u32(s + r * LDW + c), src, ok ? 4 : 0);
    }
  }
}

__device__ __forceinline__ void load_stage(unsigned char* smem, int slot,
                                           const uint32_t* __restrict__ pa,
                                           const uint32_t* __restrict__ pw, int M, int N,
                                           int kp, int m0, int n0, int kw, int kend,
                                           bool w16) {
  uint32_t* As = reinterpret_cast<uint32_t*>(smem + slot * C::STAGE);
  uint32_t* Ws = reinterpret_cast<uint32_t*>(smem + slot * C::STAGE + C::A_STAGE);
  load_rows<C::BM, C::THREADS>(As, pa, kp, m0, M, kw, kend, w16);
  load_rows<C::BN, C::THREADS>(Ws, pw, kp, n0, N, kw, kend, w16);
}

// the sum of v over the 4 threads of a quad (lanes 4 g .. 4 g + 3)
__device__ __forceinline__ int quad_sum(int v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__global__ void __launch_bounds__(C::THREADS)
binary_matmul_mma_kernel(const uint32_t* __restrict__ pa,   // (M, Kp)
                         const uint32_t* __restrict__ pw,   // (N, Kp)
                         int32_t* __restrict__ out,         // (M, N)
                         int M, int N, int Kp, int K, int kchunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / C::WN, wn = warp % C::WN;

  // grid (splits, N tiles, M tiles); the splits of one tile are a cluster
  const int m0 = blockIdx.z * C::BM;
  const int n0 = blockIdx.y * C::BN;
  const int kbeg = blockIdx.x * kchunk;
  const int kend = min(kbeg + kchunk, Kp);
  const bool w16 = (Kp % 4) == 0;
  const int nsteps = (kend - kbeg + BKW - 1) / BKW;

  int acc[C::MI][C::NI][4];
  int pa_cnt[C::MI][2];   // this thread's share of Pa, rows g and g + 8
  int pw_cnt[C::NI];      // this thread's share of Pw, column g
#pragma unroll
  for (int i = 0; i < C::MI; ++i) {
    pa_cnt[i][0] = pa_cnt[i][1] = 0;
#pragma unroll
    for (int j = 0; j < C::NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  }
#pragma unroll
  for (int j = 0; j < C::NI; ++j) pw_cnt[j] = 0;

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nsteps)
      load_stage(smem, s, pa, pw, M, N, Kp, m0, n0, kbeg + s * BKW, kend, w16);
    cp_async_commit();
  }

  for (int ks = 0; ks < nsteps; ++ks) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // stage ks landed for every thread; slot ks - 1 consumed
    {
      const int pre = ks + C::STAGES - 1;
      if (pre < nsteps)
        load_stage(smem, pre % C::STAGES, pa, pw, M, N, Kp, m0, n0, kbeg + pre * BKW, kend,
                   w16);
      cp_async_commit();
    }
    const uint32_t* As = reinterpret_cast<const uint32_t*>(smem + (ks % C::STAGES) * C::STAGE);
    const uint32_t* Ws = As + C::BM * LDW;
    // a fragment: rows g / g + 8 of the m16 tile, words t / t + 4;
    // b fragment: column g of the n8 tile, words t / t + 4
    uint32_t af[C::MI][4], bfr[C::NI][2];
#pragma unroll
    for (int i = 0; i < C::MI; ++i) {
      ldmatrix_x4(af[i], smem_u32(As + (wm * C::TM + i * 16 + (lane & 15)) * LDW +
                                  (lane >> 4) * 4));
      pa_cnt[i][0] += __popc(af[i][0]) + __popc(af[i][2]);
      pa_cnt[i][1] += __popc(af[i][1]) + __popc(af[i][3]);
    }
#pragma unroll
    for (int j = 0; j < C::NI; ++j) {
      ldmatrix_x2(bfr[j], smem_u32(Ws + (wn * C::TN + j * 8 + (lane & 7)) * LDW +
                                   ((lane >> 3) & 1) * 4));
      pw_cnt[j] += __popc(bfr[j][0]) + __popc(bfr[j][1]);
    }
#pragma unroll
    for (int i = 0; i < C::MI; ++i)
#pragma unroll
      for (int j = 0; j < C::NI; ++j) mma_and_popc(acc[i][j], af[i], bfr[j]);
  }
  cp_async_wait<0>();

  // fold Pa and Pw in: the output at (row g + 8 h, column 2 t + e) takes
  // Pa of row g + 8 h (this quad's) and Pw of column 2 t + e (quad 2 t + e's)
#pragma unroll
  for (int i = 0; i < C::MI; ++i) {
    pa_cnt[i][0] = quad_sum(pa_cnt[i][0]);
    pa_cnt[i][1] = quad_sum(pa_cnt[i][1]);
  }
#pragma unroll
  for (int j = 0; j < C::NI; ++j) {
    const int tot = quad_sum(pw_cnt[j]);
    const int p0 = __shfl_sync(0xffffffffu, tot, (2 * t) * 4);
    const int p1 = __shfl_sync(0xffffffffu, tot, (2 * t + 1) * 4);
#pragma unroll
    for (int i = 0; i < C::MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[i][j][2 * h] = 4 * acc[i][j][2 * h] - 2 * (pa_cnt[i][h] + p0);
        acc[i][j][2 * h + 1] = 4 * acc[i][j][2 * h + 1] - 2 * (pa_cnt[i][h] + p1);
      }
  }

  if (gridDim.x == 1) {  // one K range: K + the fragments are the result
    const bool pair = (N % 2) == 0;
#pragma unroll
    for (int i = 0; i < C::MI; ++i)
#pragma unroll
      for (int j = 0; j < C::NI; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gm = m0 + wm * C::TM + i * 16 + g + 8 * h;
          const int gn = n0 + wn * C::TN + j * 8 + 2 * t;
          if (gm >= M) continue;
          const int v0 = K + acc[i][j][2 * h], v1 = K + acc[i][j][2 * h + 1];
          int32_t* dst = out + (size_t)gm * N + gn;
          if (pair && gn + 1 < N) {
            *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
          } else {
            if (gn < N) dst[0] = v0;
            if (gn + 1 < N) dst[1] = v1;
          }
        }
    return;
  }

  // K split: the partial tile goes to this block's shared memory (the ring,
  // now drained); each rank of the cluster then adds a slice of the tile
  // over all ranks, four columns at a time, and adds K
  __syncthreads();  // every warp is done reading the ring
  int32_t* part = reinterpret_cast<int32_t*>(smem);
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int j = 0; j < C::NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * C::TM + i * 16 + g + 8 * h;
        const int c = wn * C::TN + j * 8 + 2 * t;
        *reinterpret_cast<int2*>(part + r * C::BN + c) =
            make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every rank's partial is written
  const int nranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const bool quad = (N % 4) == 0;
  for (int e = rank * C::THREADS + tid; e < C::BM * C::BN / 4; e += nranks * C::THREADS) {
    const int r = e / (C::BN / 4), c = (e % (C::BN / 4)) * 4;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    int4 sum = make_int4(K, K, K, K);
    for (int q = 0; q < nranks; ++q) {
      const int4 x = reinterpret_cast<const int4*>(cluster.map_shared_rank(part, q))[e];
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    int32_t* dst = out + (size_t)gm * N + gn;
    if (quad && gn + 3 < N) {
      *reinterpret_cast<int4*>(dst) = sum;
    } else {
      const int v4[4] = {sum.x, sum.y, sum.z, sum.w};
      for (int q = 0; q < 4 && gn + q < N; ++q) dst[q] = v4[q];
    }
  }
  cluster.sync();  // no block leaves while another still reads its partial
}

}  // namespace

// pa: (M, Kp), pw: (N, Kp) 32-bit words, out: (M, N) int32; all contiguous
// on the device, pa and pw 16-byte aligned; K is the true contraction
// length (Kp = ceil(K / 32)). The K range is split into ceil(Kp / kchunk)
// chunks of kchunk words (a multiple of 8 when there are several), at most
// 8, one block of a cluster each. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int binary_matmul_launch(const void* pa, const void* pw, void* out, int M, int N,
                                    int Kp, int K, int kchunk, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || Kp != (K + 31) / 32 || kchunk <= 0)
    return (int)cudaErrorInvalidValue;
  const int splits = (Kp + kchunk - 1) / kchunk;
  if (splits > MAX_SPLITS || (splits > 1 && kchunk % BKW != 0))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, binary_matmul_mma_kernel, static_cast<const uint32_t*>(pa),
      static_cast<const uint32_t*>(pw), static_cast<int32_t*>(out), M, N, Kp, K, kchunk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
