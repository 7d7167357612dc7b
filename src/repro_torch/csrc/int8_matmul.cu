// int8 activations x bit-packed +-1 weights -> exact int32, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/int8_matmul.py::int8_matmul_pallas
// (body _kernel, unpack _unpack_pm1): out[m, n] = sum_k a[m, k] * w[n, k]
// where a is int8 (M, K) (+-1 on the serving path, exact for any int8) and
// w is packed 32 signs per 32-bit word (N, K/32), bit i of word j set <=>
// w[n, 32 j + i] = +1.
//
// What bounds it on an H100: at decode (M = max_batch = 8) it reads N*K/8
// bytes of packed weight (2.2 MB for either FFN matmul of stablelm-3b),
// M*K bytes of activations and writes 4*M*N bytes: bound by bytes
// (3.35 TB/s, 0.7 us), and in practice by the latency of one pass over
// the weight. At prefill (M = group x bucket, 128 to 2048) it is bound by
// the 2*M*N*K int8 operations against the card's int8 peak (1,979 TOP/s).
//
// Design: int8 tensor cores, with the weight expanded from bits on chip,
// so that the packed weight crosses device memory at 1 bit per value. One
// K step of 128 values is a stage of a cp.async ring in shared memory: the
// activation tile (rows of 128 B, 16-byte chunk c of row r stored at chunk
// c ^ (r & 7): the 128-byte swizzle, so ldmatrix and wgmma read it without
// bank conflicts) and the packed weight tile (rows of 16 B). A packed word
// expands to +-1 bytes a nibble at a time with two multiplies:
// x = (nib * 0x204081) & 0x01010101 puts bit i in byte i, and ~(x * 0xFE)
// turns bytes 1 / 0 into +1 / -1. Two designs, one per shape of the path:
//
//   prefill (M > 16, bound by operations): wgmma.mma_async m64n128k32 s8,
//     a 128 x 128 output tile per block, two warpgroups of 64 rows, both
//     operands K-major in shared memory (A (M, K) row-major and the
//     expanded weight (N, K) are K-major already). Each stage's packed
//     weights are expanded once for the block into a double-buffered
//     +-1 tile in the same swizzle, stage k + 1's while stage k's wgmma
//     run; a 4-stage ring; two blocks an SM.
//   decode (M <= 16, bound by the weight's bytes): mma.sync m16n8k32 s8
//     with M padded to one m16 tile (wgmma's 64 rows would be 4x the
//     padding), the weight expanded straight into the B fragments in
//     registers; 64 output columns a block, 4 warps of 16 x 16, an 8-stage
//     ring (every load of a block's K range in flight at once).
//
// The K range may be split over a thread block cluster of 1, 2, 4 or 8
// blocks (the wrapper's plan): at decode for at least two blocks per SM,
// since the call is one pass over the weight; at prefill where the output
// tiles would leave SMs idle. Each block leaves its partial tile in its
// shared memory; the cluster's blocks then add the partials through
// distributed shared memory, each rank a slice of the tile, and store the
// sums. Integer sums are exact in any order, so the result is bit for bit
// the unsplit one, and no separate zeroing of the output is needed.
//
// Ragged edges are masked here: activation rows past M and chunks past K
// load as 0 (cp.async zero-fill), so whatever the weight expands to there
// adds nothing; weight rows past N load as 0 and are not stored. Packed rows
// whose byte length is not a multiple of 16 (K % 128 != 0) are loaded one
// 4-byte word at a time. Activation rows (K bytes, K % 32 == 0) always take
// 16-byte chunks. Base pointers must be 16-byte aligned (the wrapper
// checks).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 128;            // int8 values of K per stage
constexpr int BKW = BK / 32;       // packed words per weight row per stage
constexpr int MAX_SPLITS = 8;      // portable thread block cluster size

struct Decode {  // 16 x 64 output tile, 4 warps of 16 x 16
  static constexpr int BM = 16, BN = 64, WM = 1, WN = 4, STAGES = 8, MIN_BLOCKS = 4;
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int TM = BM / WM, TN = BN / WN;   // warp tile
  static constexpr int MI = TM / 16, NI = TN / 8;    // mma tiles per warp
  static constexpr int A_STAGE = BM * BK;            // bytes
  static constexpr int W_STAGE = BN * BKW * 4;       // bytes
  static constexpr int STAGE = A_STAGE + W_STAGE;
  static constexpr int SMEM = STAGES * STAGE;        // also holds the partial tile
  static_assert(BM * BN * 4 <= SMEM, "the split's partial tile reuses the ring");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` (4 or 16); src_bytes 0 zero-fills without reading
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

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four sign bits (bit i of nib) -> four int8 of +-1 (byte i)
__device__ __forceinline__ uint32_t expand_nibble(uint32_t nib) {
  const uint32_t x = (nib * 0x00204081u) & 0x01010101u;
  return ~(x * 0xFEu);
}

// Stage one K step (words [kw, kw + BKW) of the packed rows, values
// [32 kw, 32 kw + BK) of the activation rows) into ring slot `buf`.
template <class C>
__device__ __forceinline__ void load_stage(unsigned char* smem, int buf,
                                           const int8_t* __restrict__ a,
                                           const uint32_t* __restrict__ pw, int M, int N,
                                           int K, int kp, int m0, int n0, int kw, int kend,
                                           bool w16) {
  unsigned char* As = smem + buf * C::STAGE;
  unsigned char* Ws = As + C::A_STAGE;
  const int tid = threadIdx.x;
  // activations: BM rows x 8 chunks of 16 B, chunk c of row r stored at
  // chunk (c ^ (r & 7)) of that row
  for (int i = tid; i < C::BM * (BK / 16); i += C::THREADS) {
    const int r = i >> 3, c = i & 7;
    const int gm = m0 + r, gk = kw * 32 + c * 16;
    const bool ok = gm < M && gk < kend * 32;
    const int8_t* src = ok ? a + (size_t)gm * K + gk : a;
    cp_async16(smem_u32(As + r * BK + ((c ^ (r & 7)) << 4)), src, ok ? 16 : 0);
  }
  // packed weights: BN rows x BKW words
  if (w16) {  // rows are 16-byte aligned and kend is a multiple of BKW
    for (int r = tid; r < C::BN; r += C::THREADS) {
      const int gn = n0 + r;
      const bool ok = gn < N && kw < kend;
      const uint32_t* src = ok ? pw + (size_t)gn * kp + kw : pw;
      cp_async16(smem_u32(Ws + r * BKW * 4), src, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < C::BN * BKW; i += C::THREADS) {
      const int r = i / BKW, w = i % BKW;
      const int gn = n0 + r, gw = kw + w;
      const bool ok = gn < N && gw < kend;
      const uint32_t* src = ok ? pw + (size_t)gn * kp + gw : pw;
      cp_async4(smem_u32(Ws + (r * BKW + w) * 4), src, ok ? 4 : 0);
    }
  }
}

// The K split's reduction: each block of the cluster holds its partial
// tile (BM x BN int32, row-major) at `part` in its shared memory; each rank
// adds a slice of the tile over all ranks, four columns at a time, and
// stores the sums.
template <int BM, int BN, int THREADS>
__device__ __forceinline__ void cluster_reduce(int32_t* part, int32_t* __restrict__ out,
                                               int M, int N, int m0, int n0) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every rank's partial is written
  const int nranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const bool quad = (N % 4) == 0;
  for (int e = rank * THREADS + (int)threadIdx.x; e < BM * BN / 4; e += nranks * THREADS) {
    const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    int4 sum = make_int4(0, 0, 0, 0);
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
      for (int i = 0; i < 4 && gn + i < N; ++i) dst[i] = v4[i];
    }
  }
  cluster.sync();  // no block leaves while another still reads its partial
}

// An accumulator pair (row gm, columns gn and gn + 1) to the output, masked
template <bool PAIR>
__device__ __forceinline__ void store_pair(int32_t* __restrict__ out, int M, int N, int gm,
                                           int gn, int v0, int v1) {
  if (gm >= M) return;
  int32_t* dst = out + (size_t)gm * N + gn;
  if (PAIR && gn + 1 < N) {
    *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
  } else {
    if (gn < N) dst[0] = v0;
    if (gn + 1 < N) dst[1] = v1;
  }
}

// ---------------------------------------------------------------------------
// decode on mma.sync
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(Decode::THREADS, Decode::MIN_BLOCKS)
int8_matmul_mma_kernel(const int8_t* __restrict__ a, const uint32_t* __restrict__ pw,
                       int32_t* __restrict__ out, int M, int N, int K, int kchunk) {
  using C = Decode;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int kp = K / 32;

  // grid (splits, N tiles, M tiles); the splits of one tile are a cluster
  const int m0 = blockIdx.z * C::BM;
  const int n0 = blockIdx.y * C::BN;
  const int kbeg = blockIdx.x * kchunk;
  const int kend = min(kbeg + kchunk, kp);
  const bool w16 = (kp % BKW) == 0;
  const int nsteps = (kend - kbeg + BKW - 1) / BKW;

  int acc[C::MI][C::NI][4];
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int j = 0; j < C::NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nsteps)
      load_stage<C>(smem, s, a, pw, M, N, K, kp, m0, n0, kbeg + s * BKW, kend, w16);
    cp_async_commit();
  }

  for (int ks = 0; ks < nsteps; ++ks) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // stage ks landed for every thread; slot ks - 1 consumed
    {
      const int pre = ks + C::STAGES - 1;
      if (pre < nsteps)
        load_stage<C>(smem, pre % C::STAGES, a, pw, M, N, K, kp, m0, n0,
                      kbeg + pre * BKW, kend, w16);
      cp_async_commit();
    }
    const unsigned char* As = smem + (ks % C::STAGES) * C::STAGE;
    const uint32_t* Ws = reinterpret_cast<const uint32_t*>(As + C::A_STAGE);

    uint4 wrow[C::NI];  // this thread's packed words, one weight row per n8 tile
#pragma unroll
    for (int j = 0; j < C::NI; ++j)
      wrow[j] = *reinterpret_cast<const uint4*>(Ws + (wn * C::TN + j * 8 + g) * BKW);

#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t af[C::MI][4];
#pragma unroll
      for (int i = 0; i < C::MI; ++i) {
        const int r = wm * C::TM + i * 16 + (lane & 15);
        const int c = kk * 2 + (lane >> 4);
        ldmatrix_x4(af[i], smem_u32(As + r * BK + ((c ^ (r & 7)) << 4)));
      }
#pragma unroll
      for (int j = 0; j < C::NI; ++j) {
        const uint32_t word =
            kk == 0 ? wrow[j].x : kk == 1 ? wrow[j].y : kk == 2 ? wrow[j].z : wrow[j].w;
        const uint32_t sh = word >> (4 * t);
        const uint32_t b0 = expand_nibble(sh & 0xFu);
        const uint32_t b1 = expand_nibble((sh >> 16) & 0xFu);
#pragma unroll
        for (int i = 0; i < C::MI; ++i) mma_s8(acc[i][j], af[i], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  if (gridDim.x == 1) {  // one K range: the fragments are the result
#pragma unroll
    for (int i = 0; i < C::MI; ++i)
#pragma unroll
      for (int j = 0; j < C::NI; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gm = m0 + wm * C::TM + i * 16 + g + 8 * h;
          const int gn = n0 + wn * C::TN + j * 8 + 2 * t;
          if (N % 2 == 0)
            store_pair<true>(out, M, N, gm, gn, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          else
            store_pair<false>(out, M, N, gm, gn, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
    return;
  }

  // K split: the partial tile goes to this block's shared memory (the ring,
  // now drained), and the cluster's blocks add the partials of all ranks,
  // each rank a slice of the tile, four columns at a time
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
  cluster_reduce<C::BM, C::BN, C::THREADS>(part, out, M, N, m0, n0);
}

// ---------------------------------------------------------------------------
// prefill on wgmma
// ---------------------------------------------------------------------------

struct Wg {  // 128 x 128 output tile, two warpgroups of 64 rows
  static constexpr int BM = 128, BN = 128, STAGES = 4, THREADS = 256, MIN_BLOCKS = 2;
  static constexpr int A_STAGE = BM * BK, W_STAGE = BN * BKW * 4;
  static constexpr int STAGE = A_STAGE + W_STAGE;     // a multiple of 1024 B
  static constexpr int B_TILE = BN * BK;               // expanded weights, x 2
  static constexpr int SMEM = STAGES * STAGE + 2 * B_TILE + 1024;   // + alignment slack
  static_assert(STAGE % 1024 == 0 && A_STAGE % 1024 == 0, "128-byte swizzle atoms");
  static_assert(BM * BN * 4 <= STAGES * STAGE, "the split's partial tile reuses the ring");
};

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows with the
// 128-byte swizzle (8-row atoms 1024 B apart), starting at `p`
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  const uint32_t addr = smem_u32(p);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 128 s32 over the warpgroup) += a (64 x 32 s8) * b (128 x 32 s8)^T
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      " %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41,"
      " %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(Wg::THREADS, Wg::MIN_BLOCKS)
int8_matmul_wgmma_kernel(const int8_t* __restrict__ a, const uint32_t* __restrict__ pw,
                         int32_t* __restrict__ out, int M, int N, int K, int kchunk) {
  using C = Wg;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Bx = smem + C::STAGES * C::STAGE;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wq = warp & 3;   // warpgroup, warp within it
  const int kp = K / 32;
  const int m0 = blockIdx.z * C::BM;
  const int n0 = blockIdx.y * C::BN;
  const int kbeg = blockIdx.x * kchunk;
  const int kend = min(kbeg + kchunk, kp);
  const bool w16 = (kp % BKW) == 0;
  const int nsteps = (kend - kbeg + BKW - 1) / BKW;

  int d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nsteps)
      load_stage<C>(smem, s, a, pw, M, N, K, kp, m0, n0, kbeg + s * BKW, kend, w16);
    cp_async_commit();
  }

  // expand stage `st`'s packed weights (ring slot st % STAGES) once for the
  // block into Bx[st & 1]: word w of row r (32 values of K) becomes 16-byte
  // chunks 2w and 2w + 1 of the row, in the 128-byte swizzle that the
  // activations have; then make the writes visible to the tensor cores,
  // which read shared memory through the async proxy
  auto expand = [&](int st) {
    const uint32_t* Ws =
        reinterpret_cast<const uint32_t*>(smem + (st % C::STAGES) * C::STAGE + C::A_STAGE);
    unsigned char* B = Bx + (st & 1) * C::B_TILE;
    for (int i = tid; i < C::BN * BKW; i += C::THREADS) {
      const int r = i / BKW, w = i % BKW;
      const uint32_t x = Ws[i];
      const uint4 lo = make_uint4(expand_nibble(x & 0xFu), expand_nibble((x >> 4) & 0xFu),
                                  expand_nibble((x >> 8) & 0xFu),
                                  expand_nibble((x >> 12) & 0xFu));
      const uint4 hi = make_uint4(expand_nibble((x >> 16) & 0xFu),
                                  expand_nibble((x >> 20) & 0xFu),
                                  expand_nibble((x >> 24) & 0xFu), expand_nibble(x >> 28));
      *reinterpret_cast<uint4*>(B + r * BK + (((2 * w) ^ (r & 7)) << 4)) = lo;
      *reinterpret_cast<uint4*>(B + r * BK + (((2 * w + 1) ^ (r & 7)) << 4)) = hi;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  if (nsteps > 0) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // stage 0 landed
    expand(0);
  }
  for (int ks = 0; ks < nsteps; ++ks) {
    __syncthreads();  // Bx[ks & 1] is whole
    const unsigned char* As = smem + (ks % C::STAGES) * C::STAGE;
    const unsigned char* B = Bx + (ks & 1) * C::B_TILE;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      wgmma_s8(d, wgmma_desc(As + wg * 64 * BK + kk * 32), wgmma_desc(B + kk * 32));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // while stage ks multiplies: retire stage ks - 1, refill its ring slot,
    // and expand stage ks + 1 into the other Bx
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    cp_async_wait<C::STAGES - 3>();
    __syncthreads();  // stage ks + 1 landed; both warpgroups retired stage ks - 1
    const int pre = ks + C::STAGES - 1;
    if (pre < nsteps)
      load_stage<C>(smem, pre % C::STAGES, a, pw, M, N, K, kp, m0, n0, kbeg + pre * BKW,
                    kend, w16);
    cp_async_commit();
    if (ks + 1 < nsteps) expand(ks + 1);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  cp_async_wait<0>();

  // d[4 j .. 4 j + 3]: n8 tile j, rows g and g + 8 of the warp's 16
  const int r0 = wg * 64 + wq * 16 + g;
  if (gridDim.x == 1) {
#pragma unroll
    for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = m0 + r0 + 8 * h, gn = n0 + j * 8 + 2 * t;
        if (N % 2 == 0)
          store_pair<true>(out, M, N, gm, gn, d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
        else
          store_pair<false>(out, M, N, gm, gn, d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      }
    return;
  }
  __syncthreads();  // every warp is done with the ring
  int32_t* part = reinterpret_cast<int32_t*>(smem);
#pragma unroll
  for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<int2*>(part + (r0 + 8 * h) * C::BN + j * 8 + 2 * t) =
          make_int2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  cluster_reduce<C::BM, C::BN, C::THREADS>(part, out, M, N, m0, n0);
}

template <class C>
struct Kernel;
template <>
struct Kernel<Decode> {
  static constexpr auto fn = int8_matmul_mma_kernel;
};
template <>
struct Kernel<Wg> {
  static constexpr auto fn = int8_matmul_wgmma_kernel;
};

template <class C>
cudaError_t set_smem() {
  static cudaError_t err = cudaFuncSetAttribute(
      Kernel<C>::fn, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  return err;
}

template <class C>
int launch(const int8_t* a, const uint32_t* w, int32_t* o, int M, int N, int K, int kchunk,
           cudaStream_t stream) {
  const int kp = K / 32;
  const int splits = (kp + kchunk - 1) / kchunk;
  if (splits > MAX_SPLITS || (splits > 1 && kchunk % BKW != 0))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem<C>();
  if (err != cudaSuccess) return (int)err;
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
  err = cudaLaunchKernelEx(&cfg, Kernel<C>::fn, a, w, o, M, N, K, kchunk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// a: (M, K) int8, pw: (N, K/32) 32-bit words, out: (M, N) int32; all
// contiguous on the device, a and pw 16-byte aligned. design 0 runs the
// prefill design (any M; planned for M > 16), design 1 the decode design
// (M <= 16). The K range is split into ceil((K/32) / kchunk) chunks of
// kchunk packed words (a multiple of 4 when there are several), at most 8,
// one block of a cluster each. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int int8_matmul_launch(const void* a, const void* pw, void* out, int M, int N,
                                  int K, int design, int kchunk, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0 || kchunk <= 0 ||
      (design == 1 && M > Decode::BM) || (design != 0 && design != 1))
    return (int)cudaErrorInvalidValue;
  const int8_t* a8 = static_cast<const int8_t*>(a);
  const uint32_t* w = static_cast<const uint32_t*>(pw);
  int32_t* o = static_cast<int32_t*>(out);
  const cudaStream_t st = (cudaStream_t)stream;
  return design == 0 ? launch<Wg>(a8, w, o, M, N, K, kchunk, st)
                     : launch<Decode>(a8, w, o, M, N, K, kchunk, st);
}
