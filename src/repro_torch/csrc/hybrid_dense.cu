// Fused binary dense layer: XNOR-popcount dot -> affine -> sign -> repack,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/hybrid_dense.py::hybrid_dense_pallas
// (body _kernel), BEANNA's dataflow step 9: for pa (M, Kp) and pw (N, Kp)
// packed signs (32 per 32-bit word, bit = 1 <-> +1, pad bits 1 in both) and
// per-column scale, shift (N,) f32,
//   dot[m, n] = K - 2 * sum_j popcount(pa[m, j] ^ pw[n, j])
//   y[m, n]   = float(dot) * scale[n] + shift[n]      (two roundings)
//   out[m, w] = the 32 bits (y[m, 32 w + i] >= 0), bit i = column 32 w + i
// so the output is already packed for the next binary layer and the float
// y never reaches device memory. N % 32 == 0.
//
// What bounds it on an H100: it reads 4*(M*Kp + N*Kp + 2N) bytes and writes
// 4*M*N/32, and does 2*M*N*K operations counted as the +-1 dot. At the
// MNIST layers (N = K = 1024) that is about 2,600 operations per byte at
// M = 256, so against 1,979 TOP/s (int8 tensor cores) and 3.35 TB/s the
// operations bound it from M of about 40 up; below, the bytes of the
// 128 KiB packed weight do. At these sizes a call is in practice bound by
// latency: one launch, one trip to device memory, the store.
//
// Design: the main loop is binary_matmul.cu's (B1). The tensor cores' 1-bit
// product, mma.sync m16n8k256 b1 with .and.popc (SASS BMMA.168256.AND.POPC;
// Hopper has no XOR form), gives the XNOR dot through
//   popc(a ^ w) = popc(a) + popc(w) - 2 popc(a & w),  so
//   dot[m, n] = K - 2 (Pa[m] + Pw[n]) + 4 AND[m, n],
// Pa and Pw the set bits of each packed row over the K range, pad bits
// included (1 in both operands, they cancel), words past Kp zero in both
// (they add nothing to any of the three). Each warp counts Pa and Pw from
// the fragments it multiplies and folds them in after the loop. A stage of
// the cp.async ring is one k256 step, rows padded to 12 words (48 B) so the
// 8 rows of an ldmatrix fall in 8 distinct bank groups.
//
// A block computes 32 rows x 64 columns, two output words for each of 32
// rows, with 2 x 2 warps of 16 x 32 (four n8 tiles: one word of 16 rows);
// where N % 64 == 32 the last block's second word column is idle. On the
// H100 this tile was faster than 32 x 32 (2 warps), 64 x 32 (4 warps) and
// 64 x 64 (8 warps) at every MNIST shape (PERF.md, section 6): it reads
// fewer bytes through L2 than 32 x 32 and spills nothing, unlike 64 x 64.
// Step 9 runs in registers once a dot is whole. In the m16n8
// accumulator layout, lane 4 g + t holds rows g and g + 8 and, in n8 tile
// j, columns 8 j + 2 t and 8 j + 2 t + 1, so the quad of lanes 4 g .. 4 g +
// 3 holds all 32 columns of rows g and g + 8: each lane computes
//   y = __fadd_rn(__fmul_rn(float(dot), scale[n]), shift[n])
// (never contracted into an FMA, so it rounds as the plain version does),
// sets bit 8 j + 2 t + e of its row's word where y >= 0 (so -0.0 gives 1),
// the quad ORs its words over two shuffles, and lane t = 0 stores row g's
// word and lane t = 1 row g + 8's: pack_bits' order, bit i = column 32 w +
// i. Each lane reads the scale and shift of its 8 columns once, before the
// main loop.
//
// The K range may be split over a thread block cluster of 1, 2, 4 or 8
// blocks (the wrapper's plan, where a block's K range is long): each block
// leaves its partial tile (4 AND - 2 (Pa + Pw) over its K range) in its
// shared memory, and each rank of the cluster then finishes whole rows,
// each row one output word: a lane per column adds the partials over the
// ranks through distributed shared memory, adds K, computes y, and the
// warp's __ballot_sync(y >= 0) is the word (bit i from lane i). Integer
// sums are exact in any order, so every split gives the same bits.
//
// Rows past M load as 0 and are not stored; words past the block's K range
// load as 0. Packed rows whose byte length is a multiple of 16 (Kp % 4 ==
// 0) take 16-byte copies, others 4-byte ones. Any M and Kp run (the TPU
// kernel asserts M % bm). Base pointers must be 16-byte aligned (the
// wrapper checks).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BKW = 8;            // packed words of K per stage (one k256 step)
constexpr int LDW = 12;           // padded shared row stride, words (3 x 16 B)
constexpr int MAX_SPLITS = 8;     // portable thread block cluster size
constexpr int WORD = 32;          // output columns per packed word

// 2 x 2 warps, each one m16 tile by four n8 tiles of outputs: 16 rows of
// one packed word
struct C {
  static constexpr int WM = 2, WN = 2, NI = 4, STAGES = 8;
  static constexpr int WARPS = WM * WN, THREADS = WARPS * 32;
  static constexpr int BM = WM * 16, BN = WN * WORD;   // block tile
  static constexpr int A_STAGE = BM * LDW * 4;         // bytes
  static constexpr int STAGE = (BM + BN) * LDW * 4;
  static constexpr int SMEM = STAGES * STAGE;          // 36,864 B: every stage of K 2048
  static_assert(8 * NI == WORD, "a warp's row of outputs is one packed word");
  static_assert(BM * BN * 4 <= SMEM, "the split's partial tile reuses the ring");
  static_assert(SMEM <= 48 * 1024, "no opt-in to more shared memory");
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

// step 9 for one output: the affine in two roundings, then the sign
__device__ __forceinline__ bool sign_bit(int dot, float sc, float sh) {
  return __fadd_rn(__fmul_rn((float)dot, sc), sh) >= 0.f;
}

__global__ void __launch_bounds__(C::THREADS)
hybrid_dense_mma_kernel(const uint32_t* __restrict__ pa,     // (M, Kp)
                        const uint32_t* __restrict__ pw,     // (N, Kp)
                        const float* __restrict__ scale,     // (N,)
                        const float* __restrict__ shift,     // (N,)
                        uint32_t* __restrict__ out,          // (M, N / 32)
                        int M, int N, int Kp, int K, int kchunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / C::WN, wn = warp % C::WN;

  // grid (splits, N / 64 word pairs, M tiles); the splits of one tile are a cluster
  const int m0 = blockIdx.z * C::BM;
  const int n0 = blockIdx.y * C::BN;
  const int words = N / WORD;
  const int kbeg = blockIdx.x * kchunk;
  const int kend = min(kbeg + kchunk, Kp);
  const bool w16 = (Kp % 4) == 0;
  const int nsteps = (kend - kbeg + BKW - 1) / BKW;

  // the scale and shift of this lane's columns 8 j + 2 t, 8 j + 2 t + 1 of
  // the warp's word (none past N: a last block of one word)
  const int wcol = n0 + wn * WORD;
  float2 sc[C::NI], sh[C::NI];
#pragma unroll
  for (int j = 0; j < C::NI; ++j) {
    sc[j] = sh[j] = make_float2(0.f, 0.f);
    if (wcol < N) {
      sc[j] = __ldg(reinterpret_cast<const float2*>(scale + wcol + 8 * j + 2 * t));
      sh[j] = __ldg(reinterpret_cast<const float2*>(shift + wcol + 8 * j + 2 * t));
    }
  }

  int acc[C::NI][4];
  int pa_cnt[2] = {0, 0};   // this thread's share of Pa, rows g and g + 8
  int pw_cnt[C::NI];        // this thread's share of Pw, column g of each n8 tile
#pragma unroll
  for (int j = 0; j < C::NI; ++j) {
    pw_cnt[j] = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  }

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
    // a fragment: rows g / g + 8 of the warp's m16 tile, words t / t + 4;
    // b fragment: column g of the n8 tile, words t / t + 4
    uint32_t af[4], bfr[C::NI][2];
    ldmatrix_x4(af, smem_u32(As + (wm * 16 + (lane & 15)) * LDW + (lane >> 4) * 4));
    pa_cnt[0] += __popc(af[0]) + __popc(af[2]);
    pa_cnt[1] += __popc(af[1]) + __popc(af[3]);
#pragma unroll
    for (int j = 0; j < C::NI; ++j) {
      ldmatrix_x2(bfr[j], smem_u32(Ws + (wn * WORD + j * 8 + (lane & 7)) * LDW +
                                   ((lane >> 3) & 1) * 4));
      pw_cnt[j] += __popc(bfr[j][0]) + __popc(bfr[j][1]);
    }
#pragma unroll
    for (int j = 0; j < C::NI; ++j) mma_and_popc(acc[j], af, bfr[j]);
  }
  cp_async_wait<0>();

  // fold Pa and Pw in: the output at (row g + 8 h, column 8 j + 2 t + e)
  // takes Pa of row g + 8 h (this quad's) and Pw of that column (quad
  // 2 t + e's count for tile j)
  pa_cnt[0] = quad_sum(pa_cnt[0]);
  pa_cnt[1] = quad_sum(pa_cnt[1]);
#pragma unroll
  for (int j = 0; j < C::NI; ++j) {
    const int tot = quad_sum(pw_cnt[j]);
    const int p0 = __shfl_sync(0xffffffffu, tot, (2 * t) * 4);
    const int p1 = __shfl_sync(0xffffffffu, tot, (2 * t + 1) * 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      acc[j][2 * h] = 4 * acc[j][2 * h] - 2 * (pa_cnt[h] + p0);
      acc[j][2 * h + 1] = 4 * acc[j][2 * h + 1] - 2 * (pa_cnt[h] + p1);
    }
  }

  if (gridDim.x == 1) {  // one K range: K + the fragments are the dots
    uint32_t w0 = 0, w1 = 0;   // this lane's bits of rows g and g + 8
#pragma unroll
    for (int j = 0; j < C::NI; ++j) {
      const int c = 8 * j + 2 * t;
      w0 |= (uint32_t)sign_bit(K + acc[j][0], sc[j].x, sh[j].x) << c;
      w0 |= (uint32_t)sign_bit(K + acc[j][1], sc[j].y, sh[j].y) << (c + 1);
      w1 |= (uint32_t)sign_bit(K + acc[j][2], sc[j].x, sh[j].x) << c;
      w1 |= (uint32_t)sign_bit(K + acc[j][3], sc[j].y, sh[j].y) << (c + 1);
    }
    w0 |= __shfl_xor_sync(0xffffffffu, w0, 1);
    w0 |= __shfl_xor_sync(0xffffffffu, w0, 2);
    w1 |= __shfl_xor_sync(0xffffffffu, w1, 1);
    w1 |= __shfl_xor_sync(0xffffffffu, w1, 2);
    const int gm = m0 + wm * 16 + g + 8 * t;   // t = 0: row g, t = 1: row g + 8
    if (t < 2 && gm < M && wcol < N)
      out[(size_t)gm * words + blockIdx.y * C::WN + wn] = t == 0 ? w0 : w1;
    return;
  }

  // K split: the partial tile goes to this block's shared memory (the ring,
  // now drained); each rank of the cluster then finishes whole output words
  // (a row's 32 columns of one word): lane i adds column i over all ranks
  // and adds K, and the warp's ballot of the signs is the word
  __syncthreads();  // every warp is done reading the ring
  int32_t* part = reinterpret_cast<int32_t*>(smem);
#pragma unroll
  for (int j = 0; j < C::NI; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 16 + g + 8 * h;
      *reinterpret_cast<int2*>(part + r * C::BN + wn * WORD + 8 * j + 2 * t) =
          make_int2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every rank's partial is written
  const int nranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  // word u of the tile is row u / WN, word u % WN; rank q's warp w takes
  // words q WARPS + w, stepping nranks WARPS
  for (int u = rank * C::WARPS + warp; u < C::BM * C::WN; u += nranks * C::WARPS) {
    const int r = u / C::WN, c = (u % C::WN) * WORD + lane;
    if (m0 + r >= M) break;
    if (n0 + c >= N) continue;
    int dot = K;
    for (int q = 0; q < nranks; ++q) dot += cluster.map_shared_rank(part, q)[r * C::BN + c];
    const uint32_t bits =
        __ballot_sync(0xffffffffu, sign_bit(dot, __ldg(scale + n0 + c), __ldg(shift + n0 + c)));
    if (lane == 0) out[(size_t)(m0 + r) * words + blockIdx.y * C::WN + u % C::WN] = bits;
  }
  cluster.sync();  // no block leaves while another still reads its partial
}

}  // namespace

// pa: (M, Kp), pw: (N, Kp) 32-bit words, scale/shift: (N,) f32, out:
// (M, N / 32) 32-bit words; all contiguous on the device and 16-byte
// aligned; K is the true contraction length (Kp = ceil(K / 32)) and N % 32
// == 0. The K range is split into ceil(Kp / kchunk) chunks of kchunk words
// (a multiple of 8 when there are several), at most 8, one block of a
// cluster each. Launches on `stream` and returns cudaGetLastError() (0 =
// launched).
extern "C" int hybrid_dense_launch(const void* pa, const void* pw, const void* scale,
                                   const void* shift, void* out, int M, int N, int Kp,
                                   int K, int kchunk, void* stream) {
  if (M <= 0 || N <= 0 || N % WORD != 0 || K <= 0 || Kp != (K + 31) / 32 || kchunk <= 0)
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
      &cfg, hybrid_dense_mma_kernel, static_cast<const uint32_t*>(pa),
      static_cast<const uint32_t*>(pw), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<uint32_t*>(out), M, N, Kp, K, kchunk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
