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
// 128 KiB packed weight do.
//
// Design: one block of 8 warps per (32-column group, 32-row tile). Each K
// step stages the group's 32 x 32 words of pw and the tile's 32 x 32 words
// of pa in shared memory (rows padded to 33 words: no bank conflicts). Lane
// i of a warp owns column 32 w + i and keeps the popcounts of 4 rows; in
// the epilogue __ballot_sync(y >= 0) over the warp is the packed word,
// with bit i from lane i, which is pack_bits' order. y is computed with
// __fmul_rn then __fadd_rn so that no FMA contraction rounds it otherwise
// than the plain version does. Rows past M load 0 and are not stored; words
// past Kp load 0 in both operands and count nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;          // rows per block
constexpr int COLS = 32;        // columns per block: one output word
constexpr int BKW = 32;         // packed words of K per step
constexpr int LD = BKW + 1;     // padded shared row stride
constexpr int WARPS = 8;
constexpr int ROWS = BM / WARPS;  // rows per warp
constexpr int THREADS = 32 * WARPS;

__global__ void __launch_bounds__(THREADS)
hybrid_dense_kernel(const uint32_t* __restrict__ pa,     // (M, Kp)
                    const uint32_t* __restrict__ pw,     // (N, Kp)
                    const float* __restrict__ scale,     // (N,)
                    const float* __restrict__ shift,     // (N,)
                    uint32_t* __restrict__ out,          // (M, N / 32)
                    int M, int N, int Kp, int K) {
  __shared__ uint32_t As[BM * LD];
  __shared__ uint32_t Ws[COLS * LD];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * COLS;

  int acc[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) acc[i] = 0;

  for (int k0 = 0; k0 < Kp; k0 += BKW) {
    for (int i = tid; i < BM * BKW; i += THREADS) {
      const int r = i / BKW, c = i % BKW;
      const int gm = m0 + r, gk = k0 + c;
      As[r * LD + c] = (gm < M && gk < Kp) ? pa[(size_t)gm * Kp + gk] : 0u;
    }
    for (int i = tid; i < COLS * BKW; i += THREADS) {
      const int r = i / BKW, c = i % BKW;
      const int gk = k0 + c;
      Ws[r * LD + c] = gk < Kp ? pw[(size_t)(n0 + r) * Kp + gk] : 0u;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BKW; ++kk) {
      const uint32_t w = Ws[lane * LD + kk];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) acc[i] += __popc(As[(warp + WARPS * i) * LD + kk] ^ w);
    }
    __syncthreads();
  }

  const float sc = scale[n0 + lane];
  const float sh = shift[n0 + lane];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int gm = m0 + warp + WARPS * i;
    const float y = __fadd_rn(__fmul_rn((float)(K - 2 * acc[i]), sc), sh);
    const uint32_t bits = __ballot_sync(0xffffffffu, y >= 0.f);   // every lane votes
    if (lane == 0 && gm < M) out[(size_t)gm * (N / COLS) + blockIdx.x] = bits;
  }
}

}  // namespace

// pa: (M, Kp), pw: (N, Kp) 32-bit words, scale/shift: (N,) f32, out:
// (M, N / 32) 32-bit words; all contiguous on the device; K is the true
// contraction length (Kp = ceil(K / 32)) and N % 32 == 0. Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int hybrid_dense_launch(const void* pa, const void* pw, const void* scale,
                                   const void* shift, void* out, int M, int N, int Kp,
                                   int K, void* stream) {
  if (M <= 0 || N <= 0 || N % COLS != 0 || K <= 0 || Kp != (K + 31) / 32)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / COLS, (M + BM - 1) / BM);
  hybrid_dense_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(pa), static_cast<const uint32_t*>(pw),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<uint32_t*>(out), M, N, Kp, K);
  return (int)cudaGetLastError();
}
