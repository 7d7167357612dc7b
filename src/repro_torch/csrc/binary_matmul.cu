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
// output itself; at batch 1 the 128 KiB packed weight is most of it.
//
// Design: one block per 64 x 64 output tile, the K loop inside the block
// (the TPU's sequential grid axis). Each K step stages 64 x 32 words of pa
// and of pw in shared memory (rows padded to 33 words: no bank conflicts);
// each of 256 threads keeps a 4 x 4 int32 accumulator of __popc(a ^ w).
// Rows past M and columns past N load 0 and are not stored; words past Kp
// load 0 in both operands and so count nothing. Any M, N and Kp run (the
// TPU kernel asserts M % bm, N % bn and Kp % bk). The binary mma of the
// tensor cores and TMA staging are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // output rows per block
constexpr int BN = 64;          // output columns per block
constexpr int BKW = 32;         // packed words of K per step (1024 signs)
constexpr int LD = BKW + 1;     // padded shared row stride
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(THREADS)
binary_matmul_kernel(const uint32_t* __restrict__ pa,   // (M, Kp)
                     const uint32_t* __restrict__ pw,   // (N, Kp)
                     int32_t* __restrict__ out,         // (M, N)
                     int M, int N, int Kp, int K) {
  __shared__ uint32_t As[BM * LD];
  __shared__ uint32_t Ws[BN * LD];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < Kp; k0 += BKW) {
    // neighbouring threads read neighbouring words of one row
    for (int i = tid; i < BM * BKW; i += THREADS) {
      const int r = i / BKW, c = i % BKW;
      const int gm = m0 + r, gk = k0 + c;
      As[r * LD + c] = (gm < M && gk < Kp) ? pa[(size_t)gm * Kp + gk] : 0u;
    }
    for (int i = tid; i < BN * BKW; i += THREADS) {
      const int r = i / BKW, c = i % BKW;
      const int gn = n0 + r, gk = k0 + c;
      Ws[r * LD + c] = (gn < N && gk < Kp) ? pw[(size_t)gn * Kp + gk] : 0u;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BKW; ++kk) {
      uint32_t av[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[(ty + 16 * i) * LD + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = Ws[(tx + 16 * j) * LD + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += __popc(av[i] ^ wv[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) out[(size_t)gm * N + gn] = K - 2 * acc[i][j];
    }
  }
}

}  // namespace

// pa: (M, Kp), pw: (N, Kp) 32-bit words, out: (M, N) int32; all contiguous
// on the device; K is the true contraction length (Kp = ceil(K / 32)).
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int binary_matmul_launch(const void* pa, const void* pw, void* out,
                                    int M, int N, int Kp, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || Kp != (K + 31) / 32)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  binary_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(pa), static_cast<const uint32_t*>(pw),
      static_cast<int32_t*>(out), M, N, Kp, K);
  return (int)cudaGetLastError();
}
