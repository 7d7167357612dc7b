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
// the card's 295; at small batch the weight's bytes dominate.
//
// Design: one block per 64 x 64 output tile, the K loop inside the block.
// Each K step converts a 64 x 32 tile of a and a 32 x 64 tile of w to f32
// in shared memory (a stored k-major, so a thread's four rows are one
// broadcast read); each of 256 threads keeps 4 x 4 f32 accumulators and
// multiplies on the CUDA cores. Rows past M, columns past N and the ragged
// K tail load 0 and add nothing; outputs past M or N are not stored. So any
// M, N and K run (the TPU kernel asserts that its blocks divide all three,
// which fc0's K = 784 does not). Tensor cores (mma / wgmma on bf16) and TMA
// staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // output rows per block
constexpr int BN = 64;          // output columns per block
constexpr int BK = 32;          // K per step
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(THREADS)
bf16_matmul_kernel(const __nv_bfloat16* __restrict__ a,   // (M, K)
                   const __nv_bfloat16* __restrict__ w,   // (K, N)
                   float* __restrict__ out,               // (M, N)
                   int M, int N, int K, int hardtanh) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? __bfloat162float(a[(size_t)gm * K + gk]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      Ws[r][c] = (gk < K && gn < N) ? __bfloat162float(w[(size_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
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
      if (gn >= N) continue;
      const float v = acc[i][j];
      out[(size_t)gm * N + gn] = hardtanh ? fminf(fmaxf(v, -1.f), 1.f) : v;
    }
  }
}

}  // namespace

// a: (M, K), w: (K, N) bf16, out: (M, N) f32; all contiguous on the device.
// hardtanh != 0 clamps the output to [-1, 1]. Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int bf16_matmul_launch(const void* a, const void* w, void* out, int M,
                                  int N, int K, int hardtanh, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  bf16_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w),
      static_cast<float*>(out), M, N, K, hardtanh);
  return (int)cudaGetLastError();
}
