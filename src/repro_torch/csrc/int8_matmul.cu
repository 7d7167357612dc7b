// +-1 int8 activations x bit-packed weights -> exact int32, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/int8_matmul.py::int8_matmul_pallas
// (body _kernel, unpack _unpack_pm1): out[m, n] = sum_k a[m, k] * w[n, k]
// where a is int8 in {-1, +1} (M, K) and w is packed 32 signs per 32-bit
// word (N, K/32), bit i of word j set <=> w[n, 32 j + i] = +1.
//
// What bounds it on an H100: at decode (M = max_batch = 8) the kernel reads
// N*K/8 bytes of packed weight, M*K bytes of activations and writes 4*M*N
// bytes, and does 2*M*N*K integer operations: it is bound by bytes
// (3.35 TB/s). At prefill (M = group x bucket, 1024 and more) it is bound
// by the 2*M*N*K int8 operations against the card's int8 peak (1,979 TOP/s
// on the tensor cores).
//
// Design: one block per 64 x 64 output tile with the K loop inside the
// block (the TPU's sequential grid axis). Each K step stages a 64 x 128
// activation tile in shared memory and unpacks the 64 x 4 packed weight
// words to +-1 int8 in shared memory, so the weight crosses device memory
// 1 bit per value. Each of 256 threads keeps a 4 x 4 int32 accumulator and
// multiplies with __dp4a (four int8 products per instruction, exact).
// Rows past M, columns past N and the ragged K tail (K % 128 != 0) are
// masked here: out-of-range activations load as 0, so whatever the weight
// unpacks to there adds nothing, and out-of-range outputs are not stored.
// Tensor cores (mma / wgmma on s8) and TMA staging are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // output rows per block
constexpr int BN = 64;          // output columns per block
constexpr int BK = 128;         // int8 values of K per step
constexpr int BKW = BK / 4;     // 32-bit words (4 int8 each) per tile row
constexpr int LD = BKW + 1;     // padded shared row stride: no bank conflicts
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const int32_t* __restrict__ a4,      // (M, K/4) words
                   const uint32_t* __restrict__ pw,     // (N, K/32) words
                   int32_t* __restrict__ out,           // (M, N)
                   int M, int N, int K) {
  __shared__ int32_t As[BM * LD];
  __shared__ int32_t Ws[BN * LD];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kw = K / 4;         // activation words per row
  const int kp = K / 32;        // packed weight words per row

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // activation tile: BM rows x BKW words, one row per warp per pass
    for (int i = tid; i < BM * BKW; i += THREADS) {
      const int r = i / BKW, c = i % BKW;
      const int gm = m0 + r, gk = k0 / 4 + c;
      As[r * LD + c] = (gm < M && gk < kw) ? a4[(size_t)gm * kw + gk] : 0;
    }
    // weight tile: BN rows x 4 packed words, each unpacked to 8 words of
    // four +-1 int8 (byte j of word q <- bit 4q + j)
    for (int i = tid; i < BN * (BK / 32); i += THREADS) {
      const int r = i / (BK / 32), c = i % (BK / 32);
      const int gn = n0 + r, gw = k0 / 32 + c;
      const uint32_t bits = (gn < N && gw < kp) ? pw[(size_t)gn * kp + gw] : 0u;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        uint32_t w = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t bit = (bits >> (4 * q + j)) & 1u;
          w |= (bit ? 0x01u : 0xFFu) << (8 * j);
        }
        Ws[r * LD + c * 8 + q] = (int32_t)w;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BKW; ++kk) {
      int av[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[(ty + 16 * i) * LD + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = Ws[(tx + 16 * j) * LD + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], wv[j], acc[i][j]);
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
      if (gn < N) out[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

// a: (M, K) int8, pw: (N, K/32) 32-bit words, out: (M, N) int32; all
// contiguous on the device, a 4-byte aligned. Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int int8_matmul_launch(const void* a, const void* pw, void* out,
                                  int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(a), static_cast<const uint32_t*>(pw),
      static_cast<int32_t*>(out), M, N, K);
  return (int)cudaGetLastError();
}
