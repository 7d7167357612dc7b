// KV-cache quantize / dequantize kernels for Hopper (sm_90a): BEANNA's
// binary storage trade applied to the serving pool's K/V rows.
//
// Replace the four TPU kernels of repro/kernels/kv_quant.py (B4a-d), which
// share the row math of _int8_rows, _binary_rows, _int8_dequant_rows and
// _binary_dequant_rows. For x (N, D) bf16 or f32, one row per (token, head):
//
//   B4a quant_int8     scale = bf16(absmax / 127) (f32 division),
//                      sf = f32(scale), or 1 where it is 0,
//                      q = clip(round_half_even(x / sf), -127, 127) as int8
//   B4b dequant_int8   f32(q) * f32(scale), f32 out
//   B4c quant_binary   bit i of word w = x[32 w + i] >= 0, pad bits 1,
//                      scale = bf16(mean |x|)
//   B4d dequant_binary +-f32(scale) from the first D bits, f32 out
//
// Bit parity with the plain torch versions rests on: rintf (half to even,
// as jnp.round), IEEE division (__fdiv_rn: no reciprocal multiply, and the
// build uses no --use_fast_math), __float2bfloat16_rn, dividing by the
// *stored* bf16 scale, and one fixed order for mean |x|'s sum: lane l adds
// |x[l]|, |x[l + 32]|, ... in index order, then an xor-shuffle tree at
// offsets 16, 8, 4, 2, 1 (kernels/kv_quant.py's _lane_sum repeats it).
//
// What bounds them on an H100: bytes. Each reads its input once and writes
// its output once, with a few operations per element; at the serving
// path's prefill encode (8 x 128 tokens x 32 heads of 80, bf16) B4a moves
// 7.9 MB, 2.4 us at 3.35 TB/s, and at a decode insert (8 x 32 rows) 60 KB,
// far below a launch's own cost.
//
// Design: one warp per row, 8 rows per block; lane l owns elements l,
// l + 32, ... so each warp-wide access is contiguous. The warp reduces the
// row's absmax or |x| sum with shuffles; B4c's __ballot_sync over the warp
// is the packed word as it stands (bit i from lane i, pack_bits' order).
// Any N and any D: a warp past N returns whole, lanes past D hold 0 (and
// vote 1 for the pad bits).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
quant_int8_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                  __nv_bfloat16* __restrict__ s, int N, int D) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= N) return;                      // uniform across the warp
  const T* xr = x + (size_t)row * D;
  float amax = 0.f;
  for (int i = lane; i < D; i += 32) amax = fmaxf(amax, fabsf(as_f32(xr[i])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, off));
  const __nv_bfloat16 scale = __float2bfloat16_rn(__fdiv_rn(amax, 127.f));
  float sf = __bfloat162float(scale);
  if (sf == 0.f) sf = 1.f;
  int8_t* qr = q + (size_t)row * D;
  for (int i = lane; i < D; i += 32) {
    const float v = rintf(__fdiv_rn(as_f32(xr[i]), sf));
    qr[i] = (int8_t)fminf(fmaxf(v, -127.f), 127.f);
  }
  if (lane == 0) s[row] = scale;
}

__global__ void __launch_bounds__(THREADS)
dequant_int8_kernel(const int8_t* __restrict__ q, const __nv_bfloat16* __restrict__ s,
                    float* __restrict__ out, int N, int D) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= N) return;
  const float sf = __bfloat162float(s[row]);
  const int8_t* qr = q + (size_t)row * D;
  float* orow = out + (size_t)row * D;
  for (int i = lane; i < D; i += 32) orow[i] = __fmul_rn((float)qr[i], sf);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
quant_binary_kernel(const T* __restrict__ x, uint32_t* __restrict__ p,
                    __nv_bfloat16* __restrict__ s, int N, int D, int Kp) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= N) return;
  const T* xr = x + (size_t)row * D;
  uint32_t* pr = p + (size_t)row * Kp;
  float acc = 0.f;
  for (int w = 0; w < Kp; ++w) {
    const int i = 32 * w + lane;
    bool bit = true;                         // pad bits are 1
    if (i < D) {
      const float v = as_f32(xr[i]);
      bit = v >= 0.f;
      acc = __fadd_rn(acc, fabsf(v));
    }
    const uint32_t word = __ballot_sync(FULL, bit);
    if (lane == 0) pr[w] = word;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(FULL, acc, off));
  if (lane == 0) s[row] = __float2bfloat16_rn(__fdiv_rn(acc, (float)D));
}

__global__ void __launch_bounds__(THREADS)
dequant_binary_kernel(const uint32_t* __restrict__ p, const __nv_bfloat16* __restrict__ s,
                      float* __restrict__ out, int N, int D, int Kp) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= N) return;
  const float sf = __bfloat162float(s[row]);
  const uint32_t* pr = p + (size_t)row * Kp;
  float* orow = out + (size_t)row * D;
  for (int i = lane; i < D; i += 32) orow[i] = ((pr[i / 32] >> (i % 32)) & 1u) ? sf : -sf;
}

inline dim3 grid_for(int N) { return dim3((N + WARPS - 1) / WARPS); }

}  // namespace

// All pointers are contiguous device buffers: x (N, D) bf16 (x_bf16 != 0)
// or f32, q (N, D) int8, p (N, Kp) 32-bit words with Kp = ceil(D / 32),
// s (N,) bf16 scales, out (N, D) f32. N > 0 and D > 0. Each launches on
// `stream` and returns cudaGetLastError() (0 = launched).

extern "C" int kv_quant_int8_launch(const void* x, int x_bf16, void* q, void* s, int N,
                                    int D, void* stream) {
  if (N <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16)
    quant_int8_kernel<<<grid_for(N), THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<__nv_bfloat16*>(s), N, D);
  else
    quant_int8_kernel<<<grid_for(N), THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<__nv_bfloat16*>(s), N, D);
  return (int)cudaGetLastError();
}

extern "C" int kv_dequant_int8_launch(const void* q, const void* s, void* out, int N, int D,
                                      void* stream) {
  if (N <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  dequant_int8_kernel<<<grid_for(N), THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(q), static_cast<const __nv_bfloat16*>(s),
      static_cast<float*>(out), N, D);
  return (int)cudaGetLastError();
}

extern "C" int kv_quant_binary_launch(const void* x, int x_bf16, void* p, void* s, int N,
                                      int D, void* stream) {
  if (N <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const int Kp = (D + 31) / 32;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16)
    quant_binary_kernel<<<grid_for(N), THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<uint32_t*>(p),
        static_cast<__nv_bfloat16*>(s), N, D, Kp);
  else
    quant_binary_kernel<<<grid_for(N), THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<uint32_t*>(p),
        static_cast<__nv_bfloat16*>(s), N, D, Kp);
  return (int)cudaGetLastError();
}

extern "C" int kv_dequant_binary_launch(const void* p, const void* s, void* out, int N,
                                        int D, void* stream) {
  if (N <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  dequant_binary_kernel<<<grid_for(N), THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(p), static_cast<const __nv_bfloat16*>(s),
      static_cast<float*>(out), N, D, (D + 31) / 32);
  return (int)cudaGetLastError();
}
