// Online-softmax (flash) attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_call
// (body _flash_kernel, reached through flash_attention_pallas), with the
// same semantics: q (B, S, Hq, D), k and v (B, T, Hkv, D) in the layout the
// model produces them, GQA query head h reading kv head h / (Hq / Hkv)
// without a repeat, causal masking against absolute positions
// q_offset + s, per-batch-row kv_len (clamped to T by the caller), masked
// scores set to the finite -1e9, running max / sum / accumulator in f32,
// l == 0 taken as 1, and the output written once in the inputs' type.
// As in the TPU kernel, the probabilities are rounded to the inputs' type
// before they multiply V, while the running sum adds them unrounded.
//
// What bounds it on an H100: it reads q, k, v once and writes o once
// ((q + k + v + o) bytes over 3.35 TB/s) and does 4 * B * Hq * D flops per
// visible (query, key) pair (about half of S * T under the causal mask)
// against 989 TFLOP/s of bf16. That is about S / 4 flops per byte, far
// below the card's ~295, so at the serving shapes (S = T <= 256, D = 80)
// it is bound by bytes: 6.3 us for B = 8, S = T = 128, 32 heads.
//
// Design: one block of 128 threads per (q tile of 64 rows, head, batch
// row), looping over kv tiles of 64 inside the block (the TPU's innermost
// grid axis). Q, the K and V tiles and the probability tile are staged in
// shared memory as f32; two threads share each query row, each scoring
// every other key and owning every other output dimension, so the row max
// and sum combine with one shuffle. Tiles above the causal diagonal and
// tiles wholly past kv_len are not visited (their scores would all be
// masked). This version does its products on the CUDA cores, not the
// tensor cores: wgmma and TMA staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 128;  // two threads per query row
constexpr float NEG_INF = -1e9f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * (BKV + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int32_t* __restrict__ kvlen,
                 T* __restrict__ o, int S, int Tk, int Hq, int Hkv,
                 float scale, int causal, int q_offset) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // BQ x (D + 1)
  float* Ks = Qs + BQ * (D + 1);       // BKV x (D + 1)
  float* Vs = Ks + BKV * (D + 1);      // BKV x D
  float* Ps = Vs + BKV * D;            // BQ x (BKV + 1)

  const int tid = threadIdx.x;
  const int r = tid >> 1;              // query row of the tile
  const int par = tid & 1;             // which half of keys / dims
  const int s0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int len = kvlen[b];

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D, d = i % D, s = s0 + rr;
    Qs[rr * (D + 1) + d] =
        s < S ? to_f<T>(q[(((size_t)b * S + s) * Hq + h) * D + d]) : 0.f;
  }

  const int row = q_offset + s0 + r;   // absolute position of this row
  int kv_end = Tk;
  if (causal) kv_end = min(kv_end, q_offset + s0 + BQ);
  // a row with no visible key at all (kv_len == 0) keeps visiting tiles,
  // so it comes out as the plain mean over them, as in the TPU kernel
  if (len > 0) kv_end = min(kv_end, len);

  float m = NEG_INF, l = 0.f;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int c0 = 0; c0 < kv_end; c0 += BKV) {
    __syncthreads();  // Q is staged; the previous tile is consumed
    for (int i = tid; i < BKV * D; i += THREADS) {
      const int cc = i / D, d = i % D, t = c0 + cc;
      float kx = 0.f, vx = 0.f;
      if (t < Tk) {
        const size_t off = (((size_t)b * Tk + t) * Hkv + hk) * D + d;
        kx = to_f<T>(k[off]);
        vx = to_f<T>(v[off]);
      }
      Ks[cc * (D + 1) + d] = kx;
      Vs[cc * D + d] = vx;
    }
    __syncthreads();

    // scores for keys par, par + 2, ... of this tile
    float sc[BKV / 2];
#pragma unroll
    for (int j = 0; j < BKV / 2; ++j) sc[j] = 0.f;
    const float* qrow = Qs + r * (D + 1);
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < BKV / 2; ++j) sc[j] += qd * Ks[(par + 2 * j) * (D + 1) + d];
    }
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < BKV / 2; ++j) {
      const int col = c0 + par + 2 * j;
      const bool valid = col < len && (!causal || row >= col);
      sc[j] = valid ? sc[j] * scale : NEG_INF;
      mx = fmaxf(mx, sc[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_cur = fmaxf(m, mx);
    const float alpha = expf(m - m_cur);
    float rs = 0.f;
    float* prow = Ps + r * (BKV + 1);
#pragma unroll
    for (int j = 0; j < BKV / 2; ++j) {
      const float p = expf(sc[j] - m_cur);
      rs += p;
      prow[par + 2 * j] = to_f<T>(from_f<T>(p));
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    l = l * alpha + rs;
    m = m_cur;
    __syncwarp();  // the row's two threads share prow

#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha;
    for (int cc = 0; cc < BKV; ++cc) {
      const float p = prow[cc];
      const float* vrow = Vs + cc * D + par;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] += p * vrow[2 * i];
    }
  }

  const int s = s0 + r;
  if (s < S) {
    const float denom = l == 0.f ? 1.f : l;
    T* orow = o + (((size_t)b * S + s) * Hq + h) * D + par;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) orow[2 * i] = from_f<T>(acc[i] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* kvlen,
           void* o, int B, int S, int Tk, int Hq, int Hkv, float scale,
           int causal, int q_offset, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(kvlen), static_cast<T*>(o), S, Tk, Hq, Hkv,
      scale, causal, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, const void* kvlen,
             void* o, int B, int S, int Tk, int Hq, int Hkv, float scale,
             int causal, int q_offset, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, kvlen, o, B, S, Tk, Hq, Hkv, scale, causal, q_offset,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, kvlen, o, B, S, Tk, Hq, Hkv, scale, causal, q_offset,
                           stream);
    case 80:
      return launch<T, 80>(q, k, v, kvlen, o, B, S, Tk, Hq, Hkv, scale, causal, q_offset,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, kvlen, o, B, S, Tk, Hq, Hkv, scale, causal, q_offset,
                           stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, S, Hq, D), k and v (B, Tk, Hkv, D), o (B, S, Hq, D), all contiguous
// on the device in one type (dtype 0 = bf16, 1 = f32); kvlen (B,) int32 with
// every entry <= Tk. D must be 16, 64, 80 or 128. Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* kvlen, void* o, int B, int S,
                                      int Tk, int Hq, int Hkv, int D, float scale,
                                      int causal, int q_offset, int dtype,
                                      void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<__nv_bfloat16>(D, q, k, v, kvlen, o, B, S, Tk, Hq, Hkv, scale,
                                   causal, q_offset, st);
  if (dtype == 1)
    return launch_d<float>(D, q, k, v, kvlen, o, B, S, Tk, Hq, Hkv, scale, causal,
                           q_offset, st);
  return (int)cudaErrorInvalidValue;
}
