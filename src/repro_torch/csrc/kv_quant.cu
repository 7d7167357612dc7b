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
// *stored* bf16 scale, and one fixed order for mean |x|'s sum: virtual lane
// l (of 32) adds |x[l]|, |x[l + 32]|, ... in index order, then a tree adds
// halves at 16, 8, 4, 2, 1 (kernels/kv_quant.py's _lane_sum repeats it).
//
// B4a and B4c: kv_encode_kernel, the insert kernel. In one launch it
// encodes K and V (blockIdx.y picks the plane) and writes codes and scales
// straight to where the cache keeps them, in one of four modes:
//
//   (a) rows        x (N, D) -> codes (N, W), scales (N,)
//   (b) contiguous  x (B, S, H, D); row (b, s, h) lands at time
//       insert      min(len[b], T - S) + s of the (B, T, H, .) leaves (the
//                   start clamped as dynamic_update_slice clamps it)
//   (c) paged       x (B, S, H, D); row (b, s, h), position p = len[b] + s,
//       insert      lands at block min(table[b, p / bs], n_blocks), row
//                   p % bs of the (n_blocks + 1, bs, H, .) leaves: a hole, a
//                   free slot or a page past the table's n_pages writes the
//                   spare block n_blocks (repro drops those writes)
//   (d) prefill     x (B, S, H, D) -> leaves (B, T, H, .) with T >= S,
//                   written whole: zero codes and zero scales at t >= S
//
// with W = D int8 codes, or ceil(D / 32) 32-bit sign words. S is 1 for a
// decode step's insert and k + 1 for the speculative verify's span. len and
// the table are read on the device, so no launch waits on the host and a
// CUDA graph can capture it. In (b) and (c) one block also writes len + S
// into a separate output (never into len, which other blocks of the launch
// read).
//
// What bounds it on an H100: its least time is bytes. At the serving
// path's prefill (B 8, S 128 into T 256, 32 heads of 80, bf16) one launch
// reads 10.5 MB and writes 10.6 MB of int8 codes and scales, 6.3 us at
// 3.35 TB/s; a decode insert (8 x 32 rows of K and of V) moves 124 KB, far
// below a launch's own ~5 us, so it sits on the launch floor. Measured, the
// prefill encode runs at about a quarter of its byte bound, held by
// instruction issue: an IEEE division an element (bit parity), 6 of 16
// lanes idle at D 80, and a row's index arithmetic.
//
// Design: a group of 16 lanes per row, two rows a warp, 16 rows a block of
// 8 warps. Where a row's base is 16-byte aligned (D * element size a
// multiple of 16, aligned bases) lane j loads 16-byte vectors j, j + 16
// (8 bf16 or 4 f32 each) and stores its int8 codes as one 8- or 4-byte
// word a vector; otherwise it takes elements j, j + 16, ... one at a time
// (any D up to 256). The group reduces absmax by xor shuffles at 8, 4, 2,
// 1. B4c stages the row in shared memory as f32 (at most 1 KB) and reads
// it back in the fixed order: lane j sums elements 32 w + j and
// 32 w + 16 + j, the virtual lanes j and j + 16, whose first tree step it
// then takes alone; the other steps are xor shuffles at 8, 4, 2, 1. The
// same reads give the signs: two warp ballots per word, whose halves for
// each group are the word's low and high 16 bits, pack_bits' order; lane w
// keeps word w and the group stores its words together. Where both rows
// of a warp are zero rows (the prefill's t >= S) the warp only stores
// zeros. Rows past the grid's last row do no loads or stores but take part
// in the shuffles, so every shuffle and ballot runs on the full warp.
// On an H100, holding 4 rows a group with their loads in flight together
// was slower at every serving shape (its chain of 4 encodes outweighs the
// overlap), and so was the scalar path at D 80, where the vector path
// leaves 6 of 16 lanes idle (PERF.md section 6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;
constexpr int GROUP = 16;                    // lanes per row
constexpr int ROWS = 2 * WARPS;              // rows per block
constexpr int DMAX = 256;                    // the largest D the encoder takes
constexpr int PER_LANE = DMAX / GROUP;       // elements a lane holds, at most
constexpr int STAGE = DMAX + 16;             // f32 stride of a staged row: the two
                                             // rows of a warp on other banks
constexpr int INT8 = 0, BINARY = 1;

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

struct EncodeArgs {
  const void* x[2];                          // K, V inputs (B, S, H, D)
  void* codes[2];                            // int8 (.., H, D) or words (.., H, Kp)
  __nv_bfloat16* scales[2];                  // (.., H)
  const int32_t* lens;                       // null: modes (a), (d)
  const int32_t* table;                      // null: contiguous leaves
  int32_t* lens_out;                         // null: no length bump
  int B, S, S_out, H, D, Kp;
  int T;                                     // time extent of a leaf (T, or bs)
  int n_pages, n_blocks;
  int N;                                     // rows a plane: B * S_out * H
};

// Leaf row (.., H) that row (b, s, h) of the grid writes.
__device__ __forceinline__ size_t dst_row(const EncodeArgs& a, int b, int s, int h) {
  if (a.lens == nullptr) return ((size_t)b * a.T + s) * a.H + h;
  const int len = max(__ldg(a.lens + b), 0);
  if (a.table == nullptr) return ((size_t)b * a.T + min(len, a.T - a.S) + s) * a.H + h;
  const int pos = len + s;
  const int page = pos / a.T;
  int phys = page < a.n_pages ? __ldg(a.table + (size_t)b * a.n_pages + page) : a.n_blocks;
  phys = min(max(phys, 0), a.n_blocks);
  return ((size_t)phys * a.T + (pos - page * a.T)) * a.H + h;
}

// Lane j's elements of a row into v: VE = 1, elements j + 16 k; VE > 1,
// the 16-byte vectors j + 16 k (VE elements each). Past D, or for a row
// that is not read, zeros.
template <typename T, int VE>
__device__ __forceinline__ void load_row(const T* xr, bool read, int j, int D,
                                         float (&v)[PER_LANE]) {
  if constexpr (VE == 1) {
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const int i = j + GROUP * k;
      v[k] = (read && i < D) ? as_f32(xr[i]) : 0.f;
    }
  } else {
    const int nvec = D / VE;
#pragma unroll
    for (int k = 0; k < PER_LANE / VE; ++k) {
      const int vi = j + GROUP * k;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (read && vi < nvec) raw = __ldg(reinterpret_cast<const uint4*>(xr) + vi);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (VE == 8) {               // bf16: element 2 e in the low half
          v[k * 8 + 2 * e] = __uint_as_float(w[e] << 16);
          v[k * 8 + 2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
        } else {
          v[k * 4 + e] = __uint_as_float(w[e]);
        }
      }
    }
  }
}

// Element index of v[k] for lane j.
template <int VE>
__device__ __forceinline__ int elem(int j, int k) {
  return (j + GROUP * (k / VE)) * VE + k % VE;
}

// Encode one row, held as v by the 16 lanes of group g, into leaf row dst
// of the plane. Every lane of the warp calls it (the shuffles and ballots
// run on the full warp); a row that is not live stores nothing, a pad row
// stores zero codes and a zero scale.
template <int CODEC, int VE>
__device__ __forceinline__ void encode_row(const EncodeArgs& a, int plane, int j, int g,
                                           bool live, bool pad, size_t dst,
                                           const float (&v)[PER_LANE], float* stage) {
  // the planes picked without indexing the parameter arrays, which would
  // copy the parameters to local memory
  void* codes = plane ? a.codes[1] : a.codes[0];
  __nv_bfloat16* scales = plane ? a.scales[1] : a.scales[0];
  if (__all_sync(FULL, pad || !live)) {        // zero rows only: stores, no arithmetic
    if (!live) return;
    if constexpr (CODEC == INT8) {
      int8_t* qr = static_cast<int8_t*>(codes) + dst * a.D;
      if constexpr (VE == 1) {
        for (int i = j; i < a.D; i += GROUP) qr[i] = 0;
      } else {
        for (int vi = j; vi < a.D / VE; vi += GROUP) {
          if constexpr (VE == 8)
            reinterpret_cast<uint2*>(qr)[vi] = make_uint2(0u, 0u);
          else
            reinterpret_cast<uint32_t*>(qr)[vi] = 0u;
        }
      }
    } else {
      if (j < a.Kp) (static_cast<uint32_t*>(codes) + dst * a.Kp)[j] = 0u;
    }
    if (j == 0) scales[dst] = __float2bfloat16_rn(0.f);
    return;
  }

  if constexpr (CODEC == INT8) {
    float amax = 0.f;
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) amax = fmaxf(amax, fabsf(v[k]));
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, off));
    const __nv_bfloat16 scale = __float2bfloat16_rn(__fdiv_rn(amax, 127.f));
    float sf = __bfloat162float(scale);
    if (sf == 0.f) sf = 1.f;
    if (!live) return;                         // no shuffle follows
    int8_t* qr = static_cast<int8_t*>(codes) + dst * a.D;
    if constexpr (VE == 1) {
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k) {
        const int i = j + GROUP * k;
        if (i < a.D)
          qr[i] = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(v[k], sf)), -127.f), 127.f);
      }
    } else {
      const int nvec = a.D / VE;
#pragma unroll
      for (int k = 0; k < PER_LANE / VE; ++k) {
        const int vi = j + GROUP * k;
        if (vi >= nvec) continue;
        uint32_t w[VE / 4] = {};
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          const int c = (int)fminf(fmaxf(rintf(__fdiv_rn(v[k * VE + e], sf)), -127.f), 127.f);
          w[e / 4] |= (uint32_t)(c & 0xff) << (8 * (e % 4));
        }
        if constexpr (VE == 8)
          reinterpret_cast<uint2*>(qr)[vi] = make_uint2(w[0], w[1]);
        else
          reinterpret_cast<uint32_t*>(qr)[vi] = w[0];
      }
    }
    if (j == 0) scales[dst] = scale;
  } else {
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const int i = elem<VE>(j, k);
      if (i < a.D) stage[i] = v[k];
    }
    __syncwarp();
    float acc0 = 0.f, acc1 = 0.f;              // virtual lanes j and j + 16
    uint32_t mine = 0u;
    for (int w = 0; w < a.Kp; ++w) {           // Kp is the same for every row
      const int i0 = 32 * w + j, i1 = i0 + 16;
      bool bit0 = true, bit1 = true;           // pad bits are 1
      if (i0 < a.D) {
        const float x = stage[i0];
        bit0 = x >= 0.f;
        acc0 = __fadd_rn(acc0, fabsf(x));
      }
      if (i1 < a.D) {
        const float x = stage[i1];
        bit1 = x >= 0.f;
        acc1 = __fadd_rn(acc1, fabsf(x));
      }
      const uint32_t lo = __ballot_sync(FULL, bit0), hi = __ballot_sync(FULL, bit1);
      if (j == w) mine = ((lo >> (GROUP * g)) & 0xffffu) | (((hi >> (GROUP * g)) & 0xffffu) << 16);
    }
    float sum = __fadd_rn(acc0, acc1);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(FULL, sum, off));
    if (!live) return;
    uint32_t* pr = static_cast<uint32_t*>(codes) + dst * a.Kp;
    if (j < a.Kp) pr[j] = pad ? 0u : mine;
    if (j == 0)
      scales[dst] = __float2bfloat16_rn(pad ? 0.f : __fdiv_rn(sum, (float)a.D));
  }
}

template <int CODEC, typename T, int VE>
__global__ void __launch_bounds__(THREADS)
kv_encode_kernel(const EncodeArgs a) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / GROUP, j = lane % GROUP;  // the warp's row 0 or 1, the lane in it
  const int plane = blockIdx.y;                  // 0 K, 1 V
  const int n = blockIdx.x * ROWS + warp * 2 + g;
  const bool live = n < a.N;                     // rows past N only shuffle

  if (a.lens_out != nullptr && blockIdx.x == 0 && plane == 0)
    for (int b = threadIdx.x; b < a.B; b += THREADS) a.lens_out[b] = __ldg(a.lens + b) + a.S;

  int b = 0, s = 0, h = 0;
  size_t dst = 0;
  if (live) {
    h = n % a.H;
    const int bs_ = n / a.H;
    s = bs_ % a.S_out;
    b = bs_ / a.S_out;
    dst = dst_row(a, b, s, h);
  }
  const bool pad = s >= a.S;                     // mode (d): a zero row past S
  const T* xr = static_cast<const T*>(plane ? a.x[1] : a.x[0]) +
                (((size_t)b * a.S + s) * a.H + h) * a.D;
  float v[PER_LANE];
  load_row<T, VE>(xr, live && !pad, j, a.D, v);
  __shared__ __align__(16) float stage[CODEC == BINARY ? ROWS : 1][STAGE];
  encode_row<CODEC, VE>(a, plane, j, g, live, pad, dst, v,
                        stage[CODEC == BINARY ? warp * 2 + g : 0]);
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

inline bool aligned(const void* p, size_t to) { return (uintptr_t)p % to == 0; }

template <int CODEC, typename T>
void launch_encode(const EncodeArgs& a, int planes, cudaStream_t st) {
  constexpr int VE = 16 / sizeof(T);
  bool vec = (size_t)a.D * sizeof(T) % 16 == 0;
  for (int p = 0; p < planes; ++p) {
    vec = vec && aligned(a.x[p], 16);
    if (CODEC == INT8) vec = vec && aligned(a.codes[p], VE);
  }
  const dim3 grid((a.N + ROWS - 1) / ROWS, planes);
  if (vec)
    kv_encode_kernel<CODEC, T, VE><<<grid, THREADS, 0, st>>>(a);
  else
    kv_encode_kernel<CODEC, T, 1><<<grid, THREADS, 0, st>>>(a);
}

}  // namespace

// The insert kernel (B4a codec 0, B4c codec 1). xk, xv: contiguous (B, S,
// H, D) inputs, bf16 (x_bf16 != 0) or f32; xv null encodes xk alone (one
// plane). ck / cv: int8 (.., H, D) or 32-bit word (.., H, ceil(D / 32))
// leaves, sk / sv bf16 (.., H) scales, all contiguous. Modes: lens null,
// rows (b, s < S_out, h) to leaf time s of T (S_out = T; (a) is B = N,
// S = S_out = T = H = 1); lens non-null (S = S_out >= 1), row (b, s, h)
// at position len[b] + s through the table if it is non-null (T = bs,
// table (B, n_pages), block ids clamped to n_blocks, pages past n_pages to
// block n_blocks), else at min(len[b], T - S) + s (leaves (B, T, ..),
// T >= S), and lens_out (B,), if non-null, gets len + S. 1 <= D <= 256;
// S may be 0 without lens (every row a zero row).
extern "C" int kv_encode_launch(int codec, int x_bf16, const void* xk, const void* xv,
                                void* ck, void* cv, void* sk, void* sv, const void* lens,
                                const void* table, void* lens_out, int B, int S, int S_out,
                                int H, int D, int T, int n_pages, int n_blocks,
                                void* stream) {
  if (B <= 0 || S < 0 || S_out <= 0 || S_out < S || H <= 0 || D <= 0 || D > DMAX || T <= 0 ||
      (codec != INT8 && codec != BINARY) || (lens_out != nullptr && lens == nullptr) ||
      (table != nullptr && (lens == nullptr || n_pages <= 0 || n_blocks < 0)) ||
      (lens != nullptr && (S < 1 || S_out != S || (table == nullptr && T < S))))
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * S_out * H;
  if (n >= (1LL << 31) - ROWS) return (int)cudaErrorInvalidValue;
  EncodeArgs a;
  a.x[0] = xk;
  a.x[1] = xv;
  a.codes[0] = ck;
  a.codes[1] = cv;
  a.scales[0] = static_cast<__nv_bfloat16*>(sk);
  a.scales[1] = static_cast<__nv_bfloat16*>(sv);
  a.lens = static_cast<const int32_t*>(lens);
  a.table = static_cast<const int32_t*>(table);
  a.lens_out = static_cast<int32_t*>(lens_out);
  a.B = B;
  a.S = S;
  a.S_out = S_out;
  a.H = H;
  a.D = D;
  a.Kp = (D + 31) / 32;
  a.T = T;
  a.n_pages = n_pages;
  a.n_blocks = n_blocks;
  a.N = (int)n;
  const int planes = xv == nullptr ? 1 : 2;
  cudaStream_t st = (cudaStream_t)stream;
  if (codec == INT8)
    x_bf16 ? launch_encode<INT8, __nv_bfloat16>(a, planes, st)
           : launch_encode<INT8, float>(a, planes, st);
  else
    x_bf16 ? launch_encode<BINARY, __nv_bfloat16>(a, planes, st)
           : launch_encode<BINARY, float>(a, planes, st);
  return (int)cudaGetLastError();
}

// q (N, D) int8, p (N, Kp) 32-bit words with Kp = ceil(D / 32), s (N,) bf16
// scales, out (N, D) f32, contiguous device buffers; N > 0 and D > 0. Each
// launches on `stream` and returns cudaGetLastError() (0 = launched).

extern "C" int kv_dequant_int8_launch(const void* q, const void* s, void* out, int N, int D,
                                      void* stream) {
  if (N <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  dequant_int8_kernel<<<grid_for(N), THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(q), static_cast<const __nv_bfloat16*>(s),
      static_cast<float*>(out), N, D);
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
