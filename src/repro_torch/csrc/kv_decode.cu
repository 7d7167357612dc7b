// Dequant-fused decode attention over the int8 and binary KV caches, for
// Hopper (sm_90a): B4b's and B4d's math done in registers, inside the one
// kernel that consumes the values.
//
// Replaces, on the serving path's decode, the TPU kernels
// repro/kernels/kv_quant.py::_dequant_int8_call (B4b, :174, pallas_call
// :179) and ::_dequant_binary_call (B4d, :208, pallas_call :211). There
// they run, as XLA twins that XLA fuses into the block load, inside
// repro/serving/kvcache.py:282 _fused_quant_decode (contiguous pool, a scan
// over kv blocks) and :696 paged_decode_attention (paged pool, a scan over
// the block table). This kernel computes what those two functions compute,
// with and without the speculative verify's per-query lengths (q_lens):
//
//   q (B, S, Hq, D) bf16 or f32. Leaves, int8: k_q / v_q (.., Hkv, D) int8
//   and k_s / v_s (.., Hkv) bf16; binary: k_p / v_p (.., Hkv, Kp) 32-bit
//   sign words (bit i of word w is dim 32 w + i, 1 = +, pad bits 1) and
//   bf16 k_s / v_s. Position t of slot b is row (b, t) of contiguous
//   leaves (B, T, Hkv, .), or row (table[b, t / bs], t % bs) of paged
//   leaves (n_blocks + 1, bs, Hkv, .), the block id clamped to the leaf's
//   last block.
//   Key / value of (t, kv head h): int8 f32(code) * f32(scale) (B4b);
//   binary +-f32(scale) from the first D bits (B4d).
//   Query row (b, s, hq) attends with `scale` to kv head hq / G at the
//   positions t < L = min(len[b], tmax) (tmax = T, or n_pages * bs), or,
//   given q_lens (B, S) int32, t < min(q_lens[b, s], tmax), with an online
//   softmax in f32; out (B, S, Hq, D) in q's type. Without q_lens every
//   query of a slot shares len[b]. A row with no position (L = 0: a free
//   slot) is written as zeros.
//
// What bounds it on an H100: launch latency, then bytes. At the serving
// shape (B 8, Hkv = Hq = 32, D 80, T 256) one launch reads at most
// 8 * 256 * 32 * 2 * (80 + 2) = 10.7 MB for int8 (3.2 us at 3.35 TB/s) and
// 1.8 MB for binary (0.55 us), less below the real lengths, and does about
// 4 D flops per (query, key) pair: nothing for the CUDA cores. A launch
// costs ~5 us, and each chain of dependent loads from device memory ~1 us.
//
// Design: one launch per layer and decode step (or verify pass) covers K
// and V, every slot and every head. The grid (Hkv, B) follows from shapes
// alone; len, q_lens and the table are read on the device, so the launch
// needs no host sync and a CUDA graph can capture it. Each query row has
// its own limit (in shared memory); a row whose limit lies before a chunk
// takes nothing from it. One block of 8 warps per (slot, kv head)
// stages its G * S query rows in shared memory as f32; at G * S = 1 it is
// held to 128 registers a thread, so two blocks share an SM and the
// serving shape's 256 blocks run in one wave on 132 SMs. Warp w takes the
// 32-position chunks w, w + 8, ... below L (at most one each up to
// T = 256). In a chunk, lane i owns position 32 c + i: it finds the row
// (walking the table on the paged pool), loads its key row by 16-byte loads
// (an int8 row of 80 is five) or 4-byte words (binary) and both scales,
// while the warp loads the chunk's value words, lane i owning dims
// 4 i .. 4 i + 3; so a chunk's loads are in flight together, one round
// trip, and the first chunk's are issued before the query rows are staged.
// Scores, in registers: int8 s * sum_i q_i code_i, the scale taken once
// after the dot; binary s * (2 sum_{bit=1} q_i - sum_i q_i) over the first
// D bits (q is zero past D, so the pad bits count nothing). Each warp runs
// its own (m, l, acc) online softmax, max and sum by xor shuffles, and
// folds the value codes to f32 in registers (int8 codes by a byte permute
// and an add, not the quarter-rate int-to-float conversion); the warps
// then merge (m, l, acc) through shared memory in warp order. Nothing
// dequantized reaches device memory, positions at and past L are never
// read (nor the pages at and past ceil(L / bs), holes among them), and
// nothing is gathered.
//
// Deterministic: a position's chunk, lane and warp follow from the
// position alone and every sum runs in one fixed order, so a second call
// gives the same bits, and the contiguous and the paged pool give the same
// bits for the same values whatever the page size.
//
// Not done, and where it would pay: a split of T over several blocks with a
// second combine pass (flash-decoding), the step for long caches; at
// T <= 256 each warp already has at most one chunk. Tensor cores
// (mma.sync) pay with GQA at G >= 8 (ROADMAP A8), where one kv head's keys
// serve 8 or more query rows; at G 1 there is one query row to multiply.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int CHUNK = 32;              // positions per warp pass, one a lane
constexpr int DMAX = 128;
constexpr unsigned FULL = 0xffffffffu;
constexpr int INT8 = 0, BINARY = 1;

struct Args {
  const void* q;
  const void* kc;                      // k_q (int8) or k_p (32-bit words)
  const unsigned short* ks;            // bf16 bits
  const void* vc;
  const unsigned short* vs;
  const int32_t* lens;
  const int32_t* q_lens;               // null: every row attends below len[b]
  const int32_t* table;                // null: contiguous leaves
  void* out;
  int S, Hq, Hkv, D;
  int tmax;                            // T, or n_pages * bs
  int bs;                              // time extent of a leaf (T or bs)
  int n_pages, last_block;
  int q_bf16;
  float scale;
};

__device__ __forceinline__ float bf16_at(const unsigned short* p, int i) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(p + i)));
}

// Byte k of a word whose bytes hold int8 codes + 128, as f32: the byte under
// the exponent of 2^23 is 2^23 + code + 128 exactly. A permute and an add
// run at the full rate, where int-to-float conversion runs at a quarter.
__device__ __forceinline__ float code_f32(uint32_t biased, int k) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7440u | k)) - 8388736.f;
}

// (.., Hkv) row index of position t of slot b at kv head h (the wrapper
// checks that a leaf's rows fit in 31 bits)
__device__ __forceinline__ int row_of(const Args& a, int b, int t, int h) {
  if (a.table == nullptr) return (b * a.bs + t) * a.Hkv + h;
  const int page = t / a.bs;
  const int phys = min(max(__ldg(a.table + b * a.n_pages + page), 0), a.last_block);
  return (phys * a.bs + (t - page * a.bs)) * a.Hkv + h;
}

// One warp's loads for the 32 positions of chunk c: lane i's key row (16-byte
// pieces for int8, words for binary) and scales, and the chunk's value words,
// lane i holding dims 4 i .. 4 i + 3 of each row.
struct Chunk {
  int4 kr[DMAX / 16];
  uint32_t kw[DMAX / 32];
  uint32_t vw[CHUNK];
  float ksc, vsc;
};

template <int CODEC>
__device__ __forceinline__ void load_chunk(const Args& a, int b, int h, int c, int L, int lane,
                                           Chunk& ch) {
  const int D = a.D, nv = D / 16, kp = (D + 31) / 32;
  const int words = CODEC == INT8 ? D / 4 : (D + 3) / 4;
  const int t0 = c * CHUNK;
  const bool valid = t0 + lane < L;
  const int row = valid ? row_of(a, b, t0 + lane, h) : 0;
  if (CODEC == INT8) {
#pragma unroll
    for (int v = 0; v < DMAX / 16; ++v)
      ch.kr[v] = (valid && v < nv)
                     ? __ldg(static_cast<const int4*>(a.kc) + (long long)row * nv + v)
                     : make_int4(0, 0, 0, 0);
  } else {
#pragma unroll
    for (int w = 0; w < DMAX / 32; ++w)
      ch.kw[w] = (valid && w < kp)
                     ? __ldg(static_cast<const uint32_t*>(a.kc) + (long long)row * kp + w)
                     : 0u;
  }
  ch.ksc = valid ? bf16_at(a.ks, row) : 0.f;
  ch.vsc = valid ? bf16_at(a.vs, row) : 0.f;
#pragma unroll
  for (int j = 0; j < CHUNK; ++j) {
    const int rj = __shfl_sync(FULL, row, j);
    ch.vw[j] = 0u;
    if (t0 + j < L && lane < words)
      ch.vw[j] = __ldg(static_cast<const uint32_t*>(a.vc) +
                       (CODEC == INT8 ? (long long)rj * (D / 4) + lane
                                      : (long long)rj * kp + lane / 8));
  }
}

// R: query rows (G * S) the block is built for, at least the real count
// (R 4 and 8 would spill at 128 registers). QL: per-query lengths; without
// them the kernel is the decode step's, every row below len[b], with no
// per-row test left in it.
template <int CODEC, int R, bool QL>
__global__ void __launch_bounds__(THREADS, R == 1 ? 2 : 1)
kv_decode_kernel(const Args a) {
  __shared__ __align__(16) float qs[R][DMAX];      // zero past D
  __shared__ float qsum[R];
  __shared__ float pw[WARPS][R][CHUNK];             // p * value scale
  __shared__ float m_s[WARPS][R], l_s[WARPS][R];
  __shared__ float acc_s[WARPS][R][DMAX];

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int D = a.D, G = a.Hq / a.Hkv, rows = G * a.S;
  // Lr[r]: with QL, the positions query row r (= s G + g) attends to, in
  // shared memory (registers are the scarce resource at R 8); L, the
  // block's largest, bounds the chunks it loads
  __shared__ int Lr[R];
  int L = min(max(__ldg(a.lens + b), 0), a.tmax);
  if (QL) {
    L = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int lim = r < rows ? min(max(__ldg(a.q_lens + b * a.S + r / G), 0), a.tmax) : 0;
      if (threadIdx.x == 0) Lr[r] = lim;
      L = max(L, lim);
    }
  }

  // the warp's first chunk is loaded while the query rows are staged
  Chunk ch;
  if (warp * CHUNK < L) load_chunk<CODEC>(a, b, h, warp, L, lane, ch);

  for (int i = threadIdx.x; i < rows * DMAX; i += THREADS) {
    const int r = i / DMAX, d = i - r * DMAX, s = r / G, g = r - s * G;
    float v = 0.f;
    if (d < D) {
      const long long at = (((long long)b * a.S + s) * a.Hq + h * G + g) * D + d;
      v = a.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[at])
                   : static_cast<const float*>(a.q)[at];
    }
    qs[r][d] = v;
  }
  __syncthreads();
  if (CODEC == BINARY && warp < rows) {      // warp r sums query row r
    float t = 0.f;
    for (int d = lane; d < D; d += 32) t += qs[warp][d];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(FULL, t, off);
    if (lane == 0) qsum[warp] = t;
  }
  __syncthreads();

  const int nv = D / 16, kp = (D + 31) / 32;
  float m[R], l[R], acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
  }

  for (int c = warp; c * CHUNK < L; c += WARPS) {
    const int t0 = c * CHUNK;

    // scores
    float sc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sc[r] = 0.f;
    if (CODEC == INT8) {
#pragma unroll
      for (int v = 0; v < DMAX / 16; ++v) {
        if (v >= nv) break;
        const uint32_t wd[4] = {ch.kr[v].x ^ 0x80808080u, ch.kr[v].y ^ 0x80808080u,
                                ch.kr[v].z ^ 0x80808080u, ch.kr[v].w ^ 0x80808080u};
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) {
          const float c0 = code_f32(wd[c4], 0), c1 = code_f32(wd[c4], 1);
          const float c2 = code_f32(wd[c4], 2), c3 = code_f32(wd[c4], 3);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 qv = *reinterpret_cast<const float4*>(&qs[r][16 * v + 4 * c4]);
            sc[r] = fmaf(qv.x, c0, sc[r]);
            sc[r] = fmaf(qv.y, c1, sc[r]);
            sc[r] = fmaf(qv.z, c2, sc[r]);
            sc[r] = fmaf(qv.w, c3, sc[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        sc[r] = t0 + lane < (QL ? Lr[r] : L) ? sc[r] * ch.ksc * a.scale : -INFINITY;
    } else {
#pragma unroll
      for (int w = 0; w < DMAX / 32; ++w) {
        if (w >= kp) break;
#pragma unroll
        for (int i4 = 0; i4 < 8; ++i4) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 qv = *reinterpret_cast<const float4*>(&qs[r][32 * w + 4 * i4]);
            const uint32_t bits = ch.kw[w] >> (4 * i4);
            sc[r] += (bits & 1u) ? qv.x : 0.f;
            sc[r] += (bits & 2u) ? qv.y : 0.f;
            sc[r] += (bits & 4u) ? qv.z : 0.f;
            sc[r] += (bits & 8u) ? qv.w : 0.f;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        sc[r] = t0 + lane < (QL ? Lr[r] : L) ? ch.ksc * (2.f * sc[r] - qsum[r]) * a.scale
                                              : -INFINITY;
    }

    // online softmax over the chunk, per query row; a row whose limit lies
    // at or before the chunk (t0 >= Lr[r], possible with q_lens) takes
    // nothing from it
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= rows) break;
      if (QL && t0 >= Lr[r]) {                        // the same for the whole warp
        pw[warp][r][lane] = 0.f;
        continue;
      }
      float cm = sc[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) cm = fmaxf(cm, __shfl_xor_sync(FULL, cm, off));
      const float mn = fmaxf(m[r], cm);               // finite: lane 0 is valid
      const float alpha = expf(m[r] - mn);            // 0 on the row's first chunk
      const float p = t0 + lane < (QL ? Lr[r] : L) ? expf(sc[r] - mn) : 0.f;
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(FULL, ps, off);
      l[r] = l[r] * alpha + ps;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[r][k] *= alpha;
      m[r] = mn;
      pw[warp][r][lane] = p * ch.vsc;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      if (t0 + j >= L) break;
      float val[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        val[k] = CODEC == INT8 ? code_f32(ch.vw[j] ^ 0x80808080u, k)
                               : (((ch.vw[j] >> (4 * (lane % 8) + k)) & 1u) ? 1.f : -1.f);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= rows) break;
        const float wgt = pw[warp][r][j];
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(wgt, val[k], acc[r][k]);
      }
    }
    __syncwarp();
    if ((c + WARPS) * CHUNK < L) load_chunk<CODEC>(a, b, h, c + WARPS, L, lane, ch);
  }

  // merge the warps' (m, l, acc) in warp order
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= rows) break;
    if (lane == 0) {
      m_s[warp][r] = m[r];
      l_s[warp][r] = l[r];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * lane + k < D) acc_s[warp][r][4 * lane + k] = acc[r][k];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D, d = i - r * D, s = r / G, g = r - s * G;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m_s[w][r]);
    float o = 0.f;
    if (mx != -INFINITY) {                          // L >= 1
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        if (m_s[w][r] == -INFINITY) continue;         // a warp with no chunk
        const float e = expf(m_s[w][r] - mx);
        den += l_s[w][r] * e;
        num += acc_s[w][r][d] * e;
      }
      o = num / den;
    }
    const long long at = (((long long)b * a.S + s) * a.Hq + h * G + g) * D + d;
    if (a.q_bf16)
      static_cast<__nv_bfloat16*>(a.out)[at] = __float2bfloat16_rn(o);
    else
      static_cast<float*>(a.out)[at] = o;
  }
}

template <int CODEC, int R>
int launch(const Args& a, int B, cudaStream_t st) {
  if (a.q_lens != nullptr)
    kv_decode_kernel<CODEC, R, true><<<dim3(a.Hkv, B), THREADS, 0, st>>>(a);
  else
    kv_decode_kernel<CODEC, R, false><<<dim3(a.Hkv, B), THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <int CODEC>
int dispatch(const void* q, int q_bf16, const void* kc, const void* ks, const void* vc,
             const void* vs, const void* lens, const void* q_lens, const void* table,
             void* out, int B, int S, int Hq, int Hkv, int D, int tmax, int bs, int n_pages,
             int last_block, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv || D <= 0 || D > DMAX || tmax < 0 ||
      bs <= 0 || (CODEC == INT8 && D % 16) || (table && (n_pages <= 0 || last_block < 0)))
    return (int)cudaErrorInvalidValue;
  Args a{q, kc, static_cast<const unsigned short*>(ks), vc,
         static_cast<const unsigned short*>(vs), static_cast<const int32_t*>(lens),
         static_cast<const int32_t*>(q_lens), static_cast<const int32_t*>(table), out, S,
         Hq, Hkv, D, tmax, bs, n_pages, last_block, q_bf16, scale};
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = Hq / Hkv * S;
  if (rows <= 1) return launch<CODEC, 1>(a, B, st);
  if (rows <= 4) return launch<CODEC, 4>(a, B, st);
  if (rows <= 8) return launch<CODEC, 8>(a, B, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Contiguous device buffers: q and out (B, S, Hq, D), bf16 (q_bf16 != 0) or
// f32; kc / vc the codes (int8 (.., Hkv, D), 16-byte aligned, D % 16 == 0;
// or 32-bit words (.., Hkv, ceil(D / 32))); ks / vs (.., Hkv) bf16; lens
// (B,) int32; q_lens null, or (B, S) int32 per-query lengths (each row then
// attends below its own, len is not read). Contiguous leaves: (B, tmax,
// Hkv, .), table null, bs = tmax.
// Paged leaves: (last_block + 1, bs, Hkv, .), table (B, n_pages) int32,
// tmax = n_pages * bs. G * S <= 8, D <= 128. Each launches on `stream` and
// returns cudaGetLastError() (0 = launched).

extern "C" int kv_decode_int8_launch(const void* q, const void* kc, const void* ks,
                                     const void* vc, const void* vs, const void* lens,
                                     const void* q_lens, const void* table, void* out,
                                     int q_bf16, int B, int S, int Hq, int Hkv, int D,
                                     int tmax, int bs, int n_pages, int last_block, float scale,
                                     void* stream) {
  return dispatch<INT8>(q, q_bf16, kc, ks, vc, vs, lens, q_lens, table, out, B, S, Hq, Hkv, D,
                        tmax, bs, n_pages, last_block, scale, stream);
}

extern "C" int kv_decode_binary_launch(const void* q, const void* kc, const void* ks,
                                       const void* vc, const void* vs, const void* lens,
                                       const void* q_lens, const void* table, void* out,
                                       int q_bf16, int B, int S, int Hq, int Hkv, int D,
                                       int tmax, int bs, int n_pages, int last_block,
                                       float scale, void* stream) {
  return dispatch<BINARY>(q, q_bf16, kc, ks, vc, vs, lens, q_lens, table, out, B, S, Hq, Hkv,
                          D, tmax, bs, n_pages, last_block, scale, stream);
}
