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
// Tiles above the causal diagonal and tiles wholly past kv_len are not
// visited; a row with kv_len 0 comes out as the mean over the tiles it
// visits (every score masked alike), as in the TPU kernel.
//
// What bounds it on an H100: it reads q, k, v once and writes o once
// ((q + k + v + o) bytes over 3.35 TB/s) and does 4 * B * Hq * D flops per
// visible (query, key) pair (about half of S * T under the causal mask)
// against 989 TFLOP/s of bf16. That is about S / 4 flops per byte, far
// below the card's ~295, so at the serving shapes (S = T <= 256, D = 80)
// it is bound by bytes: 6.3 us for B = 8, S = T = 128, 32 heads.
//
// Design, bf16 (every serving path): FA2-style, on the tensor cores through
// mma.sync.m16n8k16 bf16 -> f32. One block of 4 warps per (q tile of 64
// rows, head, batch row); each warp owns 16 query rows, keeps S = Q K^T
// (16 x 64 keys) and O (16 x D) in registers, and takes the row max and sum
// over the quad of lanes that shares a row with two xor shuffles. The
// score accumulator is repacked in registers as the A operand of P V, P
// rounded to bf16 there. mma.sync rather than wgmma: at these shapes the
// kernel is bound by bytes and launch latency, not by the tensor cores'
// rate, and a warp's own 16 rows keep the online softmax in registers
// without the cross-warp exchange that wgmma's 64-row tiles would need.
// Q and the K / V tiles (64 keys) are staged by cp.async in 16-byte chunks
// (a row of D bf16 is 2 D bytes, 16-byte aligned at every head offset),
// K / V double-buffered so the next tile loads while this one is used;
// rows are padded to D + 8 elements (a multiple of 16 B whose 16-byte
// units are odd, so the 8 rows an ldmatrix reads fall in 8 distinct bank
// groups). Fragments come by ldmatrix (.trans for V). Keys past T and
// query rows past S load as zeros (cp.async zero-fill).
//
// Design, f32 (no serving path sends f32): the CUDA-core kernel of the
// first port, kept for the f32 instantiation because TF32 products would
// not hold the f32 tolerance (2e-5): Q, the K and V tiles and the
// probability tile are staged in shared memory as f32, two threads share
// each query row, each scoring every other key and owning every other
// output dimension.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 128;  // bf16: 4 warps of 16 query rows; f32: 2 threads a row
constexpr float NEG_INF = -1e9f;

template <int D>
constexpr size_t simt_smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * (BKV + 1));
}

// f32: the CUDA-core design (header note)
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const int32_t* __restrict__ kvlen,
                      float* __restrict__ o, int S, int Tk, int Hq, int Hkv,
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
        s < S ? q[(((size_t)b * S + s) * Hq + h) * D + d] : 0.f;
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
        kx = k[off];
        vx = v[off];
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
      prow[par + 2 * j] = p;
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
    float* orow = o + (((size_t)b * S + s) * Hq + h) * D + par;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) orow[2 * i] = acc[i] / denom;
  }
}


// ---------------------------------------------------------------------------
// bf16: the tensor-core design (header note)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int PAD = 8;  // bf16 elements of padding per staged row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte cp.async; src_bytes 0 zero-fills without reading
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
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
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// c (16 x 8 f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two floats -> two bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// up to D = 80, four blocks an SM (at most 128 registers a thread): every
// serving-shape block resident in one wave; D = 128 keeps its 168
#define MMA_MIN_BLOCKS(D) ((D) <= 80 ? 4 : 1)

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (BQ + 4 * BKV) * (D + PAD);  // Q, then K and V x 2 buffers
}

template <int D>
__global__ void __launch_bounds__(THREADS, MMA_MIN_BLOCKS(D))
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int32_t* __restrict__ kvlen,
                     bf16* __restrict__ o, int S, int Tk, int Hq, int Hkv, float scale,
                     int causal, int q_offset) {
  constexpr int LD = D + PAD;   // elements per staged row
  constexpr int CH = D / 8;     // 16-byte chunks per row
  constexpr int KD = D / 16;    // k16 steps over D (Q K^T), pairs of n8 tiles (P V)
  constexpr int ND = D / 8;     // n8 tiles of O
  constexpr int NK = BKV / 8;   // n8 tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x LD
  bf16* Ks = Qs + BQ * LD;                       // 2 x BKV x LD
  bf16* Vs = Ks + 2 * BKV * LD;                  // 2 x BKV x LD

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int s0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);

  for (int i = tid; i < BQ * CH; i += THREADS) {
    const int r = i / CH, c = i % CH, s = s0 + r;
    const bool ok = s < S;
    const bf16* src = ok ? q + (((size_t)b * S + s) * Hq + h) * D + c * 8 : q;
    cp_async16(smem_u32(Qs + r * LD + c * 8), src, ok ? 16 : 0);
  }
  auto load_kv = [&](int tile, int buf) {
    for (int i = tid; i < BKV * CH; i += THREADS) {
      const int r = i / CH, c = i % CH, tt = tile * BKV + r;
      const bool ok = tt < Tk;
      const size_t off = ok ? (((size_t)b * Tk + tt) * Hkv + hk) * D + c * 8 : 0;
      const int dst = (buf * BKV + r) * LD + c * 8;
      cp_async16(smem_u32(Ks + dst), k + off, ok ? 16 : 0);
      cp_async16(smem_u32(Vs + dst), v + off, ok ? 16 : 0);
    }
  };
  load_kv(0, 0);  // every block visits tile 0: its loads go out before kv_len is read
  cp_async_commit();

  const int len = kvlen[b];
  int kv_end = Tk;
  if (causal) kv_end = min(kv_end, q_offset + s0 + BQ);
  // a row with no visible key at all (kv_len == 0) keeps visiting tiles,
  // so it comes out as the plain mean over them, as in the TPU kernel
  if (len > 0) kv_end = min(kv_end, len);
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  uint32_t qf[KD][4];
  float oacc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[i][e] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  const int row0 = q_offset + s0 + warp * 16 + g;  // absolute positions row0, row0 + 8

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_kv(j + 1, (j + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile j (and Q) landed for every thread
    if (j == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        ldmatrix_x4(qf[kd], smem_u32(Qs + (warp * 16 + (lane & 15)) * LD + kd * 16 +
                                     (lane >> 4) * 8));
    }
    const bf16* Kb = Ks + (j & 1) * BKV * LD;
    const bf16* Vb = Vs + (j & 1) * BKV * LD;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float sacc[NK][4];
#pragma unroll
    for (int i = 0; i < NK; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[i][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int p = 0; p < NK / 2; ++p) {
        uint32_t kb[4];
        const int key = p * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(kb, smem_u32(Kb + key * LD + kd * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(sacc[2 * p], qf[kd], kb[0], kb[1]);
        mma_bf16(sacc[2 * p + 1], qf[kd], kb[2], kb[3]);
      }

    // scale and mask; lane holds rows row0 (e = 0, 1) and row0 + 8 (e = 2, 3)
    const int c0 = j * BKV;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + nt * 8 + 2 * t + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        const bool valid = col < len && (!causal || row >= col);
        sacc[nt][e] = valid ? sacc[nt][e] * scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], sacc[nt][e]);
      }
    float alpha[2], m_cur[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_cur[i] = fmaxf(m_r[i], mx[i]);
      alpha[i] = __expf(m_r[i] - m_cur[i]);
    }
    // P, rounded to bf16 in the A layout of P V; the sum adds it unrounded
    uint32_t pf[NK][2];
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
      const float p0 = __expf(sacc[nt][0] - m_cur[0]), p1 = __expf(sacc[nt][1] - m_cur[0]);
      const float p2 = __expf(sacc[nt][2] - m_cur[1]), p3 = __expf(sacc[nt][3] - m_cur[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pf[nt][0] = pack_bf16(p0, p1);
      pf[nt][1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l_r[i] = l_r[i] * alpha[i] + rs[i];
      m_r[i] = m_cur[i];
    }
#pragma unroll
    for (int dt = 0; dt < ND; ++dt) {
      oacc[dt][0] *= alpha[0];
      oacc[dt][1] *= alpha[0];
      oacc[dt][2] *= alpha[1];
      oacc[dt][3] *= alpha[1];
    }

    // O += P V, 16 keys per step
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      const uint32_t pa[4] = {pf[2 * kk][0], pf[2 * kk][1], pf[2 * kk + 1][0],
                              pf[2 * kk + 1][1]};
      const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dp = 0; dp < KD; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, smem_u32(Vb + key * LD + dp * 16 + (lane >> 4) * 8));
        mma_bf16(oacc[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(oacc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer j & 1 before it refills
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = s0 + warp * 16 + g + 8 * i;
    if (s >= S) continue;
    const float denom = l_r[i] == 0.f ? 1.f : l_r[i];
    bf16* orow = o + (((size_t)b * S + s) * Hq + h) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < ND; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8) =
          pack_bf16(oacc[dt][2 * i] / denom, oacc[dt][2 * i + 1] / denom);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* kvlen, void* o, int B,
           int S, int Tk, int Hq, int Hkv, float scale, int causal, int q_offset, int dtype,
           cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  const int32_t* kl = static_cast<const int32_t*>(kvlen);
  if (dtype == 0) {
    constexpr size_t smem = mma_smem_bytes<D>();
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return (int)attr;
    flash_fwd_mma_kernel<D><<<grid, THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        kl, static_cast<bf16*>(o), S, Tk, Hq, Hkv, scale, causal, q_offset);
  } else {
    constexpr size_t smem = simt_smem_bytes<D>();
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_fwd_simt_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return (int)attr;
    flash_fwd_simt_kernel<D><<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), kl, static_cast<float*>(o), S, Tk, Hq, Hkv, scale,
        causal, q_offset);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, S, Hq, D), k and v (B, Tk, Hkv, D), o (B, S, Hq, D), all contiguous
// on the device in one type (dtype 0 = bf16, 1 = f32) and 16-byte aligned;
// kvlen (B,) int32 with every entry <= Tk. D must be 16, 64, 80 or 128.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* kvlen, void* o, int B, int S,
                                      int Tk, int Hq, int Hkv, int D, float scale,
                                      int causal, int q_offset, int dtype,
                                      void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || q_offset < 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return launch<16>(q, k, v, kvlen, o, B, S, Tk, Hq, Hkv, scale, causal, q_offset, dtype,
                        st);
    case 64:
      return launch<64>(q, k, v, kvlen, o, B, S, Tk, Hq, Hkv, scale, causal, q_offset, dtype,
                        st);
    case 80:
      return launch<80>(q, k, v, kvlen, o, B, S, Tk, Hq, Hkv, scale, causal, q_offset, dtype,
                        st);
    case 128:
      return launch<128>(q, k, v, kvlen, o, B, S, Tk, Hq, Hkv, scale, causal, q_offset,
                         dtype, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
