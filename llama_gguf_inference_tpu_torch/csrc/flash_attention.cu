// Causal flash attention over the offset-indexed KV caches, for Hopper.
//
// Replaces the Pallas TPU kernels of llama_gguf_inference_tpu/ops/
// flash_attention.py, all of which share the body _flash_step:
//
//   lgt_flash_attention          _flash_jit           bf16 (B, KVH, S, D)
//   lgt_flash_attention_q8       _flash_q8_jit bits=8 int8 codes + f32 scales
//   lgt_flash_attention_q4       _flash_q8_jit bits=4 planar nibbles - 8 + scales
//   lgt_flash_attention_q41      _flash_q8_jit asym   planar nibbles + scales + mins
//   lgt_flash_attention_paged    _flash_paged_jit     bf16 pools through a page table
//   lgt_flash_attention_paged_q8 _flash_paged_q8_jit  int8 pools through a page table
//
//   q (B, T, H, D) bf16, offsets (B,) int32 -> out (B, T, H, D) bf16
//
// Query t of sequence b sees logical slots s <= offsets[b] + t. GQA folds the
// group of query heads sharing a KV head into rows r = g*T + t of one block
// column (the (g, t) row order of the reference). The running max, sum and
// output accumulator are f32; q is pre-scaled by 1/sqrt(D); masked scores
// are -1e30 (not -inf), and the output is acc / max(l, 1e-30), as in the
// reference. Blocks stop at the last key any of their rows can see, so cost
// follows the live context, not the allocated S.
//
// One template, two policies:
// - the KV loader (KIND): a K/V row of D elements is RB bytes of codes, bf16
//   (2D), int8 (D) or planar nibbles (D/2: byte j holds element j in its low
//   nibble and element j + D/2 in its high one, biased by 8 for q4_0). The
//   tile is staged in shared memory as codes and each element is decoded
//   when a lane reads it. Per-token scales (and q4_1 minimums) are staged
//   beside it and applied as _flash_step applies them, after the dots:
//   score = (q.c)*ks [+ (sum q)*km]; P.V accumulates (p*vs).c [+ sum p*vm],
//   while l sums the unscaled p.
// - the addressing (PAGED): a logical slot maps to a row of the contiguous
//   (B, KVH, S, .) cache, or of the (P, KVH, page_s, .) pool through
//   page_table[b, s / page_s], looked up per key row (a tile may straddle a
//   page boundary; any page_s works). A -1 entry is clamped to page 0, as in
//   the reference, and never dereferenced.
//
// What bounds it on the card: at decode each layer reads the live K and V
// once, so device-memory bandwidth bounds it (quantized caches move 1/2 or
// about 1/4 of bf16's bytes). Design: one block per (b, kv head, 4 query
// rows), one warp per row. K and V tiles of BS keys are staged in shared
// memory once per block and read by every row of the GQA group; the K tile
// rows are padded by one 32-bit word so that lane i reading key i hits bank
// i. Scores: each lane owns keys (no shuffles per key); P.V: each lane owns
// D/32 output dims. Decode has only B*KVH blocks, so one SM walks each
// sequence's whole cache: splitting S across blocks is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // query rows per block, one warp each

enum Kind { kBF16 = 0, kQ8 = 1, kQ4 = 2, kQ41 = 3 };

struct Args {
  const __nv_bfloat16* q;
  const uint8_t* k;      // K codes (or bf16 bits)
  const uint8_t* v;
  const float* ks;       // per-(row) scales and minimums, indexed like a row
  const float* vs;
  const float* km;
  const float* vm;
  const int* offsets;    // (B,)
  const int* table;      // (B, NP) for paged caches
  __nv_bfloat16* out;
  int T, H, KVH;
  int S;                 // logical slots per sequence (NP * page_s when paged)
  int NP, page_s;
  float scale;
};

template <int KIND, int D>
struct Layout {
  static constexpr int RB = KIND == kBF16 ? 2 * D : KIND == kQ8 ? D : D / 2;
  static constexpr int RBP = RB + 4;       // padded K row in shared memory
  static constexpr int BSX = 16384 / RB;   // keys per tile: 16 KB of codes
  static constexpr int BS = BSX < 32 ? 32 : (BSX > 128 ? 128 : BSX);
  static constexpr bool SCALED = KIND != kBF16;
  static constexpr bool ASYM = KIND == kQ41;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Row index of logical slot pos of (b, kvh): codes at row * RB, scales at row.
template <bool PAGED>
__device__ __forceinline__ size_t row_of(const Args& a, int b, int kvh, int pos) {
  if constexpr (PAGED) {
    const int lp = pos / a.page_s;
    const int phys = max(a.table[(size_t)b * a.NP + lp], 0);
    return ((size_t)phys * a.KVH + kvh) * a.page_s + (pos - lp * a.page_s);
  } else {
    return ((size_t)b * a.KVH + kvh) * a.S + pos;
  }
}

// Signed byte k of a 32-bit word, as float.
__device__ __forceinline__ float sbyte(uint32_t w, int k) {
  return (float)((int32_t)(w << (24 - 8 * k)) >> 24);
}

template <int D, int KIND, bool PAGED>
__global__ void flash_attention_kernel(const Args a) {
  using L = Layout<KIND, D>;
  constexpr int RB = L::RB, RBP = L::RBP, BS = L::BS;
  constexpr int DPL = D / 32;   // output dims per lane
  constexpr int KPL = BS / 32;  // keys per lane per tile
  constexpr int CPR = RB / 16;  // 16-byte chunks per row
  constexpr int NSC = L::SCALED ? BS : 1;
  __shared__ __align__(16) uint8_t kt[BS * RBP];
  __shared__ __align__(16) uint8_t vt[BS * RB];
  __shared__ float qs[kWarps][D];
  __shared__ float ps[kWarps][BS];
  __shared__ float sc_t[4][NSC];  // per-token k scale, v scale, k min, v min

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int group = a.H / a.KVH;
  const int T = a.T, S = a.S;
  const int R = group * T;
  const int r = blockIdx.x * kWarps + warp;
  const bool active = r < R;
  const int t = active ? r % T : 0;
  const int head = kvh * group + (active ? r / T : 0);
  const int off = a.offsets[b];
  const int limit = off + t;  // last visible slot of this row

  int tmax = 0;  // last key any row of this block can see
  for (int w = 0; w < kWarps; ++w) {
    const int rr = blockIdx.x * kWarps + w;
    if (rr < R) tmax = max(tmax, rr % T);
  }
  const int n_tiles = min(S - 1, off + tmax) / BS + 1;

  float qsum = 0.f;  // sum of the pre-scaled q row (q4_1's min term)
  if (active) {
    const __nv_bfloat16* qr = a.q + (((size_t)b * T + t) * a.H + head) * D;
    for (int e = lane; e < D; e += 32) {
      const float x = __bfloat162float(qr[e]) * a.scale;
      qs[warp][e] = x;
      qsum += x;
    }
    if constexpr (L::ASYM) qsum = warp_sum(qsum);
  }

  float m_i = -1e30f, l_i = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int s0 = tile * BS;
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int i = threadIdx.x; i < BS * CPR; i += kWarps * 32) {
      const int row = i / CPR, col = (i % CPR) * 16;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (s0 + row < S) {
        const size_t base = row_of<PAGED>(a, b, kvh, s0 + row) * RB + col;
        kv4 = __ldg(reinterpret_cast<const uint4*>(a.k + base));
        vv4 = __ldg(reinterpret_cast<const uint4*>(a.v + base));
      }
      *reinterpret_cast<uint4*>(vt + row * RB + col) = vv4;
      uint32_t* kd = reinterpret_cast<uint32_t*>(kt + row * RBP + col);
      kd[0] = kv4.x;
      kd[1] = kv4.y;
      kd[2] = kv4.z;
      kd[3] = kv4.w;
    }
    if constexpr (L::SCALED) {
      for (int i = threadIdx.x; i < BS; i += kWarps * 32) {
        float k_s = 0.f, v_s = 0.f, k_m = 0.f, v_m = 0.f;
        if (s0 + i < S) {
          const size_t row = row_of<PAGED>(a, b, kvh, s0 + i);
          k_s = __ldg(a.ks + row);
          v_s = __ldg(a.vs + row);
          if constexpr (L::ASYM) {
            k_m = __ldg(a.km + row);
            v_m = __ldg(a.vm + row);
          }
        }
        sc_t[0][i] = k_s;
        sc_t[1][i] = v_s;
        if constexpr (L::ASYM) {
          sc_t[2][i] = k_m;
          sc_t[3][i] = v_m;
        }
      }
    }
    __syncthreads();
    if (!active || s0 > limit) continue;  // warp-uniform

    float sc[KPL];
    float tile_max = -1e30f;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int s = j * 32 + lane;
      float dot = 0.f;
      if constexpr (KIND == kBF16) {
        const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(kt + s * RBP);
#pragma unroll 8
        for (int e2 = 0; e2 < D / 2; ++e2) {
          const float2 kf = __bfloat1622float2(kr[e2]);
          dot = fmaf(qs[warp][2 * e2], kf.x, dot);
          dot = fmaf(qs[warp][2 * e2 + 1], kf.y, dot);
        }
      } else {
        const uint32_t* kr = reinterpret_cast<const uint32_t*>(kt + s * RBP);
#pragma unroll 8
        for (int w = 0; w < RB / 4; ++w) {
          const uint32_t word = kr[w];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if constexpr (KIND == kQ8) {
              dot = fmaf(qs[warp][4 * w + k], sbyte(word, k), dot);
            } else {
              constexpr float bias = KIND == kQ4 ? 8.f : 0.f;
              const uint32_t byte = (word >> (8 * k)) & 0xffu;
              dot = fmaf(qs[warp][4 * w + k], (float)(byte & 15u) - bias, dot);
              dot = fmaf(qs[warp][D / 2 + 4 * w + k], (float)(byte >> 4) - bias, dot);
            }
          }
        }
        dot *= sc_t[0][s];
        if constexpr (L::ASYM) dot += qsum * sc_t[2][s];
      }
      const int pos = s0 + s;
      sc[j] = (pos <= limit && pos < S) ? dot : -1e30f;
      tile_max = fmaxf(tile_max, sc[j]);
    }
    const float m_new = fmaxf(m_i, warp_max(tile_max));
    const float alpha = expf(m_i - m_new);
    float psum = 0.f, pmin = 0.f;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int s = j * 32 + lane;
      const float p = expf(sc[j] - m_new);
      psum += p;
      if constexpr (L::SCALED) {
        ps[warp][s] = p * sc_t[1][s];
        if constexpr (L::ASYM) pmin = fmaf(p, sc_t[3][s], pmin);
      } else {
        ps[warp][s] = p;
      }
    }
    l_i = l_i * alpha + warp_sum(psum);
    if constexpr (L::ASYM) pmin = warp_sum(pmin);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
    for (int s = 0; s < BS; ++s) {
      const float p = ps[warp][s];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int e = lane + 32 * i;
        float x;
        if constexpr (KIND == kBF16) {
          x = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(vt)[s * D + e]);
        } else if constexpr (KIND == kQ8) {
          x = (float)reinterpret_cast<const int8_t*>(vt)[s * RB + e];
        } else {
          constexpr float bias = KIND == kQ4 ? 8.f : 0.f;
          // 32*i < D/2 decides the plane at compile time: lane < 32 <= D/2
          const uint32_t byte = vt[s * RB + (32 * i < D / 2 ? e : e - D / 2)];
          x = (float)(32 * i < D / 2 ? (byte & 15u) : (byte >> 4)) - bias;
        }
        acc[i] = fmaf(p, x, acc[i]);
      }
    }
    if constexpr (L::ASYM) {
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] += pmin;
    }
    m_i = m_new;
    __syncwarp();  // ps is rewritten by the next tile
  }
  if (active) {
    __nv_bfloat16* orow = a.out + (((size_t)b * T + t) * a.H + head) * D;
    const float l = fmaxf(l_i, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) orow[lane + 32 * i] = __float2bfloat16_rn(acc[i] / l);
  }
}

template <int D, int KIND, bool PAGED>
int launch_d(const Args& a, int B, cudaStream_t stream) {
  const int R = (a.H / a.KVH) * a.T;
  const dim3 grid((R + kWarps - 1) / kWarps, a.KVH, B);
  flash_attention_kernel<D, KIND, PAGED><<<grid, kWarps * 32, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int KIND, bool PAGED>
int launch(const Args& a, int B, int D, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64: return launch_d<64, KIND, PAGED>(a, B, st);
    case 128: return launch_d<128, KIND, PAGED>(a, B, st);
    case 256: return launch_d<256, KIND, PAGED>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* offsets,
               void* out, int T, int H, int KVH, int S, float scale) {
  Args a = {};
  a.q = (const __nv_bfloat16*)q;
  a.k = (const uint8_t*)k;
  a.v = (const uint8_t*)v;
  a.offsets = (const int*)offsets;
  a.out = (__nv_bfloat16*)out;
  a.T = T;
  a.H = H;
  a.KVH = KVH;
  a.S = S;
  a.scale = scale;
  return a;
}

}  // namespace

// Contiguous caches: k/v (B, KVH, S, RB bytes), scales/mins (B, KVH, S).

extern "C" int lgt_flash_attention(const void* q, const void* k, const void* v,
                                   const void* offsets, void* out, int B, int T,
                                   int H, int KVH, int S, int D, float scale,
                                   void* stream) {
  return launch<kBF16, false>(make_args(q, k, v, offsets, out, T, H, KVH, S, scale),
                              B, D, stream);
}

extern "C" int lgt_flash_attention_q8(const void* q, const void* kq, const void* ks,
                                      const void* vq, const void* vs,
                                      const void* offsets, void* out, int B, int T,
                                      int H, int KVH, int S, int D, float scale,
                                      void* stream) {
  Args a = make_args(q, kq, vq, offsets, out, T, H, KVH, S, scale);
  a.ks = (const float*)ks;
  a.vs = (const float*)vs;
  return launch<kQ8, false>(a, B, D, stream);
}

extern "C" int lgt_flash_attention_q4(const void* q, const void* kq, const void* ks,
                                      const void* vq, const void* vs,
                                      const void* offsets, void* out, int B, int T,
                                      int H, int KVH, int S, int D, float scale,
                                      void* stream) {
  Args a = make_args(q, kq, vq, offsets, out, T, H, KVH, S, scale);
  a.ks = (const float*)ks;
  a.vs = (const float*)vs;
  return launch<kQ4, false>(a, B, D, stream);
}

extern "C" int lgt_flash_attention_q41(const void* q, const void* kq, const void* ks,
                                       const void* km, const void* vq,
                                       const void* vs, const void* vm,
                                       const void* offsets, void* out, int B, int T,
                                       int H, int KVH, int S, int D, float scale,
                                       void* stream) {
  Args a = make_args(q, kq, vq, offsets, out, T, H, KVH, S, scale);
  a.ks = (const float*)ks;
  a.vs = (const float*)vs;
  a.km = (const float*)km;
  a.vm = (const float*)vm;
  return launch<kQ41, false>(a, B, D, stream);
}

// Paged pools: k/v (P, KVH, page_s, RB bytes), scales (P, KVH, page_s),
// page_table (B, NP) int32.

extern "C" int lgt_flash_attention_paged(const void* q, const void* k, const void* v,
                                         const void* offsets, const void* table,
                                         void* out, int B, int T, int H, int KVH,
                                         int NP, int page_s, int D, float scale,
                                         void* stream) {
  Args a = make_args(q, k, v, offsets, out, T, H, KVH, NP * page_s, scale);
  a.table = (const int*)table;
  a.NP = NP;
  a.page_s = page_s;
  return launch<kBF16, true>(a, B, D, stream);
}

extern "C" int lgt_flash_attention_paged_q8(const void* q, const void* kq,
                                            const void* ks, const void* vq,
                                            const void* vs, const void* offsets,
                                            const void* table, void* out, int B,
                                            int T, int H, int KVH, int NP,
                                            int page_s, int D, float scale,
                                            void* stream) {
  Args a = make_args(q, kq, vq, offsets, out, T, H, KVH, NP * page_s, scale);
  a.ks = (const float*)ks;
  a.vs = (const float*)vs;
  a.table = (const int*)table;
  a.NP = NP;
  a.page_s = page_s;
  return launch<kQ8, true>(a, B, D, stream);
}
