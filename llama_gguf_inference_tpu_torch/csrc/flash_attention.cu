// Causal flash attention over the offset-indexed KV caches, for Hopper: the
// decode path (fewer query positions than ops/flash_attention.py's
// FLASH_TC_MIN_ROWS, and head_dim 256 at any T).
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
// group of query heads sharing a KV head into rows r = g*T + t (the (g, t)
// row order of the reference). The running max, sum and output accumulator
// are f32; q is pre-scaled by 1/sqrt(D); masked scores are -1e30 (not -inf),
// and the output is acc / max(l, 1e-30) rounded once to bf16, as in the
// reference.
//
// One template, two policies:
// - the KV loader (KIND): a K/V row of D elements is RB bytes of codes, bf16
//   (2D), int8 (D) or planar nibbles (D/2: byte j holds element j in its low
//   nibble and element j + D/2 in its high one, biased by 8 for q4_0). Tiles
//   are staged in shared memory as codes and each element is decoded when a
//   lane reads it. Per-token scales (and q4_1 minimums) are staged beside
//   them and applied as _flash_step applies them, after the dots:
//   score = (q.c)*ks [+ (sum q)*km]; P.V accumulates (p*vs).c [+ sum p*vm],
//   while l sums the unscaled p.
// - the addressing (PAGED): a logical slot maps to a row of the contiguous
//   (B, KVH, S, .) cache, or of the (P, KVH, page_s, .) pool through
//   page_table[b, s / page_s], looked up per key row (a tile may straddle a
//   page boundary; any page_s works). A -1 entry is clamped to page 0, as in
//   the reference, and never dereferenced.
//
// What bounds it on the card: at decode each layer reads the live K and V
// once (quantized caches 1/2 or about 1/4 of bf16's bytes) and does 4 flops
// a (query row, key, dim), so device-memory bandwidth bounds it; the live
// bytes are small (8.4 MB over 32 heads at the smoke's B = 4 decode row), so
// what the card needs is enough blocks in flight, not a faster inner loop.
//
// The split (the TPU kernel walks S as its innermost, sequential grid axis
// and carries (m, l, acc) in scratch; here splits of S run as parallel
// blocks): the grid is (ceil(S / kChunk) * row groups, KVH, B), sized from
// shapes only. A block owns one (b, kv head, row group of kWarps = 4 rows,
// one warp each) and one split of kChunk consecutive keys. It computes its
// sequence's live split count, min(S - 1, off + t_max) / kChunk + 1, from
// offsets on the device, and a block past it exits at once; the host never
// reads offsets, so a launch takes no host decision and can be captured in a
// CUDA graph. Inside a block the split's tiles of BS keys come through a
// 2-slot cp.async ring, the next tile's loads in flight while this one is
// computed; all 4 warps read each K/V tile from shared memory, so the GQA
// group's rows load it once. Scores: each lane owns keys, reading its K row
// in 16-byte chunks (K rows padded by 16 bytes, so the 8 lanes of a
// quarter-warp hit distinct banks) against q chunks read as broadcast
// float4s; P.V: each lane owns D/32 consecutive output dims.
//
// The merge, in the same launch: a (b, kv head, row group) with one live
// split writes out directly. Otherwise each live split writes its rows'
// partial (m, l, acc[D]) in f32 to the scratch the wrapper allocates,
// fences, and bumps the group's arrival counter; the block that arrives
// last merges the splits in split order, m = max m_i, l = sum l_i e^(m_i - m),
// acc = sum acc_i e^(m_i - m), writes acc / max(l, 1e-30) as bf16, and resets
// the counter to 0 for the next launch. A split whose keys all lie past one
// row's last key (T > 1) leaves that row at m = -1e30, l = 0, acc = 0, which
// the merge weighs by e^(-1e30 - m) = 0; split 0 holds key 0, so every row
// has one live split. The counters are a buffer the wrapper keeps per
// device, zeroed once.
//
// kChunk = 256 keys a split: tools/flash_split.py on an H100 (700 W) times
// the six kinds at 128, 256 and 512. Over 1024 slots (B = 4 and B = 1) 128
// takes 7-28% less time than 256; at B = 1 over 8192 slots 256 takes 11-25%
// less than 128 (64 splits a head then, and a longer merge); 512 is slower
// at every shape but one. 256 loses the least at either length.
//
// Registers a thread (nvcc -Xptxas -v, sm_90a, D 64 / 128 / 256): bf16 64 /
// 62 / 64, q8_0 71 / 72 / 74, q4_0 92 / 80 / 80, q4_1 96 / 80 / 96, paged
// bf16 64 / 56 / 48, paged q8_0 72 / 72 / 64. Spills: q4_0 at D = 256 (8
// bytes stored, 24 loaded) and paged bf16 at D 128 and 256 (12 stored, 16
// loaded), each from an 8-byte stack frame; none elsewhere.

#include "tc_common.cuh"

namespace {

constexpr int kWarps = 4;     // query rows a block, one warp each
constexpr int kChunk = 256;   // keys a split

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
  float* part;           // split partials: acc (slots, kWarps, D), then (m, l) (slots, kWarps, 2)
  int* arrivals;         // (B, KVH, row groups) arrival counters, 0 between launches
  int T, H, KVH;
  int S;                 // logical slots per sequence (NP * page_s when paged)
  int NP, page_s;
  float scale;
};

template <int KIND, int D>
struct Layout {
  static constexpr int RB = KIND == kBF16 ? 2 * D : KIND == kQ8 ? D : D / 2;
  static constexpr int RBP = RB + 16;      // padded K row in shared memory
  static constexpr int BSX = 16384 / RB;   // keys per tile: 16 KB of codes
  static constexpr int BS = BSX < 32 ? 32 : (BSX > 128 ? 128 : BSX);
  static constexpr int NSC = KIND == kBF16 ? 0 : KIND == kQ41 ? 4 : 2;  // ks, vs (, km, vm)
  static constexpr int kSlot = BS * RBP + BS * RB + NSC * BS * 4;    // bytes of a ring slot
  static constexpr int kSmem = 2 * kSlot + kWarps * D * 4 + kWarps * BS * 4 + 16;
  static_assert(kChunk % BS == 0, "a split is whole tiles");
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

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// NB bytes (2, 4, 8 or 16) of shared memory at p, in words (the low half of
// w[0] for 2).
template <int NB>
__device__ __forceinline__ void lane_bytes(const unsigned char* p, uint32_t (&w)[(NB + 3) / 4]) {
  if constexpr (NB == 16) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  } else if constexpr (NB == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x; w[1] = x.y;
  } else if constexpr (NB == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  }
}

// N floats (a multiple of 2) to or from global memory in float4 / float2 steps.
template <int N>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<float4*>(p)[i] = float4{v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]};
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) reinterpret_cast<float2*>(p)[i] = float2{v[2 * i], v[2 * i + 1]};
  }
}

template <int N>
__device__ __forceinline__ void load_f32_cg(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 x = __ldcg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = x.x; v[4 * i + 1] = x.y; v[4 * i + 2] = x.z; v[4 * i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 x = __ldcg(reinterpret_cast<const float2*>(p) + i);
      v[2 * i] = x.x; v[2 * i + 1] = x.y;
    }
  }
}

// acc / max(l, 1e-30) as bf16 into dims lane*N.. of out row o.
template <int N>
__device__ __forceinline__ void write_out(__nv_bfloat16* o, const float (&acc)[N], float l) {
  const float d = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(acc[2 * i] / d, acc[2 * i + 1] / d);
    reinterpret_cast<uint32_t*>(o)[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
}

template <int D, int KIND, bool PAGED>
__global__ void __launch_bounds__(kWarps * 32) flash_attention_kernel(const Args a) {
  using L = Layout<KIND, D>;
  constexpr int RB = L::RB, RBP = L::RBP, BS = L::BS, NSC = L::NSC;
  constexpr int DPL = D / 32;   // output dims per lane: lane*DPL ..
  constexpr int KPL = BS / 32;  // keys per lane per tile
  constexpr int CPR = RB / 16;  // 16-byte chunks per row
  constexpr int VB = KIND == kBF16 ? 2 * DPL : DPL;  // V bytes a lane reads a key
  extern __shared__ __align__(16) unsigned char smem[];
  float* const qs = reinterpret_cast<float*>(smem + 2 * L::kSlot);  // kWarps x D
  float* const ps = qs + kWarps * D;                                 // kWarps x BS
  int* const last_flag = reinterpret_cast<int*>(ps + kWarps * BS);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int group = a.H / a.KVH;
  const int T = a.T, S = a.S;
  const int R = group * T;
  const int RG = (R + kWarps - 1) / kWarps;
  const int rg = blockIdx.x % RG, split = blockIdx.x / RG;
  const int r = rg * kWarps + warp;
  const bool active = r < R;
  const int t = active ? r % T : 0;
  const int head = kvh * group + (active ? r / T : 0);
  const int off = a.offsets[b];
  const int limit = off + t;  // last visible slot of this row

  int tmax = 0;  // last t of the group's rows
  for (int w = 0; w < kWarps; ++w) {
    const int rr = rg * kWarps + w;
    if (rr < R) tmax = max(tmax, rr % T);
  }
  const int last = min(S - 1, off + tmax);  // last key any row of the group sees
  const int n_split = last / kChunk + 1;    // the group's live splits
  if (split >= n_split) return;             // block-uniform
  const int c0 = split * kChunk;
  const int c_last = min(last, c0 + kChunk - 1);
  const int n_tiles = (c_last - c0) / BS + 1;

  // the loads of tile j of the split into ring slot j % 2; keys past the
  // split's last live one are zero-filled, not read
  auto load = [&](int j) {
    unsigned char* kd = smem + (j & 1) * L::kSlot;
    unsigned char* vd = kd + BS * RBP;
    float* sd = reinterpret_cast<float*>(vd + BS * RB);
    const int s0 = c0 + j * BS;
    for (int i = threadIdx.x; i < BS * CPR; i += kWarps * 32) {
      const int row = i / CPR, col = (i % CPR) * 16;
      const bool ok = s0 + row <= c_last;
      const size_t base = ok ? row_of<PAGED>(a, b, kvh, s0 + row) * RB + col : 0;
      cp_async16(kd + row * RBP + col, a.k + base, ok);
      cp_async16(vd + row * RB + col, a.v + base, ok);
    }
    if constexpr (NSC > 0) {
      for (int i = threadIdx.x; i < NSC * BS; i += kWarps * 32) {
        const int vec = i / BS, row = i % BS;
        const bool ok = s0 + row <= c_last;
        const size_t rr = ok ? row_of<PAGED>(a, b, kvh, s0 + row) : 0;
        const float* src = vec == 0 ? a.ks : vec == 1 ? a.vs : vec == 2 ? a.km : a.vm;
        cp_async4(sd + i, src + rr, ok);
      }
    }
  };
  load(0);
  cp_async_commit();

  float qsum = 0.f;  // sum of the pre-scaled q row (q4_1's min term)
  if (active) {
    const __nv_bfloat16* qr = a.q + (((size_t)b * T + t) * a.H + head) * D;
    for (int e = lane; e < D; e += 32) {
      const float x = __bfloat162float(qr[e]) * a.scale;
      qs[warp * D + e] = x;
      qsum += x;
    }
    if constexpr (KIND == kQ41) qsum = warp_sum(qsum);
  }
  const float* qw = qs + warp * D;
  float* pw = ps + warp * BS;

  float m_i = -1e30f, l_i = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load(j + 1);
    cp_async_commit();
    cp_async_wait<1>();   // tile j has landed (and qs is written)
    __syncthreads();
    const int s0 = c0 + j * BS;
    const unsigned char* kt = smem + (j & 1) * L::kSlot;
    const unsigned char* vt = kt + BS * RBP;
    const float* sc = reinterpret_cast<const float*>(vt + BS * RB);
    if (active && s0 <= limit) {  // warp-uniform
      // scores: lane owns keys jk*32 + lane, its K row read in 16-byte chunks
      float dot[KPL];
#pragma unroll
      for (int jk = 0; jk < KPL; ++jk) dot[jk] = 0.f;
#pragma unroll 4
      for (int c = 0; c < CPR; ++c) {
        if constexpr (KIND == kBF16) {
          const float4 q0 = reinterpret_cast<const float4*>(qw + 8 * c)[0];
          const float4 q1 = reinterpret_cast<const float4*>(qw + 8 * c)[1];
#pragma unroll
          for (int jk = 0; jk < KPL; ++jk) {
            const uint4 w = *reinterpret_cast<const uint4*>(kt + (jk * 32 + lane) * RBP + 16 * c);
            float d = dot[jk];
            d = fmaf(q0.x, bf_lo(w.x), d);
            d = fmaf(q0.y, bf_hi(w.x), d);
            d = fmaf(q0.z, bf_lo(w.y), d);
            d = fmaf(q0.w, bf_hi(w.y), d);
            d = fmaf(q1.x, bf_lo(w.z), d);
            d = fmaf(q1.y, bf_hi(w.z), d);
            d = fmaf(q1.z, bf_lo(w.w), d);
            d = fmaf(q1.w, bf_hi(w.w), d);
            dot[jk] = d;
          }
        } else if constexpr (KIND == kQ8) {
          float qv[16];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 x = reinterpret_cast<const float4*>(qw + 16 * c)[i];
            qv[4 * i] = x.x; qv[4 * i + 1] = x.y; qv[4 * i + 2] = x.z; qv[4 * i + 3] = x.w;
          }
#pragma unroll
          for (int jk = 0; jk < KPL; ++jk) {
            const uint4 w4 = *reinterpret_cast<const uint4*>(kt + (jk * 32 + lane) * RBP + 16 * c);
            const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
            float d = dot[jk];
#pragma unroll
            for (int e = 0; e < 16; ++e) d = fmaf(qv[e], sbyte(w[e / 4], e % 4), d);
            dot[jk] = d;
          }
        } else {
          // bytes 16c.. hold elements 16c.. (low nibbles) and D/2 + 16c.. (high)
          constexpr float bias = KIND == kQ4 ? 8.f : 0.f;
          float ql[16], qh[16];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 x = reinterpret_cast<const float4*>(qw + 16 * c)[i];
            const float4 y = reinterpret_cast<const float4*>(qw + D / 2 + 16 * c)[i];
            ql[4 * i] = x.x; ql[4 * i + 1] = x.y; ql[4 * i + 2] = x.z; ql[4 * i + 3] = x.w;
            qh[4 * i] = y.x; qh[4 * i + 1] = y.y; qh[4 * i + 2] = y.z; qh[4 * i + 3] = y.w;
          }
#pragma unroll
          for (int jk = 0; jk < KPL; ++jk) {
            const uint4 w4 = *reinterpret_cast<const uint4*>(kt + (jk * 32 + lane) * RBP + 16 * c);
            const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
            float d = dot[jk];
#pragma unroll
            for (int e = 0; e < 16; ++e) {
              const uint32_t byte = (w[e / 4] >> (8 * (e % 4))) & 0xffu;
              d = fmaf(ql[e], (float)(byte & 15u) - bias, d);
              d = fmaf(qh[e], (float)(byte >> 4) - bias, d);
            }
            dot[jk] = d;
          }
        }
      }
      float tile_max = -1e30f;
#pragma unroll
      for (int jk = 0; jk < KPL; ++jk) {
        const int s = jk * 32 + lane;
        float x = dot[jk];
        if constexpr (NSC > 0) x *= sc[s];
        if constexpr (KIND == kQ41) x += qsum * sc[2 * BS + s];
        const int pos = s0 + s;
        dot[jk] = (pos <= limit && pos < S) ? x : -1e30f;
        tile_max = fmaxf(tile_max, dot[jk]);
      }
      const float m_new = fmaxf(m_i, warp_max(tile_max));
      const float alpha = expf(m_i - m_new);
      float psum = 0.f, pmin = 0.f;
#pragma unroll
      for (int jk = 0; jk < KPL; ++jk) {
        const int s = jk * 32 + lane;
        const float p = expf(dot[jk] - m_new);
        psum += p;
        if constexpr (NSC > 0) {
          pw[s] = p * sc[BS + s];
          if constexpr (KIND == kQ41) pmin = fmaf(p, sc[3 * BS + s], pmin);
        } else {
          pw[s] = p;
        }
      }
      l_i = l_i * alpha + warp_sum(psum);
      if constexpr (KIND == kQ41) pmin = warp_sum(pmin);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
      // P.V: lane owns dims lane*DPL .. of every key row; for the nibbles
      // lanes 0-15 read the low plane and 16-31 the same bytes' high one
      const int vcol = KIND == kBF16 || KIND == kQ8 ? lane * VB : (lane & 15) * VB;
#pragma unroll 2
      for (int s = 0; s < BS; s += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(pw + s);
        const float pk[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          uint32_t w[(VB + 3) / 4];
          lane_bytes<VB>(vt + (s + u) * RB + vcol, w);
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            float x;
            if constexpr (KIND == kBF16) {
              x = i % 2 ? bf_hi(w[i / 2]) : bf_lo(w[i / 2]);
            } else if constexpr (KIND == kQ8) {
              x = sbyte(w[i / 4], i % 4);
            } else {
              constexpr float bias = KIND == kQ4 ? 8.f : 0.f;
              const uint32_t byte = (w[i / 4] >> (8 * (i % 4))) & 0xffu;
              x = (float)(lane < 16 ? (byte & 15u) : (byte >> 4)) - bias;
            }
            acc[i] = fmaf(pk[u], x, acc[i]);
          }
        }
      }
      if constexpr (KIND == kQ41) {
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[i] += pmin;
      }
      m_i = m_new;
    }
    __syncthreads();  // every warp is done with slot j % 2 (and its ps)
  }

  __nv_bfloat16* orow =
      a.out + (((size_t)b * T + t) * a.H + head) * D + lane * DPL;
  if (n_split == 1) {
    if (active) write_out<DPL>(orow, acc, l_i);
    return;
  }

  // partials of this split, then the arrival; the last split merges
  const size_t n_slots = (size_t)gridDim.z * a.KVH * gridDim.x;   // (b, kvh, rg, split)
  const size_t grp = ((size_t)b * a.KVH + kvh) * RG + rg;          // the (b, kvh, rg) group
  const int nch = gridDim.x / RG;                                   // splits a group in the grid
  float* const pacc = a.part;
  float* const pml = a.part + n_slots * kWarps * D;
  auto row_slot = [&](int sp) { return (grp * nch + sp) * kWarps + warp; };
  if (active) {
    const float ml[2] = {m_i, l_i};
    store_f32<DPL>(pacc + row_slot(split) * D + lane * DPL, acc);
    if (lane == 0) store_f32<2>(pml + row_slot(split) * 2, ml);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int prev = atomicAdd(a.arrivals + grp, 1);
    *last_flag = prev == n_split - 1;
    if (prev == n_split - 1) a.arrivals[grp] = 0;  // reset for the next launch
  }
  __syncthreads();
  if (!*last_flag || !active) return;
  __threadfence();

  float m = -1e30f;
  for (int sp = lane; sp < n_split; sp += 32) m = fmaxf(m, __ldcg(pml + row_slot(sp) * 2));
  m = warp_max(m);
  float l = 0.f, o[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) o[i] = 0.f;
  for (int sp = 0; sp < n_split; ++sp) {
    float ml[2], ac[DPL];
    load_f32_cg<2>(pml + row_slot(sp) * 2, ml);
    load_f32_cg<DPL>(pacc + row_slot(sp) * D + lane * DPL, ac);
    const float w = expf(ml[0] - m);
    l = fmaf(ml[1], w, l);
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[i] = fmaf(ac[i], w, o[i]);
  }
  write_out<DPL>(orow, o, l);
}

template <int D, int KIND, bool PAGED>
int launch_d(const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = Layout<KIND, D>::kSmem;
  static CardCache cards;   // the shared-memory opt-in, set per device on first use
  Card c;
  const int rc = cards.get(flash_attention_kernel<D, KIND, PAGED>, smem, c);
  if (rc != 0) return rc;
  if (smem > c.smem_block) return (int)cudaErrorInvalidValue;
  const int R = (a.H / a.KVH) * a.T;
  const int n_chunks = (a.S + kChunk - 1) / kChunk;
  const dim3 grid(n_chunks * ((R + kWarps - 1) / kWarps), a.KVH, B);
  flash_attention_kernel<D, KIND, PAGED><<<grid, kWarps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int KIND, bool PAGED>
int launch(const Args& a, int B, int D, int split, void* stream) {
  if (split != kChunk) return (int)cudaErrorInvalidValue;  // the wrapper sized part for another
  if (B == 0 || a.T == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64: return launch_d<64, KIND, PAGED>(a, B, st);
    case 128: return launch_d<128, KIND, PAGED>(a, B, st);
    case 256: return launch_d<256, KIND, PAGED>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* offsets,
               void* out, void* part, void* arrivals, int T, int H, int KVH, int S,
               float scale) {
  Args a = {};
  a.q = (const __nv_bfloat16*)q;
  a.k = (const uint8_t*)k;
  a.v = (const uint8_t*)v;
  a.offsets = (const int*)offsets;
  a.out = (__nv_bfloat16*)out;
  a.part = (float*)part;
  a.arrivals = (int*)arrivals;
  a.T = T;
  a.H = H;
  a.KVH = KVH;
  a.S = S;
  a.scale = scale;
  return a;
}

}  // namespace

// Every entry point takes, after out, the partials' scratch (f32, at least
// B * KVH * row groups * ceil(S / split) * 4 * (D + 2) floats, row groups =
// ceil(H / KVH * T / 4)), the arrival counters (int32, B * KVH * row groups,
// all 0), and after D the split length the wrapper sized them for
// (kChunk, else cudaErrorInvalidValue).
//
// Contiguous caches: k/v (B, KVH, S, RB bytes), scales/mins (B, KVH, S).

extern "C" int lgt_flash_attention(const void* q, const void* k, const void* v,
                                   const void* offsets, void* out, void* part,
                                   void* arrivals, int B, int T, int H, int KVH, int S,
                                   int D, int split, float scale, void* stream) {
  return launch<kBF16, false>(
      make_args(q, k, v, offsets, out, part, arrivals, T, H, KVH, S, scale), B, D, split,
      stream);
}

extern "C" int lgt_flash_attention_q8(const void* q, const void* kq, const void* ks,
                                      const void* vq, const void* vs,
                                      const void* offsets, void* out, void* part,
                                      void* arrivals, int B, int T, int H, int KVH, int S,
                                      int D, int split, float scale, void* stream) {
  Args a = make_args(q, kq, vq, offsets, out, part, arrivals, T, H, KVH, S, scale);
  a.ks = (const float*)ks;
  a.vs = (const float*)vs;
  return launch<kQ8, false>(a, B, D, split, stream);
}

extern "C" int lgt_flash_attention_q4(const void* q, const void* kq, const void* ks,
                                      const void* vq, const void* vs,
                                      const void* offsets, void* out, void* part,
                                      void* arrivals, int B, int T, int H, int KVH, int S,
                                      int D, int split, float scale, void* stream) {
  Args a = make_args(q, kq, vq, offsets, out, part, arrivals, T, H, KVH, S, scale);
  a.ks = (const float*)ks;
  a.vs = (const float*)vs;
  return launch<kQ4, false>(a, B, D, split, stream);
}

extern "C" int lgt_flash_attention_q41(const void* q, const void* kq, const void* ks,
                                       const void* km, const void* vq,
                                       const void* vs, const void* vm,
                                       const void* offsets, void* out, void* part,
                                       void* arrivals, int B, int T, int H, int KVH, int S,
                                       int D, int split, float scale, void* stream) {
  Args a = make_args(q, kq, vq, offsets, out, part, arrivals, T, H, KVH, S, scale);
  a.ks = (const float*)ks;
  a.vs = (const float*)vs;
  a.km = (const float*)km;
  a.vm = (const float*)vm;
  return launch<kQ41, false>(a, B, D, split, stream);
}

// Paged pools: k/v (P, KVH, page_s, RB bytes), scales (P, KVH, page_s),
// page_table (B, NP) int32.

extern "C" int lgt_flash_attention_paged(const void* q, const void* k, const void* v,
                                         const void* offsets, const void* table,
                                         void* out, void* part, void* arrivals, int B,
                                         int T, int H, int KVH, int NP, int page_s, int D,
                                         int split, float scale, void* stream) {
  Args a = make_args(q, k, v, offsets, out, part, arrivals, T, H, KVH, NP * page_s, scale);
  a.table = (const int*)table;
  a.NP = NP;
  a.page_s = page_s;
  return launch<kBF16, true>(a, B, D, split, stream);
}

extern "C" int lgt_flash_attention_paged_q8(const void* q, const void* kq,
                                            const void* ks, const void* vq,
                                            const void* vs, const void* offsets,
                                            const void* table, void* out, void* part,
                                            void* arrivals, int B, int T, int H, int KVH,
                                            int NP, int page_s, int D, int split,
                                            float scale, void* stream) {
  Args a = make_args(q, kq, vq, offsets, out, part, arrivals, T, H, KVH, NP * page_s, scale);
  a.ks = (const float*)ks;
  a.vs = (const float*)vs;
  a.table = (const int*)table;
  a.NP = NP;
  a.page_s = page_s;
  return launch<kQ8, true>(a, B, D, split, stream);
}
