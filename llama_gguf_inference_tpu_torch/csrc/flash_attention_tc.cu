// Causal flash attention for prefill-sized query counts on tensor cores, for
// Hopper (sm_90a).
//
// Replaces, from ops/flash_attention.py's FLASH_TC_MIN_ROWS query positions
// up, these TPU kernels of llama_gguf_inference_tpu/ops/flash_attention.py,
// all of which share the body _flash_step (:52-118):
//
//   lgt_flash_attention_tc          _flash_jit (:129)            bf16 (B, KVH, S, D)
//   lgt_flash_attention_q8_tc       _flash_q8_jit bits 8 (:189)  int8 codes + f32 scales
//   lgt_flash_attention_q4_tc       _flash_q8_jit bits 4         planar nibbles - 8 + scales
//   lgt_flash_attention_q41_tc      _flash_q8_jit bits 4 asym    planar nibbles + scales + mins
//   lgt_flash_attention_paged_tc    _flash_paged_jit (:302)      bf16 pools, page table
//   lgt_flash_attention_paged_q8_tc _flash_paged_q8_jit (:383)   int8 pools, page table
//
//   q (B, T, H, D) bf16, offsets (B,) int32 -> out (B, T, H, D) bf16, D 64 or 128
//
// Fewer query positions (decode) and D = 256 run flash_attention.cu's
// kernel. Both compute what _flash_step computes: query t of sequence b sees
// logical slots s <= offsets[b] + t; the G query heads sharing a KV head are
// rows r = g*T + t of one (b, kv head) problem (the reference's (g, t) row
// order); masked scores are -1e30, not -inf; the running max and sum are
// f32; the scales come after the dots, score = (q.c)*ks*scale [+ qsum*km]
// and P.V accumulates (p*vs).c [+ sum p*vm] while l sums the unscaled p;
// out = acc / max(l, 1e-30); a block stops at the last key its rows see; a
// paged row is looked up per key row, a -1 entry read as page 0 and never
// dereferenced. The JAX package builds no 4-bit paged pool, nor does the
// port, so q4_0 and q4_1 are contiguous only.
//
// What bounds it: at T = 512 the operations (4*H*D per (query, key) pair
// over 989 TFLOP/s bf16), not the cache bytes: each KV head's keys serve G*T
// query rows. The CUDA-core kernel stages each K/V tile once per 4 query
// rows and forms every dot on CUDA cores; this one stages it once per 64
// rows and forms both products on tensor cores.
//
// Design (a simple tensor-core kernel; TMA and wgmma are later work):
// - A block of 4 warps owns one (b, kv head) and 64 consecutive rows r, 16 a
//   warp: a tile spans one head's t's (two heads' where T % 64 != 0). Folding
//   the G heads of one t into a tile instead would stage the same key tiles
//   (at T = 512, offset 1024, G = 4: 656 per kv head either way) and mask the
//   same share of its last tile, and would tie the tile to G dividing 64;
//   the (g, t) order takes any G and T. Blocks take their row tiles last
//   first, so the ones that walk the most keys start first.
// - K and V tiles of 64 keys come through a 2-slot cp.async ring, the next
//   tile's loads in flight while this one is multiplied. bf16 rows are
//   padded to D + 8 elements, so the 8 rows an ldmatrix reads fall on
//   distinct banks. The q8_0, q4_0 and q4_1 codes (64 keys x D or D/2
//   bytes) land raw in a ring of their own, with their per-token scales
//   (ks, vs, and for q4_1 km, vm; 4-byte cp.async), and are converted to
//   bf16 into one K and one V tile before the products: exact, since
//   |c| <= 127. A nibble byte j gives column j (low) and j + D/2 (high),
//   minus 8 for q4_0.
// - q4_1's minimums, as _flash_step folds them (:94-96, :108-110): each
//   score adds qsum_row * km[key], qsum_row the f32 sum of the row's
//   pre-scaled q, taken once from the Q tile; after the alpha rescale each
//   row adds sum_k p_k * vm_k, from the f32 p reduced over the quad (not
//   rounded to bf16), to every output dim.
// - S = Q.K^T: mma.sync.m16n8k16 bf16 with f32 accumulators; a warp's Q
//   fragments (its 16 rows, unscaled bf16) are read once with ldmatrix and
//   stay in registers for the whole walk; K by ldmatrix. The scores are then
//   scaled by (ks and) 1/sqrt(D) in f32.
// - Online softmax in registers: a lane holds two rows' scores, each row's
//   max and sum reduced across the four lanes of its quad.
// - O += P.V: P (times vs) is re-packed from the score accumulators into
//   bf16 A fragments in registers, the one rounding the reference does not
//   make; V by ldmatrix.trans. A warp skips the 16-key steps past its rows'
//   last visible key.
// - Dynamic shared memory a block (kSmem; contiguous and paged alike), at
//   D 64 / 128: bf16 46080 / 87040 bytes, q8_0 45056 / 86016, q4_0 36864 /
//   69632, q4_1 37888 / 70656: two blocks an SM at D = 128.

#include "tc_common.cuh"

namespace {

constexpr int kFRows = 64;      // query rows a block, 16 a warp
constexpr int kFKeys = 64;      // keys a tile
constexpr int kFThreads = 128;  // 4 warps

enum FKind { kFBF16 = 0, kFQ8 = 1, kFQ4 = 2, kFQ41 = 3 };

struct FArgs {
  const __nv_bfloat16* q;
  const uint8_t* k;      // K codes (bf16 bits, int8 or nibbles), (B, KVH, S, .) or (P, KVH, page_s, .)
  const uint8_t* v;
  const float* ks;       // quantized kinds: per-row scales (q4_1: and minimums), indexed like a row
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

template <int D, int KIND>
struct FLayout {
  static constexpr int kPitch = D + 8;                  // bf16 a row of the Q, K and V tiles
  static constexpr int kTile = kFKeys * kPitch * 2;     // bytes of one K or V tile
  static constexpr int kQ = kFRows * kPitch * 2;        // bytes of the Q tile
  static constexpr int kSlots = KIND == kFBF16 ? 2 : 1; // bf16 K/V tiles (the ring for bf16)
  static constexpr int kRB = KIND == kFBF16 ? 2 * D : KIND == kFQ8 ? D : D / 2;  // bytes a cache row
  static constexpr int kCodes = kFKeys * kRB;           // quantized: bytes of one K or V code tile
  static constexpr int kNV = KIND == kFBF16 ? 0 : KIND == kFQ41 ? 4 : 2;  // ks, vs (, km, vm)
  static constexpr int kSmem = kQ + 2 * kSlots * kTile
                               + (KIND == kFBF16 ? 0 : 2 * (2 * kCodes + kNV * kFKeys * 4));
};

// Row index of logical slot pos of (b, kvh): codes at row * row bytes,
// scales at row.
template <bool PAGED>
__device__ __forceinline__ size_t frow(const FArgs& a, int b, int kvh, int pos) {
  if constexpr (PAGED) {
    const int lp = pos / a.page_s;
    const int phys = max(a.table[(size_t)b * a.NP + lp], 0);
    return ((size_t)phys * a.KVH + kvh) * a.page_s + (pos - lp * a.page_s);
  } else {
    return ((size_t)b * a.KVH + kvh) * a.S + pos;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The last t among rows [r, r + n) of the (g, t) order with T positions.
__device__ __forceinline__ int last_t(int r, int n, int T) {
  const int lo = r % T;
  return lo + n - 1 >= T ? T - 1 : lo + n - 1;
}

template <int D, int KIND, bool PAGED>
__global__ void __launch_bounds__(kFThreads)
flash_attention_tc_kernel(const FArgs a) {
  using L = FLayout<D, KIND>;
  constexpr int P = L::kPitch;
  constexpr int RB = L::kRB;                        // bytes a cache row
  constexpr int NV = L::kNV;                        // per-token vectors a key
  constexpr int KT = D / 16;                        // k16 steps over D
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const qs = smem;
  unsigned char* const kt = qs + L::kQ;                      // kSlots x (64 x P) bf16
  unsigned char* const vt = kt + L::kSlots * L::kTile;
  unsigned char* const cs = vt + L::kSlots * L::kTile;       // quantized: 2 x (K codes, V codes)
  float* const ss = reinterpret_cast<float*>(cs + 2 * 2 * L::kCodes);  // 2 x (ks, vs (, km, vm))

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int G = a.H / a.KVH, T = a.T, R = G * T;
  const int r0 = ((R + kFRows - 1) / kFRows - 1 - (int)blockIdx.x) * kFRows;
  const int off = a.offsets[b];
  const int last = min(a.S - 1, off + last_t(r0, min(kFRows, R - r0), T));
  const int n_tiles = last / kFKeys + 1;

  // this warp's rows wr0.. (none where wr0 >= R) and the last key they see;
  // this lane's two rows, wr0 + lane/4 and 8 more, and their last keys
  const int wr0 = r0 + 16 * warp;
  const int warp_last = wr0 < R ? min(a.S - 1, off + last_t(wr0, min(16, R - wr0), T)) : -1;
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + (lane >> 2) + 8 * h;
    lim[h] = min(a.S - 1, off + (r < R ? r % T : 0));
  }

  // the Q tile: rows r0.. of the (g, t) order, zeros past R
  for (int c = tid; c < kFRows * D / 8; c += kFThreads) {
    const int i = c / (D / 8), col = (c % (D / 8)) * 8;
    const int r = r0 + i;
    const bool ok = r < R;
    const __nv_bfloat16* src = a.q;
    if (ok) {
      const int g = r / T, t = r - g * T;
      src = a.q + (((size_t)b * T + t) * a.H + kvh * G + g) * D + col;
    }
    cp_async16(qs + (i * P + col) * 2, src, ok);
  }

  // the loads of tile j into ring slot j % 2: keys past the block's last
  // are zero-filled, not read
  auto load = [&](int j) {
    const int s0 = j * kFKeys;
    if constexpr (KIND == kFBF16) {
      unsigned char* kd = kt + (j & 1) * L::kTile;
      unsigned char* vd = vt + (j & 1) * L::kTile;
      for (int c = tid; c < kFKeys * D / 8; c += kFThreads) {
        const int key = c / (D / 8), col = (c % (D / 8)) * 8;
        const bool ok = s0 + key <= last;
        const size_t base = ok ? frow<PAGED>(a, b, kvh, s0 + key) * RB + col * 2 : 0;
        cp_async16(kd + (key * P + col) * 2, a.k + base, ok);
        cp_async16(vd + (key * P + col) * 2, a.v + base, ok);
      }
    } else {
      unsigned char* kd = cs + (j & 1) * 2 * L::kCodes;
      unsigned char* vd = kd + L::kCodes;
      for (int c = tid; c < kFKeys * RB / 16; c += kFThreads) {
        const int key = c / (RB / 16), col = (c % (RB / 16)) * 16;
        const bool ok = s0 + key <= last;
        const size_t base = ok ? frow<PAGED>(a, b, kvh, s0 + key) * RB + col : 0;
        cp_async16(kd + key * RB + col, a.k + base, ok);
        cp_async16(vd + key * RB + col, a.v + base, ok);
      }
      // the keys' scale vectors, one 4-byte copy a (vector, key): ks, vs (, km, vm)
      for (int i = tid; i < NV * kFKeys; i += kFThreads) {
        const int vec = i / kFKeys, key = i % kFKeys;
        const bool ok = s0 + key <= last;
        const size_t row = ok ? frow<PAGED>(a, b, kvh, s0 + key) : 0;
        const float* src = vec == 0 ? a.ks : vec == 1 ? a.vs : vec == 2 ? a.km : a.vm;
        cp_async4(ss + (j & 1) * NV * kFKeys + i, src + row, ok);
      }
    }
  };
  load(0);
  cp_async_commit();

  uint32_t qf[KT][4];
  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m_i[2] = {-1e30f, -1e30f}, l_i[2] = {0.f, 0.f};   // l: this lane's share
  float qsum[2] = {0.f, 0.f};   // q4_1: the f32 sums of this lane's two rows' pre-scaled q

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load(j + 1);
    cp_async_commit();
    cp_async_wait<1>();   // tile j (and, at j = 0, Q) has landed
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        ldmatrix_x4(qf[kk], qs + ((16 * warp + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8) * 2);
      if constexpr (KIND == kFQ41) {
        // a quad's four lanes sum a quarter of each of its two rows each
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const __nv_bfloat16* qrow = reinterpret_cast<const __nv_bfloat16*>(qs) +
                                      (16 * warp + (lane >> 2) + 8 * h) * P + (lane & 3) * (D / 4);
          float sum = 0.f;
          for (int e = 0; e < D / 4; ++e) sum += __bfloat162float(qrow[e]) * a.scale;
          qsum[h] = quad_sum(sum);
        }
      }
    }
    const unsigned char* ktile = kt + (KIND == kFBF16 ? (j & 1) * L::kTile : 0);
    const unsigned char* vtile = vt + (KIND == kFBF16 ? (j & 1) * L::kTile : 0);
    const float* kss = ss + (j & 1) * NV * kFKeys;   // ks, vs (, km, vm) of the tile's keys
    if constexpr (KIND != kFBF16) {
      // the slot's codes to bf16 K and V tiles, 16 code bytes a chunk
      const unsigned char* kc = cs + (j & 1) * 2 * L::kCodes;
      for (int c = tid; c < 2 * kFKeys * RB / 16; c += kFThreads) {
        const int half = c / (kFKeys * RB / 16), cc = c % (kFKeys * RB / 16);
        const int key = cc / (RB / 16), col = (cc % (RB / 16)) * 16;
        const uint4 w = *reinterpret_cast<const uint4*>(kc + half * L::kCodes + key * RB + col);
        unsigned char* row = (half ? vt : kt) + key * P * 2;
        if constexpr (KIND == kFQ8) {
          const int8_t* cb = reinterpret_cast<const int8_t*>(&w);
          uint32_t pk[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) pk[e] = pack_bf16((float)cb[2 * e], (float)cb[2 * e + 1]);
          uint4* dst = reinterpret_cast<uint4*>(row + col * 2);
          dst[0] = uint4{pk[0], pk[1], pk[2], pk[3]};
          dst[1] = uint4{pk[4], pk[5], pk[6], pk[7]};
        } else {
          // byte col + e: low nibble to column col + e, high to col + e + D/2
          constexpr float bias = KIND == kFQ4 ? 8.f : 0.f;
          const uint8_t* cb = reinterpret_cast<const uint8_t*>(&w);
          uint32_t lo[8], hi[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            lo[e] = pack_bf16((float)(cb[2 * e] & 15) - bias, (float)(cb[2 * e + 1] & 15) - bias);
            hi[e] = pack_bf16((float)(cb[2 * e] >> 4) - bias, (float)(cb[2 * e + 1] >> 4) - bias);
          }
          uint4* dl = reinterpret_cast<uint4*>(row + col * 2);
          uint4* dh = reinterpret_cast<uint4*>(row + (col + D / 2) * 2);
          dl[0] = uint4{lo[0], lo[1], lo[2], lo[3]};
          dl[1] = uint4{lo[4], lo[5], lo[6], lo[7]};
          dh[0] = uint4{hi[0], hi[1], hi[2], hi[3]};
          dh[1] = uint4{hi[4], hi[5], hi[6], hi[7]};
        }
      }
      __syncthreads();
    }

    const int s0 = j * kFKeys;
    if (s0 <= warp_last) {   // warp-uniform
      // S = Q.K^T over this tile's 64 keys: n8 tiles nt, key pairs np of 16
      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (s0 + np * 16 > warp_last) continue;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          const int row = np * 16 + (lane & 7) + ((lane >> 4) << 3);
          const int col = kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t r[4];
          ldmatrix_x4(r, ktile + (row * P + col) * 2);
          mma_bf16(s[2 * np], qf[kk], r[0], r[1]);
          mma_bf16(s[2 * np + 1], qf[kk], r[2], r[3]);
        }
      }
      // scale, mask, online softmax; accumulator (nt, e) is row lane/4 (+8
      // for e >= 2), key s0 + nt*8 + (lane%4)*2 + e%2
      float mx[2] = {-1e30f, -1e30f};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = nt * 8 + (lane & 3) * 2 + (e & 1);
          float x = s[nt][e];
          if constexpr (KIND != kFBF16) x *= kss[kl];
          x *= a.scale;
          if constexpr (KIND == kFQ41) x += qsum[e >> 1] * kss[2 * kFKeys + kl];
          s[nt][e] = s0 + kl <= lim[e >> 1] ? x : -1e30f;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m_i[h], quad_max(mx[h]));
        alpha[h] = expf(m_i[h] - m_new);
        m_i[h] = m_new;
      }
      float ls[2] = {0.f, 0.f}, pm[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[nt][e] - m_i[e >> 1]);
          ls[e >> 1] += p;
          if constexpr (KIND == kFQ41)
            pm[e >> 1] = fmaf(p, kss[3 * kFKeys + nt * 8 + (lane & 3) * 2 + (e & 1)], pm[e >> 1]);
          s[nt][e] = p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l_i[h] = l_i[h] * alpha[h] + ls[h];
      if constexpr (KIND == kFQ41) {
#pragma unroll
        for (int h = 0; h < 2; ++h) pm[h] = quad_sum(pm[h]);
      }
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] = o[nt][e] * alpha[e >> 1] + pm[e >> 1];

      // O += P.V, 16 keys a step: P's A fragments from the score registers
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (s0 + kk * 16 > warp_last) continue;
        float pv[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pv[h][e] = s[2 * kk + h][e];
            if constexpr (KIND != kFBF16)
              pv[h][e] *= kss[kFKeys + (2 * kk + h) * 8 + (lane & 3) * 2 + (e & 1)];
          }
        const uint32_t pa[4] = {pack_bf16(pv[0][0], pv[0][1]), pack_bf16(pv[0][2], pv[0][3]),
                                pack_bf16(pv[1][0], pv[1][1]), pack_bf16(pv[1][2], pv[1][3])};
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          const int row = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
          const int col = dp * 16 + (lane >> 4) * 8;
          uint32_t r[4];
          ldmatrix_x4_trans(r, vtile + (row * P + col) * 2);
          mma_bf16(o[2 * dp], pa, r[0], r[1]);
          mma_bf16(o[2 * dp + 1], pa, r[2], r[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with slot j % 2 (and the converted tiles)
  }

  // out = acc / max(l, 1e-30), rows < R only; accumulator (nt, e) is row
  // lane/4 (+8 for e >= 2), dim nt*8 + (lane%4)*2 + e%2
  if (wr0 < R) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float l = fmaxf(quad_sum(l_i[h]), 1e-30f);
      const int r = wr0 + (lane >> 2) + 8 * h;
      if (r >= R) continue;
      const int g = r / T, t = r - g * T;
      __nv_bfloat16* orow = a.out + (((size_t)b * T + t) * a.H + kvh * G + g) * D;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        *reinterpret_cast<uint32_t*>(orow + nt * 8 + (lane & 3) * 2) =
            pack_bf16(o[nt][2 * h] / l, o[nt][2 * h + 1] / l);
    }
  }
}

template <int D, int KIND, bool PAGED>
int launch_d(const FArgs& a, int B, cudaStream_t st) {
  constexpr int smem = FLayout<D, KIND>::kSmem;
  static CardCache cards;   // the shared-memory opt-in, set per device on first use
  Card c;
  const int rc = cards.get(flash_attention_tc_kernel<D, KIND, PAGED>, smem, c);
  if (rc != 0) return rc;
  if (smem > c.smem_block) return (int)cudaErrorInvalidValue;
  const int R = (a.H / a.KVH) * a.T;
  const dim3 grid((R + kFRows - 1) / kFRows, a.KVH, B);
  flash_attention_tc_kernel<D, KIND, PAGED><<<grid, kFThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int KIND, bool PAGED>
int launch(const FArgs& a, int B, int D, void* stream) {
  if (B == 0 || a.T == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64: return launch_d<64, KIND, PAGED>(a, B, st);
    case 128: return launch_d<128, KIND, PAGED>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

FArgs make_args(const void* q, const void* k, const void* v, const void* offsets, void* out,
                int T, int H, int KVH, int S, float scale) {
  FArgs a = {};
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

// Arguments as flash_attention.cu's entry points of the same names without
// _tc, less the decode kernel's scratch, counters and split: contiguous
// caches k/v (B, KVH, S, D) bf16 or int8, or (B, KVH, S, D/2) nibbles, with
// scales (and q4_1 minimums) (B, KVH, S) f32; paged pools (P, KVH, page_s, .)
// through page_table (B, NP) int32. D 64 or 128; 16-byte aligned caches.

extern "C" int lgt_flash_attention_tc(const void* q, const void* k, const void* v,
                                      const void* offsets, void* out, int B, int T, int H,
                                      int KVH, int S, int D, float scale, void* stream) {
  return launch<kFBF16, false>(make_args(q, k, v, offsets, out, T, H, KVH, S, scale), B, D,
                               stream);
}

extern "C" int lgt_flash_attention_q8_tc(const void* q, const void* kq, const void* ks,
                                         const void* vq, const void* vs, const void* offsets,
                                         void* out, int B, int T, int H, int KVH, int S, int D,
                                         float scale, void* stream) {
  FArgs a = make_args(q, kq, vq, offsets, out, T, H, KVH, S, scale);
  a.ks = (const float*)ks;
  a.vs = (const float*)vs;
  return launch<kFQ8, false>(a, B, D, stream);
}

extern "C" int lgt_flash_attention_q4_tc(const void* q, const void* kq, const void* ks,
                                         const void* vq, const void* vs, const void* offsets,
                                         void* out, int B, int T, int H, int KVH, int S, int D,
                                         float scale, void* stream) {
  FArgs a = make_args(q, kq, vq, offsets, out, T, H, KVH, S, scale);
  a.ks = (const float*)ks;
  a.vs = (const float*)vs;
  return launch<kFQ4, false>(a, B, D, stream);
}

extern "C" int lgt_flash_attention_q41_tc(const void* q, const void* kq, const void* ks,
                                          const void* km, const void* vq, const void* vs,
                                          const void* vm, const void* offsets, void* out, int B,
                                          int T, int H, int KVH, int S, int D, float scale,
                                          void* stream) {
  FArgs a = make_args(q, kq, vq, offsets, out, T, H, KVH, S, scale);
  a.ks = (const float*)ks;
  a.vs = (const float*)vs;
  a.km = (const float*)km;
  a.vm = (const float*)vm;
  return launch<kFQ41, false>(a, B, D, stream);
}

extern "C" int lgt_flash_attention_paged_tc(const void* q, const void* k, const void* v,
                                            const void* offsets, const void* table, void* out,
                                            int B, int T, int H, int KVH, int NP, int page_s,
                                            int D, float scale, void* stream) {
  FArgs a = make_args(q, k, v, offsets, out, T, H, KVH, NP * page_s, scale);
  a.table = (const int*)table;
  a.NP = NP;
  a.page_s = page_s;
  return launch<kFBF16, true>(a, B, D, stream);
}

extern "C" int lgt_flash_attention_paged_q8_tc(const void* q, const void* kq, const void* ks,
                                               const void* vq, const void* vs,
                                               const void* offsets, const void* table,
                                               void* out, int B, int T, int H, int KVH, int NP,
                                               int page_s, int D, float scale, void* stream) {
  FArgs a = make_args(q, kq, vq, offsets, out, T, H, KVH, NP * page_s, scale);
  a.ks = (const float*)ks;
  a.vs = (const float*)vs;
  a.table = (const int*)table;
  a.NP = NP;
  a.page_s = page_s;
  return launch<kFQ8, true>(a, B, D, stream);
}
