// Causal flash attention for prefill-sized query counts on tensor cores, for
// Hopper (sm_90a): wgmma, TMA and mbarriers.
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
// and P.V accumulates (p*vs).c [+ sum p*vm] while l sums the unscaled p
// (q4_1's c and minimums centred, below);
// out = acc / max(l, 1e-30); a block stops at the last key its rows see; in
// a paged cache a -1 table entry is read as page 0 and never used unmasked.
// The JAX package builds no 4-bit paged pool, nor does the port, so q4_0 and
// q4_1 are contiguous only. The scores are kept in the base-2 domain: the
// scale is folded with log2(e), the exponentials are ex2 (MUFU.EX2); P is
// rounded to bf16 (times vs) for the second product, the one rounding the
// reference does not make.
//
// What bounds it: at T = 512 the operations (4*H*D per (query, key) pair
// over 989 TFLOP/s bf16), not the cache bytes: each KV head's keys serve G*T
// query rows. At D = 128 the softmax's exponentials (16 an SM a cycle) take
// about half the products' tensor time, so the two consumers overlap one's
// softmax with the other's products; the quantized kinds' conversion adds
// shared-memory traffic (codes read, bf16 tiles written) that the products
// then contend with.
//
// Design, in FlashAttention-3's shape:
// - A block of three warpgroups owns one (b, kv head) and 128 consecutive
//   rows r: consumer warpgroups 0 and 1 take 64 rows each, the producer
//   warpgroup 2 feeds them; setmaxnreg gives the consumers 232 registers and
//   the producer 40 (q8_0 and q4_0, whose producer converts: 224 and 56),
//   3 x 168 in all, the registers a block starts with. A tile of rows spans
//   one head's t's (two heads' where T % 64 != 0); blocks take their row
//   tiles last first, so the ones that walk the most keys start first.
// - Q stays in registers: each consumer thread loads its rows' wgmma_rs A
//   fragments once (4-byte loads, zeros past R), the A of S = Q.K^T. That
//   spares the products 32 KB of shared-memory reads a tile of keys and
//   frees the 32 KB a Q tile would take (so q8_0 has two code stages at
//   D = 128); Q by TMA would also need a box for each run of rows of one
//   head, of any length.
// - K and V, tiles of kKT = 128 keys, come in a ring of stages, each with
//   full barriers for K and for V and empty ones for each: K's goes back
//   once every consumer warp has read the tile's vectors (its S retired
//   first), V's once each consumer's P.V of the tile retired. K (keys x D)
//   is S's K-major B operand; V (keys x D, D contiguous) is P.V's MN-major B
//   operand (wgmma_desc_mn, the transpose flag of wgmma_rs_tb). bf16 K and
//   V come straight by TMA with the 128-byte swizzle, in 64-column boxes of
//   hb keys, from producer warp 0.
// - The quantized kinds' codes come raw by TMA (q8_0 rows of D bytes,
//   q4_0/q4_1 rows of D/2 planar nibble bytes) into a ring of code stages,
//   with the tile's key vectors (ks, vs, and for q4_1 km, vm) by 4-byte
//   cp.async whose arrival the code stage's full barrier counts. The
//   producer's warps 1-3 convert each tile into a stage's bf16 K and V
//   tiles, ahead of the consumers, with its vectors beside them. The
//   conversion is exact and has no I2F: a nibble n is the bf16 0x4300 | n
//   (128 + n) less 136 (n - 8); a signed byte c is 0x4300 | (c & 127) less
//   0x4300 | (c & 128) (128 or 256); one byte permute spreads two codes into
//   a bf16 pair, one sub.bf16x2 finishes them. fence.proxy.async makes the
//   tiles visible to wgmma before the full barriers' arrivals.
// - q4_1 is taken centred, as q4_0: c s + m = (c - 8) s + (m + 8 s), so the
//   converter writes c - 8 and stores km + 8 ks and vm + 8 vs as the
//   minimums. The same sums, but the rounded term (p vs)(c - 8) is about half
//   of (p vs) c, whose cancellation against sum p vm made the rounding of P
//   reach two bf16 ulps of the output where an element's value is far from
//   its row's minimum (an H100 run of the uncentred form: 8.6e-3 of the
//   output's scale at D = 128, T = 100, offsets 300 and 17).
// - Paged kinds: the producer reads the table once per box, not per row. A
//   box is hb = min(kKT, the largest power of two dividing page_s) keys, so
//   no box straddles a page (pages of 256 or 1024: one box a tile; of 48:
//   16 keys a box; of an odd size: one key a box, slow but right). The maps
//   run over the pool's rows (P x KVH x page_s); keys past the table's pages
//   read page 0, masked.
// - A consumer's walk: tile j's S = Q.K^T is issued with tile j-1's O +=
//   P.V, both retire, then tile j's softmax (f32 running max and sum, each
//   row's reduced over the quad of lanes holding it; only the tiles the
//   diagonal crosses masked), O's rescale and P's packing (from the S
//   accumulators into wgmma_rs's bf16 A fragments). The two consumers issue
//   their products in turn (named barriers), so one's
//   softmax runs under the other's products (about 10% at T = 512 on an
//   H100); running
//   the softmax under the warpgroup's own P.V as well (FlashAttention-3's
//   in-warpgroup pipelining) measured no faster and kept P's registers live
//   through it. A consumer stops at the last key its rows see and hands the
//   stages of the block's later tiles back unread.
// - The epilogue stores rows < R from registers: out = acc / max(l, 1e-30).
// - Dynamic shared memory a block (kBytes; one block an SM), bf16 stages
//   and code stages at D 64 / 128: bf16 4 / 3; q8_0 3 and 4 / 2 and 2;
//   q4_0 and q4_1 3 and 4 / 2 and 4.

#include "tc_common.cuh"

namespace {

constexpr int kFRows = 128;     // query rows a block, 64 a consumer warpgroup
constexpr int kFThreads = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr float kLog2e = 1.4426950408889634f;

enum FKind { kFBF16 = 0, kFQ8 = 1, kFQ4 = 2, kFQ41 = 3 };

// registers a thread after setmaxnreg: a block starts with 168 a thread (the
// most 384 threads may have), and the three warpgroups' counts must sum to
// 3 x 168, or a consumer's setmaxnreg.inc waits for registers that never
// come. bf16: the producer only issues TMA; q8_0 and q4_0: its warps 1-3
// convert; q4_1's consumers hold its minimums' terms too.
template <int KIND> constexpr int kFConsRegs = KIND == kFQ8 || KIND == kFQ4 ? 224 : 232;
template <int KIND> constexpr int kFProdRegs = 3 * 168 - 2 * kFConsRegs<KIND>;
static_assert(kFProdRegs<kFBF16> >= 24 && kFProdRegs<kFQ8> >= 24, "setmaxnreg counts");

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
  int hb;                // keys a TMA box
  float scale;
};

// Shared memory of a block, from a 1024-byte aligned base: the stages (each
// K then V, bf16 tiles of kKT keys in 64-column panels of kKT x 128 bytes,
// then its keys' vectors ks, vs (, km, vm)), the code stages (K codes, V
// codes, the same vectors as stored), the barriers.
template <int D, int KIND>
struct FLayout {
  static constexpr int kKT = 128;                         // keys a tile
  static constexpr int kKV = kKT * D * 2;                  // a bf16 K or V tile
  static constexpr int kNV = KIND == kFBF16 ? 0 : KIND == kFQ41 ? 4 : 2;  // ks, vs (, km, vm)
  static constexpr int kStage = 2 * kKV + (kNV * kKT * 4 + 1023) / 1024 * 1024;
  static constexpr int kRB = KIND == kFQ8 ? D : D / 2;    // code bytes a key
  static constexpr int kCodes = 2 * kKT * kRB;             // a code stage's K and V codes
  static constexpr int kCode = KIND == kFBF16 ? 0 : kCodes + kNV * kKT * 4;
  static constexpr int kBudget = 230400;   // 232,448 less the alignment pad and barriers
  static constexpr int kStages =
      KIND == kFBF16 ? (kBudget / kStage < 4 ? kBudget / kStage : 4)
      : kBudget - 3 * kStage >= 2 * kCode ? 3 : 2;
  static constexpr int kCFit = KIND == kFBF16 ? 0 : (kBudget - kStages * kStage) / kCode;
  static constexpr int kCStages = kCFit < 4 ? kCFit : 4;
  static constexpr int kSt = 0;
  static constexpr int kCs = kSt + kStages * kStage;
  static constexpr int kBar = kCs + kCStages * kCode;
  static constexpr int kBytes = kBar + (4 * kStages + 2 * kCStages) * 8 + 1024;
  static_assert(kStages >= 2 && (KIND == kFBF16 || kCStages >= 1), "stages do not fit");
  static_assert(kCode % 128 == 0, "code stages 128-byte aligned");
};

// Row index of logical slot pos of (b, kvh): codes at row * row bytes,
// scales at row. Paged: a -1 entry, or a slot past the table's pages, reads
// page 0.
template <bool PAGED>
__device__ __forceinline__ int frow(const FArgs& a, int b, int kvh, int pos) {
  if constexpr (PAGED) {
    const int lp = pos / a.page_s;
    const int phys = lp < a.NP ? max(a.table[(size_t)b * a.NP + lp], 0) : 0;
    return (phys * a.KVH + kvh) * a.page_s + (pos - lp * a.page_s);
  } else {
    return (b * a.KVH + kvh) * a.S + pos;
  }
}

// Byte offset of (row, col) (col a multiple of 8) in a bf16 tile of `rows`
// rows as TMA lays it with the 128-byte swizzle: 64-column panels of rows x
// 128 bytes, the 16-byte chunk XORed with the row's place in its 8.
__device__ __forceinline__ int swz(int row, int col, int rows) {
  return (col >> 6) * rows * 128 + row * 128 + ((((col & 63) >> 3) ^ (row & 7)) << 4);
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

// One code tile (kKT keys) to its bf16 tile, 16 code bytes a thread step
// over the producer's 96 converting threads (ct). q8_0: two codes a bf16
// pair, 0x4300 | (c & 127) less 0x4300 | (c & 128); q4_0/q4_1: byte j's low
// nibble to column j, its high one to j + D/2, 0x4300 | n less 136 (n - 8).
template <int D, int KIND, int KT>
__device__ __forceinline__ void convert_tile(const unsigned char* codes, unsigned char* tile,
                                             int ct) {
  constexpr int RB = KIND == kFQ8 ? D : D / 2;
  constexpr uint32_t kMagic = 0x43004300u;
  constexpr uint32_t kBias = 0x43084308u;   // 136: n - 8 (q4_1 too, its minimums moved by 8 s)
  for (int c = ct; c < KT * RB / 16; c += 96) {
    const int key = c / (RB / 16), col = (c % (RB / 16)) * 16;
    const uint4 w = *reinterpret_cast<const uint4*>(codes + key * RB + col);
    const uint32_t wd[4] = {w.x, w.y, w.z, w.w};
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // bytes 2h, 2h+1 of word e to the low bytes of a pair's halves
        const uint32_t s = __byte_perm(wd[e], 0u, h ? 0x4342u : 0x4140u);
        if constexpr (KIND == kFQ8) {
          lo[2 * e + h] = sub_bf16x2((s & 0x007f007fu) | kMagic, (s & 0x00800080u) | kMagic);
        } else {
          lo[2 * e + h] = sub_bf16x2((s & 0x000f000fu) | kMagic, kBias);
          hi[2 * e + h] = sub_bf16x2(((s >> 4) & 0x000f000fu) | kMagic, kBias);
        }
      }
    }
    *reinterpret_cast<uint4*>(tile + swz(key, col, KT)) = uint4{lo[0], lo[1], lo[2], lo[3]};
    *reinterpret_cast<uint4*>(tile + swz(key, col + 8, KT)) = uint4{lo[4], lo[5], lo[6], lo[7]};
    if constexpr (KIND != kFQ8) {
      *reinterpret_cast<uint4*>(tile + swz(key, col + D / 2, KT)) = uint4{hi[0], hi[1], hi[2], hi[3]};
      *reinterpret_cast<uint4*>(tile + swz(key, col + D / 2 + 8, KT)) =
          uint4{hi[4], hi[5], hi[6], hi[7]};
    }
  }
}

template <int D, int KIND, bool PAGED>
__global__ void __launch_bounds__(kFThreads, 1)
flash_attention_tc_kernel(const FArgs a, const __grid_constant__ CUtensorMap tmk,
                          const __grid_constant__ CUtensorMap tmv) {
  using L = FLayout<D, KIND>;
  constexpr int KT = L::kKT, NS = L::kStages, NC = L::kCStages, NV = L::kNV, RB = L::kRB;
  extern __shared__ __align__(16) unsigned char smem[];
  // the base rounded up to 1024 bytes by pointer arithmetic on smem, so the
  // compiler keeps every access in the shared window
  unsigned char* const sm = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  uint64_t* const kfull = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* const vfull = kfull + NS;
  uint64_t* const kempty = vfull + NS;    // a stage's K and vectors read: each consumer warp
  uint64_t* const vempty = kempty + NS;   // its V (and vs, vm): each consumer warpgroup
  uint64_t* const cfull = vempty + NS;    // quantized: a code stage landed
  uint64_t* const cempty = cfull + NC;    // quantized: a code stage converted
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(kfull + s, KIND == kFBF16 ? 1 : 3);
      mbar_init(vfull + s, KIND == kFBF16 ? 1 : 3);
      mbar_init(kempty + s, 8);
      mbar_init(vempty + s, 2);
    }
    for (int s = 0; s < NC; ++s) {
      mbar_init(cfull + s, 33);   // the TMA bytes' arrival and each lane's vector copies
      mbar_init(cempty + s, 3);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int G = a.H / a.KVH, T = a.T, R = G * T;
  const int r0 = ((R + kFRows - 1) / kFRows - 1 - (int)blockIdx.x) * kFRows;
  const int off = a.offsets[b];
  const int last = min(a.S - 1, off + last_t(r0, min(kFRows, R - r0), T));
  const int n_tiles = last / KT + 1;

  if (wg == 2) {
    setmaxnreg_dec<kFProdRegs<KIND>>();
    const int pw = (tid >> 5) & 3;
    if (pw == 0) {
      // tile j's boxes of hb keys, their table reads and copies spread over
      // the warp's lanes; quantized, the keys' vectors too (4-byte cp.async,
      // zeros past the block's last key)
      const int nbox = KT / a.hb;
      for (int j = 0; j < n_tiles; ++j) {
        if constexpr (KIND == kFBF16) {
          const int st = j % NS, ph = ((j / NS) & 1) ^ 1;
          unsigned char* const kd = sm + L::kSt + st * L::kStage;
          mbar_wait(kempty + st, ph);
          if (lane == 0) mbar_arrive_tx(kfull + st, L::kKV);
          __syncwarp();
          for (int i = lane; i < nbox * (D / 64); i += 32) {
            const int bx = i / (D / 64), p = i % (D / 64);
            tma_load_2d(kd + p * KT * 128 + bx * a.hb * 128, &tmk, p * 64,
                        frow<PAGED>(a, b, kvh, j * KT + bx * a.hb), kfull + st);
          }
          mbar_wait(vempty + st, ph);
          if (lane == 0) mbar_arrive_tx(vfull + st, L::kKV);
          __syncwarp();
          for (int i = lane; i < nbox * (D / 64); i += 32) {
            const int bx = i / (D / 64), p = i % (D / 64);
            tma_load_2d(kd + L::kKV + p * KT * 128 + bx * a.hb * 128, &tmv, p * 64,
                        frow<PAGED>(a, b, kvh, j * KT + bx * a.hb), vfull + st);
          }
        } else {
          const int cs = j % NC;
          unsigned char* const cd = sm + L::kCs + cs * L::kCode;
          mbar_wait(cempty + cs, ((j / NC) & 1) ^ 1);
          if (lane == 0) mbar_arrive_tx(cfull + cs, L::kCodes);
          __syncwarp();
          for (int bx = lane; bx < nbox; bx += 32) {
            const int row = frow<PAGED>(a, b, kvh, j * KT + bx * a.hb);
            tma_load_2d(cd + bx * a.hb * RB, &tmk, 0, row, cfull + cs);
            tma_load_2d(cd + KT * RB + bx * a.hb * RB, &tmv, 0, row, cfull + cs);
          }
          float* const cv = reinterpret_cast<float*>(cd + L::kCodes);
          for (int i = lane; i < NV * KT; i += 32) {
            const int vi = i / KT, pos = j * KT + i % KT;
            const float* src = vi == 0 ? a.ks : vi == 1 ? a.vs : vi == 2 ? a.km : a.vm;
            const bool ok = pos <= last;
            cp_async4(cv + i, src + (ok ? frow<PAGED>(a, b, kvh, pos) : 0), ok);
          }
          cp_async_mbar_arrive(cfull + cs);
        }
      }
    } else if constexpr (KIND != kFBF16) {
      // warps 1-3: each code stage to a stage's bf16 K and V tiles and its
      // vectors (q4_1: codes centred, c - 8, minimums moved by 8 scales)
      const int ct = tid - 288;
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % NS, cs = j % NC, ph = ((j / NS) & 1) ^ 1;
        unsigned char* const kd = sm + L::kSt + st * L::kStage;
        float* const vec = reinterpret_cast<float*>(kd + 2 * L::kKV);
        const unsigned char* const cd = sm + L::kCs + cs * L::kCode;
        const float* const cv = reinterpret_cast<const float*>(cd + L::kCodes);
        mbar_wait(cfull + cs, (j / NC) & 1);
        mbar_wait(kempty + st, ph);
        // all the tile's vectors with K: a consumer reads vs and vm before
        // it waits for V
        for (int i = ct; i < KT; i += 96) {
          vec[i] = cv[i];
          vec[KT + i] = cv[KT + i];
          if constexpr (KIND == kFQ41) {
            vec[2 * KT + i] = fmaf(8.f, cv[i], cv[2 * KT + i]);
            vec[3 * KT + i] = fmaf(8.f, cv[KT + i], cv[3 * KT + i]);
          }
        }
        convert_tile<D, KIND, KT>(cd, kd, ct);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(kfull + st);
        mbar_wait(vempty + st, ph);
        convert_tile<D, KIND, KT>(cd + KT * RB, kd + L::kKV, ct);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(vfull + st);
          mbar_arrive(cempty + cs);
        }
      }
    }
  } else {
    setmaxnreg_inc<kFConsRegs<KIND>>();
    // this warpgroup's rows cr0..cr0+63 (crn of them < R); this thread's two,
    // rows g and g+8 of its warp's 16, and their last visible keys
    const int w = (tid >> 5) & 3, g = lane >> 2, t4 = lane & 3;
    const int cr0 = r0 + 64 * wg, crn = min(64, R - cr0);
    // Q in registers, wgmma_rs's A fragments of this thread's rows over D
    // (rows g, g+8; columns 16kk + 2t4, +1, +8, +9), zeros past R
    uint32_t qf[D / 16][4];
    int lim[2];
    float qsum2[2] = {0.f, 0.f};   // q4_1: log2(e) x the f32 sum of the row's pre-scaled q
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = cr0 + 16 * w + g + 8 * h;
      lim[h] = r < R ? min(a.S - 1, off + r % T) : a.S - 1;
      const int gq = r / T, t = r - gq * T;
      const uint32_t* const qrow = reinterpret_cast<const uint32_t*>(
          a.q + (((size_t)b * T + t) * a.H + kvh * G + gq) * D) + t4;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        qf[kk][h] = r < R ? qrow[8 * kk] : 0u;
        qf[kk][2 + h] = r < R ? qrow[8 * kk + 4] : 0u;
      }
      if constexpr (KIND == kFQ41) {
        // a quad's four lanes hold a quarter of the row each
        float sum = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t u = qf[kk][h + 2 * (e >> 1)];
            sum += __uint_as_float((e & 1 ? u >> 16 : u & 0xffffu) << 16) * a.scale;
          }
        qsum2[h] = quad_sum(sum) * kLog2e;
      }
    }
    // the tiles each warpgroup walks: to the last key its rows see
    auto tiles_of = [&](int c) {
      const int r = r0 + 64 * c, n = min(64, R - r);
      return n > 0 ? min(a.S - 1, off + last_t(r, n, T)) / KT + 1 : 0;
    };
    const int c_tiles = tiles_of(wg);
    // the smallest last key among the rows: tiles past it cross the diagonal
    const int c_diag = crn > 0 ? min(a.S - 1, off + ((cr0 % T) + crn - 1 >= T ? 0 : cr0 % T)) : 0;
    const float c1 = a.scale * kLog2e;

    float sacc[KT / 2];       // S, then P in f32: (row g (+8 for e >= 2), key 8j + 2t4 + e%2) at 4j + e
    float o[D / 2];           // O, the same layout over D
    uint32_t pa[KT / 16][4];  // P times vs, wgmma_rs's bf16 A fragments
    float m_i[2] = {-1e30f, -1e30f}, l_i[2] = {0.f, 0.f};   // l: this lane's share
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) sacc[i] = 0.f;
    auto stage = [&](int j) { return sm + L::kSt + (j % NS) * L::kStage; };
    auto issue_s = [&](int j) {
      const uint64_t dk = wgmma_desc(stage(j));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_rs(sacc, qf[kk], dk + (kk / 4) * (KT * 128 >> 4) + 2 * (kk % 4), kk);
      wgmma_commit();
    };
    auto issue_pv = [&](int j) {
      const uint64_t dv = wgmma_desc_mn(stage(j) + L::kKV, KT * 128);
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) wgmma_rs_tb(o, pa[kk], dv + kk * (16 * 128 >> 4));
      wgmma_commit();
    };
    auto fence_pa = [&]() {
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) fence_regs(pa[kk]);
    };
    // the products' turns (tile j's S with tile j-1's P.V, the last P.V its
    // own): the two warpgroups issue theirs in turn (FlashAttention-3's
    // ping-pong), one's softmax under the other's products, over the turns
    // both take
    const int o_tiles = tiles_of(wg ^ 1);
    const int common = min(c_tiles > 0 ? c_tiles + 1 : 0, o_tiles > 0 ? o_tiles + 1 : 0);
    auto turn_begin = [&](int u) {
      if (u < common && (wg == 1 || u > 0)) named_bar_sync(3 + wg, 256);
    };
    auto turn_end = [&](int u) {
      if (u < common && (wg == 0 || u < common - 1)) named_bar_arrive(4 - wg, 256);
    };
    // tile j's scores (in sacc) to p, the running max and sum updated; alpha
    // rescales O, pm (q4_1) is each row's sum of p * vm
    auto softmax = [&](int j, float (&alpha)[2], float (&pm)[2]) {
      const float* const vec = reinterpret_cast<const float*>(stage(j) + 2 * L::kKV);
      const int s0 = j * KT;
      const bool mask = s0 + KT - 1 > c_diag;
      float mx[2] = {-1e30f, -1e30f}, m_new[2];
#pragma unroll
      for (int jj = 0; jj < KT / 8; ++jj) {
        float2 k2 = {c1, c1}, km2 = {0.f, 0.f};
        if constexpr (KIND != kFBF16) {
          k2 = *reinterpret_cast<const float2*>(vec + 8 * jj + 2 * t4);
          k2 = {k2.x * c1, k2.y * c1};
        }
        if constexpr (KIND == kFQ41) km2 = *reinterpret_cast<const float2*>(vec + 2 * KT + 8 * jj + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          float x = sacc[4 * jj + e];
          // bf16: the raw dot, the (positive) scale applied to the max and in the exponent
          if constexpr (KIND != kFBF16) x *= e & 1 ? k2.y : k2.x;
          if constexpr (KIND == kFQ41) x = fmaf(qsum2[h], e & 1 ? km2.y : km2.x, x);
          if (mask && s0 + 8 * jj + 2 * t4 + (e & 1) > lim[h]) x = -1e30f;
          sacc[4 * jj + e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m_new[h] = quad_max(mx[h]);
        if constexpr (KIND == kFBF16) m_new[h] *= c1;
        m_new[h] = fmaxf(m_i[h], m_new[h]);
      }
      float ls[2] = {0.f, 0.f};
      pm[0] = pm[1] = 0.f;
#pragma unroll
      for (int jj = 0; jj < KT / 8; ++jj) {
        float2 vm2 = {0.f, 0.f};
        if constexpr (KIND == kFQ41) vm2 = *reinterpret_cast<const float2*>(vec + 3 * KT + 8 * jj + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float p = KIND == kFBF16 ? ex2_approx(fmaf(sacc[4 * jj + e], c1, -m_new[h]))
                                         : ex2_approx(sacc[4 * jj + e] - m_new[h]);
          ls[h] += p;
          if constexpr (KIND == kFQ41) pm[h] = fmaf(p, e & 1 ? vm2.y : vm2.x, pm[h]);
          sacc[4 * jj + e] = p;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        alpha[h] = ex2_approx(m_i[h] - m_new[h]);
        m_i[h] = m_new[h];
        l_i[h] = l_i[h] * alpha[h] + ls[h];
        if constexpr (KIND == kFQ41) pm[h] = quad_sum(pm[h]);
      }
    };
    // O = O * alpha (+ pm), then P (times vs) from sacc into pa
    auto rescale_pack = [&](int j, const float (&alpha)[2], const float (&pm)[2]) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        const int h = (i >> 1) & 1;
        o[i] = KIND == kFQ41 ? fmaf(o[i], alpha[h], pm[h]) : o[i] * alpha[h];
      }
      const float* const vs = reinterpret_cast<const float*>(stage(j) + 2 * L::kKV) + KT;
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 8 * kk + 2 * q;   // keys 8 * (i / 4) + 2t4, +1
          float p0 = sacc[i], p1 = sacc[i + 1];
          if constexpr (KIND != kFBF16) {
            const float2 v2 = *reinterpret_cast<const float2*>(vs + 8 * (i / 4) + 2 * t4);
            p0 *= v2.x;
            p1 *= v2.y;
          }
          pa[kk][q] = bf16_bits(p0, p1);
        }
      // this warp is done with the stage's K and vectors (S retired, the
      // vectors read): the K side goes back
      __syncwarp();
      if (lane == 0) mbar_arrive(kempty + j % NS);
    };

    float alpha[2], pm[2];
    if (c_tiles > 0) {
      mbar_wait(kfull, 0);
      turn_begin(0);
      wgmma_fence();
      issue_s(0);
      turn_end(0);
      wgmma_wait<0>();
      fence_regs(sacc);
      softmax(0, alpha, pm);
      rescale_pack(0, alpha, pm);
    }
    for (int j = 1; j < c_tiles; ++j) {
      mbar_wait(kfull + j % NS, (j / NS) & 1);
      mbar_wait(vfull + (j - 1) % NS, ((j - 1) / NS) & 1);
      fence_regs(o);
      fence_pa();
      turn_begin(j);
      wgmma_fence();
      issue_s(j);
      issue_pv(j - 1);
      turn_end(j);
      wgmma_wait<0>();   // S of tile j and tile j-1's P.V
      fence_regs(sacc);
      fence_regs(o);
      if ((tid & 127) == 0) mbar_arrive(vempty + (j - 1) % NS);
      softmax(j, alpha, pm);
      rescale_pack(j, alpha, pm);
    }
    if (c_tiles > 0) {
      const int j = c_tiles - 1;
      mbar_wait(vfull + j % NS, (j / NS) & 1);
      fence_regs(o);
      fence_pa();
      turn_begin(c_tiles);
      wgmma_fence();
      issue_pv(j);
      turn_end(c_tiles);
      wgmma_wait<0>();
      fence_regs(o);
      if ((tid & 127) == 0) mbar_arrive(vempty + j % NS);
    }
    // the block's later tiles, which no row of this warpgroup sees
    if (lane == 0) {
      for (int j = c_tiles; j < n_tiles; ++j) {
        mbar_wait(kfull + j % NS, (j / NS) & 1);
        mbar_arrive(kempty + j % NS);
        if (w == 0) {
          mbar_wait(vfull + j % NS, (j / NS) & 1);
          mbar_arrive(vempty + j % NS);
        }
      }
    }

    // out = acc / max(l, 1e-30), rows < R only; the row recomputed through
    // an opaque copy, so its address (Q's) is not held across the walk
    int rq = cr0 + 16 * w + g;
    asm volatile("" : "+r"(rq));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float inv = 1.f / fmaxf(quad_sum(l_i[h]), 1e-30f);
      const int r = rq + 8 * h;
      if (r >= R) continue;
      const int gq = r / T, t = r - gq * T;
      __nv_bfloat16* orow = a.out + (((size_t)b * T + t) * a.H + kvh * G + gq) * D;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<uint32_t*>(orow + 8 * jj + 2 * t4) =
            bf16_bits(o[4 * jj + 2 * h] * inv, o[4 * jj + 2 * h + 1] * inv);
    }
  }
}

// A launch's K and V tensor maps over the cache's rows (contiguous: B x KVH
// x S; paged: the pool's, whose count the entry points are not given, so
// the maps reach as far as any row a table entry names), boxes of hb keys:
// bf16 64 columns with the 128-byte swizzle; codes whole rows.
template <int D, int KIND, bool PAGED>
int tensor_maps(const FArgs& a, int B, CUtensorMap (&tm)[2]) {
  const int rows = PAGED ? 0x7fffffff : B * a.KVH * a.S;
  for (int i = 0; i < 2; ++i) {
    const void* base = i ? a.v : a.k;
    const int rc = KIND == kFBF16
        ? tensor_map(&tm[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, D, rows, 64, a.hb,
                     CU_TENSOR_MAP_SWIZZLE_128B)
        : tensor_map(&tm[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, FLayout<D, KIND>::kRB, rows,
                     FLayout<D, KIND>::kRB, a.hb, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (rc != 0) return rc;
  }
  return 0;
}

template <int D, int KIND, bool PAGED>
int launch_d(FArgs a, int B, cudaStream_t st) {
  using L = FLayout<D, KIND>;
  static CardCache cards;   // the shared-memory opt-in, set per device on first use
  Card c;
  const int rc = cards.get(flash_attention_tc_kernel<D, KIND, PAGED>, L::kBytes, c);
  if (rc != 0) return rc;
  if (L::kBytes > c.smem_block) return (int)cudaErrorInvalidValue;
  const int low = a.page_s & -a.page_s;   // the largest power of two dividing page_s
  a.hb = PAGED && low < L::kKT ? low : L::kKT;
  CUtensorMap tm[2];
  const int rm = tensor_maps<D, KIND, PAGED>(a, B, tm);
  if (rm != 0) return rm;
  const int R = (a.H / a.KVH) * a.T;
  const dim3 grid((R + kFRows - 1) / kFRows, a.KVH, B);
  flash_attention_tc_kernel<D, KIND, PAGED><<<grid, kFThreads, L::kBytes, st>>>(a, tm[0], tm[1]);
  return (int)cudaGetLastError();
}

template <int KIND, bool PAGED>
int launch(const FArgs& a, int B, int D, void* stream) {
  if (B == 0 || a.T == 0) return 0;
  if (PAGED && a.page_s <= 0) return (int)cudaErrorInvalidValue;
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
