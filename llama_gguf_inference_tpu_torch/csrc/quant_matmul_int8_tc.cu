// Tensor-core path of the int8-activation 4-bit matmul, for prefill-sized
// row counts, for Hopper (sm_90a): s8 wgmma, TMA and mbarriers.
//
// Replaces, from ops/quant_matmul.py's INT8_TC_MIN_ROWS activation rows up,
// the TPU body _make_kernel_int8 (llama_gguf_inference_tpu/ops/
// pallas_matmul.py:536, launched by the pallas_call at :698,
// LGT_MM_VARIANT=int8): lgt_quant_matmul_int8_tc. Fewer rows, or a geometry
// this kernel does not take, run lgt_quant_matmul_int8 in quant_matmul.cu,
// the decode kernel.
//
// It computes what lgt_quant_matmul_int8 computes: with xq (B, in) the int8
// activations and xs (B, nsub) their scales (ops/quant_matmul.py
// quantize_acts), c the unbiased 4-bit code and k the sub-block,
//   p[b,o,k] = sum_t xq[b, t*nsub + k] * c[o, t*nsub + k]     (exact int32)
//   y[b,o]   = sum_k (p[b,o,k] * xs[b,k]) * s[o,k] - xsum[b,k] * m'[o,k]
// with s and m' = bias*s + m as min_prime in quant_matmul_lowbit_tc.cu forms
// them (flat, or f32 per super-block times an 8-bit factor; no mixed
// layout: the dispatcher sends that to the dequantize path, as the JAX
// package does). Formats: Q4_K (sub 32), Q4_0 (bias 8), Q4_1 (flat min),
// Q3_K (sub 16, bias 4), in the flat and compact layouts.
//
// What bounds it. The int8 products are 2*B*in*out operations (0.061 ms at
// gate+up 28672x4096, B = 512, over 1,979 TOP/s), but each of the
// B*out*nsub sub-block sums (1.88e9 there) is then converted and scaled on
// CUDA cores. Here that takes three instructions a sum: an integer add that
// forms the bits of M + p, one FMA that converts and scales by xs, one FMA
// that scales by s and adds: 5.6e9 of the card's 132 x 128
// FP32 lanes at about 1.75 GHz, 0.19 ms at that shape. That epilogue, not
// the tensor work, is the kernel's floor; the design keeps everything else
// (loads, fragment reads, the min term, the tensor work) beside it. As
// measured (PERF.md §6: 0.48 ms there), the scaling and the loads-and-issue
// skeleton add rather than overlap.
//
// Design: one persistent block an SM walks tiles of 128 output rows by kN
// activation rows (kN = 128; 64 for at most 64 rows and for sub 16, whose
// 128-row instances spilled in 216 registers), the activation tiles
// fastest, so the blocks that share a code tile run together and read it
// once from the card's memory. Per tile, x is read again from L2 for each
// 128 output rows and the codes for each kN activation rows: at gate+up, B
// = 512, 0.47 GB of x, 0.24 GB of codes, 0.12 GB of (xs, xsum).
// - Warpgroups: two consumers, each the M side (64 output rows) of every
//   wgmma, and a producer (warp 0 issues the TMA loads; warps 1-3 form each
//   group's factor stage); setmaxnreg gives the consumers 216 registers and
//   the producer 72.
// - Products on s8 wgmma (m64n64k32, A from registers, s32 sums): a unit is
//   one sub-block of one 64-row half of the activation tile. A is the
//   weight codes, nibbles masked to s8 (0..15); B is xq, which the wrapper
//   lays sub-block-major, (B, nsub, sub), so one 128-byte row of x holds 4
//   sub-blocks of 32 (8 of 16) and a k32 step of the descriptor is one
//   sub-block (sub 16: two, each issued as its own wgmma with the other
//   half of A zero). x comes by TMA in stages of kN rows x 128 bytes with the
//   128-byte swizzle wgmma's descriptor reads; a ring of 4 stages.
// - Exact sums, cheap conversion. Each unit's wgmma writes its sums p
//   afresh (scale-d 0; a preset of its accumulators would be 32 more moves
//   a unit), and adding 0x4B400000, the bits of M = 1.5*2^23, gives the bits
//   of the float M + p (|p| <= 127*15*32 < 2^22). The producer stores beside each
//   activation scale xs' = xs rounded to 22 significant bits (a relative
//   change of at most 2^-22) and c = -M*xs', which is then exact, so one FMA
//   gives fma(M + p, xs', c) = p*xs' rounded once, as the plain version's
//   product rounds p*xs, and a second adds it times s.
// - The epilogue off the tensor cores' critical path: each consumer keeps
//   two s32 banks; the next unit is issued into one bank while the CUDA
//   cores scale the other's sums (wgmma_wait<1>), so the products and the
//   scaling overlap within a warpgroup, and across the two. A group's
//   units are one unrolled block whose pipeline fills at its start and
//   drains at its end: no wgmma is in flight across a loop's back edge or a
//   branch, so ptxas can see that every read of a bank follows the wait
//   that retires its wgmma (otherwise it serializes them).
// - The min term on the tensor cores: sum_k xsum[b,k] * m'[o,k] is a
//   product of depth nsub. At each group's start a consumer forms -m' of its
//   rows for the group's 16 sub-blocks as two bf16 parts h + l in A
//   registers (a third did not fit its registers), and five bf16 wgmmas
//   (h.xh, h.xm, l.xh, h.xl, l.xm, with xsum = xh + xm + xl in three parts
//   in the group's slot of two B tiles the producer writes) add it into
//   the f32 accumulators: what they drop is -m''s residue, about 2^-18 of
//   each product, and smaller terms. (Both in two parts left 1.2e-4 of the
//   output's scale at ffn_down's 448 sub-blocks in the 8B forward.) It
//   runs for every weight (m' = 0 without a min or bias): 10 or 5 bf16
//   wgmmas a group beside 32 or 16 s8 ones.
// - Groups of 16 sub-blocks: a group's code tile (128 rows x sub/2 code
//   rows t' x 16 sub-blocks, bytes t'*nsub + k of a row) comes by sub/2 TMA
//   loads of 128 rows x 16 bytes, one a code row t', laid [t'][row][k] in a
//   ring of 2 (a swizzled box must fill its swizzle's span, and 16 bytes do
//   not; in this order the 8 rows a warp reads fall on 8 bank groups, and
//   its 4 code rows t' 4-way on each); a thread reads 4 words (4 sub-blocks
//   each) of its two rows a quad of sub-blocks and transposes them bytewise
//   (__byte_perm): 2 loads, 3 byte permutes and 6 masks and shifts a
//   sub-block, against 96 epilogue instructions. The group's factor stage
//   (ring of 2): s and m of the tile's rows (a flat side by TMA, a
//   hierarchical one formed as side_at forms them, side4), (xs', c) of its
//   activation rows, and xsum's bf16 parts.
// - Ragged rows and columns: TMA fills loads past B or out with zeros, their
//   factors are zero, and only rows < B and columns < out are stored.
// - Needs sub 16 or 32, nsub % 16 == 0, nd % 4 == 0 dividing nsub.

#include <utility>

#include <chrono>

#include "tc_common.cuh"

namespace {

constexpr int kI8M = 128;            // output rows a tile, 64 a consumer warpgroup
constexpr int kI8Threads = 384;      // consumer warpgroups 0 and 1, producer 2
constexpr int kI8G = 16;             // sub-blocks a group

constexpr int kMagic = 0x4B400000;   // the bits of M = 1.5 * 2^23
constexpr float kMagicF = 12582912.f;

// Shared memory of a block, from a 1024-byte aligned base: the x ring, the
// code ring, xsum's bf16 parts (two 64-wide swizzled tiles, a group's slot
// of 32 columns holding h and m in the first, l in the second), the factor
// stages (s and m as [row][16 sub-blocks] f32
// with the 64-byte swizzle; (xs', c) as [half][k][64 b] f32 pairs, where
// TMA first lands the raw (xs, xsum) as [b][16 pairs] with the 128-byte
// swizzle: each half's rows in the bytes its table takes), the barriers.
// 230,560 bytes at sub 32 and kN = 128, of the 232,448 a block may have.
template <int kSub, int kN>
struct I8Smem {
  static constexpr int kStages = 4;   // x ring
  static constexpr int kAuxs = 2;     // factor stages
  // registers after setmaxnreg, consumer and producer: 2 * 216 + 72 are
  // the 3 * 168 a block starts with
  static constexpr int kConsRegs = 216, kProdRegs = 72;
  static constexpr int kX = kN * 128;
  static constexpr int kCode = kI8M * (kSub / 2) * kI8G;
  static constexpr int kCs = kStages * kX;
  static constexpr int kXsum = kCs + 2 * kCode;
  static constexpr int kAux = kXsum + 2 * kX;
  static constexpr int kAuxM = kI8G * kI8M * 4;       // m table, after s's
  static constexpr int kAuxX = 2 * kI8G * kI8M * 4;   // (xs', c) table
  static constexpr int kAuxBytes = kAuxX + kI8G * kN * 8;
  static constexpr int kBar = kAux + kAuxs * kAuxBytes;
  static constexpr int kBytes = kBar + (2 * kStages + 4 + 3 * kAuxs) * 8 + 1024;
};

struct ArgsInt8TC {
  const int8_t* xq;        // (B, nsub, sub) sub-block-major
  const float* xsx;        // (B, nsub, 2): xs, xsum
  const uint8_t* codes;    // (out, in / 2) planar nibbles
  const float* d;          // (out, nd)
  const uint8_t* sc;       // (out, nsub) or null
  const float* dmin;       // (out, nd), or (out, nsub) flat, or null
  const uint8_t* mn;       // (out, nsub) or null
  float* y;                // (B, out)
  int B, in_f, out_f, nsub, nd, bias;
};

// Sub-blocks k0..k0+3 of a hierarchical side of a row, as side_at reads
// them: the f32 values in one 16-byte load (nd % 4 == 0, k0 % 4 == 0: no run
// wraps a super-block), the 8-bit factors in one 4-byte load. Zeros when
// !ok.
template <int kSide>
__device__ __forceinline__ float4 side4(const float* base, const uint8_t* sub, int k0, int nd,
                                        bool ok) {
  if (!ok) return float4{0.f, 0.f, 0.f, 0.f};
  const float4 f = __ldg(reinterpret_cast<const float4*>(base + k0 % nd));
  const uint32_t b = __ldg(reinterpret_cast<const uint32_t*>(sub + k0));
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float fe = e == 0 ? f.x : e == 1 ? f.y : e == 2 ? f.z : f.w;
    const int be = kSide == kHierI8 ? (int)(int8_t)(b >> (8 * e)) : (int)((b >> (8 * e)) & 0xff);
    v[e] = __fmul_rn(fe, (float)be);
  }
  return float4{v[0], v[1], v[2], v[3]};
}

// Four words w[j] (bytes: sub-blocks c = 0..3 of code row t'+j) to four
// words col[c] (bytes: rows j = 0..3 of sub-block c).
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4], uint32_t (&col)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362), t3 = __byte_perm(w[2], w[3], 0x7362);
  col[0] = __byte_perm(t0, t1, 0x5410);
  col[1] = __byte_perm(t0, t1, 0x7632);
  col[2] = __byte_perm(t2, t3, 0x5410);
  col[3] = __byte_perm(t2, t3, 0x7632);
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float bf16_of(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Two f32 values as three bf16 parts each, v = h + m + l to within 2^-24 of
// v (each residue exact in f32), packed in pairs.
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& h, uint32_t& m,
                                       uint32_t& l) {
  const float h0 = bf16_of(v0), h1 = bf16_of(v1);
  const float r0 = __fsub_rn(v0, h0), r1 = __fsub_rn(v1, h1);
  const float m0 = bf16_of(r0), m1 = bf16_of(r1);
  h = bf16x2_bits(h0, h1);
  m = bf16x2_bits(m0, m1);
  l = bf16x2_bits(__fsub_rn(r0, m0), __fsub_rn(r1, m1));
}

// Byte offset of word q (sub-blocks 4q..4q+3) of code row t' of tile row
// `row` in a group's code tile ([t'][row][16 sub-blocks]).
__device__ __forceinline__ int code_at(int row, int tp, int q) {
  return tp * (kI8M * kI8G) + row * kI8G + 4 * q;
}

// Index of (row, sub-block k of a group) in a factor table: rows of 16 f32
// with the 64-byte swizzle, as TMA lands a flat side's box.
__device__ __forceinline__ int ftab(int row, int k) {
  const int off = row * 64 + k * 4;
  return (off ^ ((off >> 3) & 0x30)) >> 2;
}

// Byte offset of (row, col) in a K-major tile of 64 bf16 a row with the
// 128-byte swizzle (the tile 1024-byte aligned), as wgmma reads it.
__device__ __forceinline__ int swz128(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// Calls f(std::integral_constant<int, i>) for i = 0 .. kN-1, so register
// arrays are indexed by constants.
template <class F, int... I>
__device__ __forceinline__ void unroll_seq(F&& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}
template <int kN, class F>
__device__ __forceinline__ void static_for(F&& f) {
  unroll_seq(f, std::make_integer_sequence<int, kN>{});
}

template <int kSub, int kS, int kM, int kN>
__global__ void __launch_bounds__(kI8Threads, 1)
quant_matmul_int8_tc_kernel(const ArgsInt8TC a, const __grid_constant__ CUtensorMap tmx,
                            const __grid_constant__ CUtensorMap tmc,
                            const __grid_constant__ CUtensorMap tmxs,
                            const __grid_constant__ CUtensorMap tmd,
                            const __grid_constant__ CUtensorMap tmm) {
  using L = I8Smem<kSub, kN>;
  constexpr int kH = kN / 64;            // 64-row halves of the activation tile
  constexpr int kSpb = 128 / kSub;       // sub-blocks a stage (4 or 8)
  constexpr int kSpg = kI8G / kSpb;      // stages a group (4 or 2)
  constexpr int kGU = kI8G * kH;         // units a group
  extern __shared__ __align__(16) unsigned char smem[];
  // aligned to 1024 bytes by an offset on smem itself, so that the compiler
  // keeps every access derived from it a shared-memory one (32-bit
  // addresses, LDS/STS), not a generic one
  unsigned char* const sm = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  // The barriers and the walk, set up in the block's first thread for the
  // barriers' init and in each warpgroup's branch after its setmaxnreg (a
  // value live across it is spilled where the producer gives registers
  // back).
#define LGT_I8_SETUP                                                                    \
  uint64_t* const full = reinterpret_cast<uint64_t*>(sm + L::kBar);                      \
  uint64_t* const empty = full + L::kStages;                                             \
  uint64_t* const cfull = empty + L::kStages;   /* a group's code tile landed */         \
  uint64_t* const cempty = cfull + 2;           /* both consumers done with it */        \
  uint64_t* const afull = cempty + 2;           /* a group's factor stage written */     \
  uint64_t* const aempty = afull + L::kAuxs;    /* both consumers done with it */        \
  uint64_t* const araw = aempty + L::kAuxs;     /* its TMA loads landed */               \
  const int groups = a.nsub / kI8G;                                                      \
  const int tiles_n = (a.B + kN - 1) / kN;                                               \
  const int tiles = ((a.out_f + kI8M - 1) / kI8M) * tiles_n;

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  if (tid == 0) {
    LGT_I8_SETUP
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(cfull + s, 1);
      mbar_init(cempty + s, 2);
    }
    for (int s = 0; s < L::kAuxs; ++s) {
      mbar_init(afull + s, 3);
      mbar_init(aempty + s, 2);
      mbar_init(araw + s, 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    setmaxnreg_dec<L::kProdRegs>();
    LGT_I8_SETUP
    const int pw = (tid >> 5) & 3;
    if (pw == 0) {
      if (lane == 0) {
        // a group: the TMA loads of its factor stage (xsx's rows, a flat
        // side's 128 rows x 16 sub-blocks), its code tile (one load of 128
        // rows x 16 bytes a code row t'), then its stages of x
        int it = 0, gc = 0;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
          const int m0 = (tile / tiles_n) * kI8M, n0 = (tile % tiles_n) * kN;
          for (int grp = 0; grp < groups; ++grp, ++gc) {
            const int as = gc % L::kAuxs, ap = (gc / L::kAuxs) & 1;
            unsigned char* const ax = sm + L::kAux + as * L::kAuxBytes;
            mbar_wait(aempty + as, ap ^ 1);
            mbar_arrive_tx(araw + as, L::kX + ((kS == kFlat) + (kM == kFlat)) * kI8G * kI8M * 4);
            tma_load_2d(ax + L::kAuxX, &tmxs, grp * 2 * kI8G, n0, araw + as);
            if constexpr (kS == kFlat) tma_load_2d(ax, &tmd, grp * kI8G, m0, araw + as);
            if constexpr (kM == kFlat) tma_load_2d(ax + L::kAuxM, &tmm, grp * kI8G, m0, araw + as);
            unsigned char* const cd = sm + L::kCs + (gc & 1) * L::kCode;
            mbar_wait(cempty + (gc & 1), ((gc >> 1) & 1) ^ 1);
            mbar_arrive_tx(cfull + (gc & 1), L::kCode);
            for (int tp = 0; tp < kSub / 2; ++tp)
              tma_load_2d(cd + tp * kI8M * kI8G, &tmc, tp * a.nsub + grp * kI8G, m0,
                          cfull + (gc & 1));
            for (int s = 0; s < kSpg; ++s, ++it) {
              const int st = it % L::kStages;
              mbar_wait(empty + st, ((it / L::kStages) & 1) ^ 1);
              mbar_arrive_tx(full + st, L::kX);
              tma_load_2d(sm + st * L::kX, &tmx, (grp * kSpg + s) * 128, n0, full + st);
            }
          }
        }
      }
    } else {
      // a group's factor stage, once its TMA loads have landed: a
      // hierarchical side's values formed as side_at forms them (4
      // sub-blocks of a row a unit); xsx's (xs, xsum) rows turned into the
      // (xs', c) table and xsum's bf16 parts (4 sub-blocks of a row a unit),
      // one 64-row half at a time, every unit of a half read before the
      // three warps write its table over it
      const int pt = tid - 256 - 32;
      constexpr int kXU = (64 * 4 + 95) / 96;   // xs units a thread and half
      int gc = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * kI8M;
        for (int grp = 0; grp < groups; ++grp, ++gc) {
          const int as = gc % L::kAuxs;
          mbar_wait(araw + as, (gc / L::kAuxs) & 1);
          unsigned char* const ax = sm + L::kAux + as * L::kAuxBytes;
          float* const stab = reinterpret_cast<float*>(ax);
          float* const mtab = reinterpret_cast<float*>(ax + L::kAuxM);
#pragma unroll
          for (int side = 0; side < 2; ++side) {
            constexpr bool kHs = kS != kFlat, kHm = kM != kNone && kM != kFlat;
            if ((side == 0 && !kHs) || (side == 1 && !kHm)) continue;
#pragma unroll 1
            for (int u = pt; u < kI8M * 4; u += 96) {
              const int row = u >> 2, kl = (u & 3) * 4, k0 = grp * kI8G + kl;
              const int o = m0 + row;
              const bool ok = o < a.out_f;
              const size_t orow = ok ? o : 0;
              float4 v = {0.f, 0.f, 0.f, 0.f};
              if (side == 0) {
                if constexpr (kHs) v = side4<kS>(a.d + orow * a.nd, a.sc + orow * a.nsub, k0, a.nd, ok);
              } else {
                if constexpr (kHm) v = side4<kM>(a.dmin + orow * a.nd, a.mn + orow * a.nsub, k0, a.nd, ok);
              }
              *reinterpret_cast<float4*>((side == 0 ? stab : mtab) + ftab(row, kl)) = v;
            }
          }
          unsigned char* const raw = ax + L::kAuxX;
          float2* const xtab = reinterpret_cast<float2*>(raw);
#pragma unroll 1
          for (int h = 0; h < kN / 64; ++h) {
            // (xs, xsum) of row b, sub-blocks kq..kq+3, at the raw tile's
            // swizzled 16-byte chunks kq/2 and kq/2 + 1
            float2 xv[kXU][4];
#pragma unroll
            for (int i = 0; i < kXU; ++i) {
              const int u = pt + 96 * i, b = 64 * h + (u >> 2), kq = (u & 3) * 4;
              if (u < 64 * 4) {
                const int o0 = b * 128 + kq * 8, o1 = o0 + 16;
                const float4 v0 = *reinterpret_cast<const float4*>(raw + (o0 ^ ((o0 >> 3) & 0x70)));
                const float4 v1 = *reinterpret_cast<const float4*>(raw + (o1 ^ ((o1 >> 3) & 0x70)));
                const float xs[4] = {v0.x, v0.z, v1.x, v1.z}, xm[4] = {v0.y, v0.w, v1.y, v1.w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  // xs' = xs rounded to 22 significant bits: M * xs' is exact
                  const float x2 = __uint_as_float((__float_as_uint(xs[e]) + 2u) & ~3u);
                  xv[i][e] = float2{x2, __fmul_rn(-kMagicF, x2)};
                }
                // xsum as three bf16 parts (split3): the min term's B, the
                // group's slot (group % 2) of 32 columns in the first tile
                // holding h and m, of the second l; a pair at a time
                uint32_t p3[3][2];
#pragma unroll
                for (int e = 0; e < 2; ++e) split3(xm[2 * e], xm[2 * e + 1], p3[0][e], p3[1][e], p3[2][e]);
                const int off = swz128(b, (gc & 1) * 2 * kI8G + kq);
                const int offm = swz128(b, (gc & 1) * 2 * kI8G + kI8G + kq);
                *reinterpret_cast<uint2*>(sm + L::kXsum + off) = uint2{p3[0][0], p3[0][1]};
                *reinterpret_cast<uint2*>(sm + L::kXsum + offm) = uint2{p3[1][0], p3[1][1]};
                *reinterpret_cast<uint2*>(sm + L::kXsum + L::kX + off) = uint2{p3[2][0], p3[2][1]};
              }
            }
            named_bar_sync(3, 96);   // every raw row of the half read
#pragma unroll
            for (int i = 0; i < kXU; ++i) {
              const int u = pt + 96 * i, bl = u >> 2, kq = (u & 3) * 4;
              if (u < 64 * 4) {
#pragma unroll
                for (int e = 0; e < 4; ++e) xtab[(h * kI8G + kq + e) * 64 + bl] = xv[i][e];
              }
            }
          }
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(afull + as);
        }
      }
    }
  } else {
    setmaxnreg_inc<L::kConsRegs>();
    LGT_I8_SETUP
    // this thread's accumulators: output rows r0 (e < 2) and r0 + 8 of the
    // tile (rows g, g+8 of its warp's 16), activation rows 64h + 8j + 2t +
    // e%2; its A fragments: those two rows, elements 4t..4t+3 (and 16+4t..)
    const int w = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
    const int r0 = wg * 64 + w * 16 + g;
    const int tr = kSub == 32 ? 4 * t : 4 * (t & 1);   // the code rows t' it reads
    const int nsh = kSub == 16 && t >= 2 ? 4 : 0;      // sub 16: its elements' nibble
    // scale-d of the s8 wgmmas: 0, the sums replace the bank's values, but
    // not a constant ptxas can see, so that each wgmma reads its bank as it
    // is and ptxas keeps two banks in place (with a constant 0 it gave each
    // unit fresh registers, kept 4-6 banks live and spilled)
    const int keep = a.B < 0;
    float acc[kH][32];
    int bank[2][32];
    uint32_t A[2][4], col[2][4], mh[4], ml[4];
    int s0 = 0, g0 = 0;                                // stages and groups of earlier tiles

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * kI8M, n0 = (tile % tiles_n) * kN;
#pragma unroll
      for (int h = 0; h < kH; ++h)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[h][e] = 0.f;

      // A group is kGU units: unit q is sub-block c = q / kH of the group,
      // half q % kH of the activation tile, into bank q % 2 with A[c % 2].
      // Each group's pipeline starts empty and drains at its end, so every
      // wgmma group is committed and retired within it.
      for (int kg = 0; kg < a.nsub; kg += kI8G) {
        const int grp = g0 + kg / kI8G, sg = s0 + kg / kSpb, as = grp % L::kAuxs;

        // unit q: its sub-block's first unit forms A (from col, whose quad
        // it loads on the quad's first, after the code tile on the group's
        // first) and waits for its stage
        auto issue = [&](auto qc) {
          constexpr int q = decltype(qc)::value, c = q / kH, h = q % kH;
          constexpr int ds = c / kSpb;                                   // stage in the group
          constexpr int step = kSub == 32 ? c % kSpb : (c % kSpb) / 2;   // k32 step in the stage
          uint32_t(&Ab)[4] = A[c % 2];
          if constexpr (h == 0) {
            if constexpr (c % 4 == 0) {
              if constexpr (c == 0) mbar_wait(cfull + (grp & 1), (grp >> 1) & 1);
              const unsigned char* ct = sm + L::kCs + (grp & 1) * L::kCode;
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                uint32_t wd[4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  wd[j] = *reinterpret_cast<const uint32_t*>(ct + code_at(r0 + 8 * r, tr + j, c / 4));
                transpose4(wd, col[r]);
              }
            }
            const uint32_t v0 = (col[0][c % 4] >> nsh) & 0x0F0F0F0Fu;
            const uint32_t v1 = (col[1][c % 4] >> nsh) & 0x0F0F0F0Fu;
            if constexpr (kSub == 32) {
              Ab[0] = v0;
              Ab[1] = v1;
              Ab[2] = (col[0][c % 4] >> 4) & 0x0F0F0F0Fu;
              Ab[3] = (col[1][c % 4] >> 4) & 0x0F0F0F0Fu;
            } else {
              // sub 16: sub-block c fills its half of the k32 step, the
              // other half zero
              Ab[0] = c % 2 == 0 ? v0 : 0u;
              Ab[1] = c % 2 == 0 ? v1 : 0u;
              Ab[2] = c % 2 == 0 ? 0u : v0;
              Ab[3] = c % 2 == 0 ? 0u : v1;
            }
            if constexpr (c % kSpb == 0)
              mbar_wait(full + (sg + ds) % L::kStages, ((sg + ds) / L::kStages) & 1);
          }
          const uint64_t db =
              wgmma_desc(sm + ((sg + ds) % L::kStages) * L::kX + h * 64 * 128) + 2 * step;
          fence_regs(Ab);
          wgmma_fence();
          wgmma_s8(bank[q % 2], Ab, db, keep);
          wgmma_commit();
        };

        // the group's min term: -m' = -(bias*s + m) of this thread's rows
        // (r0, r0 + 8) at sub-blocks 2t, 2t+1, 2t+8, 2t+9, rounded as
        // min_prime rounds it, as two bf16 parts, five bf16 wgmmas a half
        // into the accumulators, a commit group of its own
        auto min_term = [&]() {
          const float* const stab =
              reinterpret_cast<const float*>(sm + L::kAux + as * L::kAuxBytes);
          const float* const mtab = stab + L::kAuxM / 4;
          const float fb = (float)a.bias;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            // A register r: row r0 (+8 for r odd), sub-blocks 2t, 2t+1 (+8 for r >= 2)
            float nv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int at = ftab(r0 + 8 * (r & 1), 2 * t + e + 8 * (r >> 1));
              float mp = kM != kNone ? mtab[at] : 0.f;
              if (a.bias != 0) {
                const float bs = __fmul_rn(fb, stab[at]);
                mp = kM == kNone ? bs : __fadd_rn(bs, mp);
              }
              nv[e] = -mp;
            }
            const float h0 = bf16_of(nv[0]), h1 = bf16_of(nv[1]);
            mh[r] = bf16x2_bits(h0, h1);
            ml[r] = bf16x2_bits(__fsub_rn(nv[0], h0), __fsub_rn(nv[1], h1));
          }
          fence_regs(mh);
          fence_regs(ml);
#pragma unroll
          for (int hh = 0; hh < kH; ++hh) fence_regs(acc[hh]);
          wgmma_fence();
#pragma unroll
          for (int hh = 0; hh < kH; ++hh) {
            const uint64_t dh = wgmma_desc(sm + L::kXsum + hh * 64 * 128) + 4 * (grp & 1);
            const uint64_t dm = dh + 2;
            const uint64_t dl = wgmma_desc(sm + L::kXsum + L::kX + hh * 64 * 128) + 4 * (grp & 1);
            wgmma_rs(acc[hh], mh, dh);
            wgmma_rs(acc[hh], mh, dm);
            wgmma_rs(acc[hh], ml, dh);
            wgmma_rs(acc[hh], mh, dl);
            wgmma_rs(acc[hh], ml, dm);
          }
          wgmma_commit();
        };

        // scale unit q's sums into its half's accumulators
        auto epilogue = [&](auto qc) {
          constexpr int q = decltype(qc)::value, c = q / kH, h = q % kH;
          const float* const stab =
              reinterpret_cast<const float*>(sm + L::kAux + as * L::kAuxBytes);
          const float2 sv = {stab[ftab(r0, c)], stab[ftab(r0 + 8, c)]};
          const float4* const xt =
              reinterpret_cast<const float4*>(stab + 2 * kI8G * kI8M) + (h * kI8G + c) * 32 + t;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            // at most 2 float4 of (xs', c) loaded ahead of their use
            if (j % 2 == 0 && j > 0) asm volatile("" ::: "memory");
            const float4 xv = xt[4 * j];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float pf = __int_as_float(bank[q % 2][4 * j + e] + kMagic);
              const float tx = __fmaf_rn(pf, e & 1 ? xv.z : xv.x, e & 1 ? xv.w : xv.y);
              acc[h][4 * j + e] = __fmaf_rn(tx, e >> 1 ? sv.y : sv.x, acc[h][4 * j + e]);
            }
          }
          // the scaling done here, before the next unit's issue: its bank is
          // free for the unit after, and only two banks live
          fence_regs(acc[h]);
          fence_regs(bank[q % 2]);
        };

        // the min term first, while no bank is in flight; the first wait
        // retires it with unit 0
        mbar_wait(afull + as, (grp / L::kAuxs) & 1);
        min_term();
        issue(std::integral_constant<int, 0>{});
        static_for<kGU>([&](auto qc) {
          constexpr int q = decltype(qc)::value, c = q / kH, h = q % kH;
          if constexpr (q + 1 < kGU) {
            issue(std::integral_constant<int, q + 1>{});
            wgmma_wait<1>();
          } else {
            wgmma_wait<0>();
          }
          fence_regs(bank[q % 2]);
          fence_regs(acc[h]);
          // unit q has completed in every warp of the warpgroup (and with
          // it the min term): its stage goes back after the stage's last
          // unit, the code tile after the first unit of the group's last
          // quad (every warp has read it)
          if ((tid & 127) == 0) {
            if constexpr (h == kH - 1 && c % kSpb == kSpb - 1)
              mbar_arrive(empty + (sg + c / kSpb) % L::kStages);
            if constexpr (q == (kI8G - 4) * kH) mbar_arrive(cempty + (grp & 1));
          }
          epilogue(qc);
        });
        // every warp is past the group's last epilogue
        named_bar_sync(1 + wg, 128);
        if ((tid & 127) == 0) mbar_arrive(aempty + as);
      }
      s0 += a.nsub / kSpb;
      g0 += groups;

      // accumulator (h, 4j + e): output row m0 + r0 (+8 for e >= 2),
      // activation row n0 + 64h + 8j + 2t + e%2
#pragma unroll
      for (int h = 0; h < kH; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int b = n0 + 64 * h + 8 * j + 2 * t + (e & 1), o = m0 + r0 + 8 * (e >> 1);
            if (b < a.B && o < a.out_f) a.y[(size_t)b * a.out_f + o] = acc[h][4 * j + e];
          }
    }
  }
}

#undef LGT_I8_SETUP

// A launch's tensor maps, built on the host for each call: x (B rows of in
// bytes, stages of kN rows x 128 bytes), the codes (out rows of in/2 bytes,
// 128 rows x the 16 bytes of one code row t' of a group), xsx (B rows of
// nsub (xs, xsum) pairs, kN rows x a group's 16 pairs) and each flat side
// (out rows of nsub f32, 128 rows x a group's 16; a side not flat: x's map,
// unused).
template <int kS, int kM, int kN>
int tensor_maps(const ArgsInt8TC& a, CUtensorMap (&tm)[5]) {
  int rc = tensor_map(&tm[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.xq, a.in_f, a.B, 128, kN,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = tensor_map(&tm[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.codes, a.in_f / 2, a.out_f, kI8G,
                    kI8M, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc == 0)
    rc = tensor_map(&tm[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.xsx, 2 * a.nsub, a.B, 2 * kI8G,
                    kN, CU_TENSOR_MAP_SWIZZLE_128B);
  tm[3] = tm[4] = tm[0];
  if (rc == 0 && kS == kFlat)
    rc = tensor_map(&tm[3], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.d, a.nsub, a.out_f, kI8G, kI8M,
                    CU_TENSOR_MAP_SWIZZLE_64B);
  if (rc == 0 && kM == kFlat)
    rc = tensor_map(&tm[4], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.dmin, a.nsub, a.out_f, kI8G,
                    kI8M, CU_TENSOR_MAP_SWIZZLE_64B);
  return rc;
}

// kN activation rows a tile: 64 for at most 64 rows or sub 16, else 128.
// The grid is the tiles, at most one block an SM of the current device.
template <int kSub, int kS, int kM, int kN>
int launch_i8(const ArgsInt8TC& a, cudaStream_t st, int* plan) {
  using L = I8Smem<kSub, kN>;
  const auto kernel = quant_matmul_int8_tc_kernel<kSub, kS, kM, kN>;
  static CardCache cards;
  Card c;
  int rc = cards.get(kernel, 0, c);
  if (rc != 0) return rc;
  if (L::kBytes > c.smem_block) return (int)cudaErrorInvalidValue;
  const int tiles = ((a.out_f + kI8M - 1) / kI8M) * ((a.B + kN - 1) / kN);
  const int grid = tiles < c.sms ? tiles : c.sms;
  CUtensorMap tm[5];
  if (plan != nullptr) {
    // grid (x, y), threads, shared memory, registers, local bytes, blocks an
    // SM, kN, and the host's ns to build the tensor maps (the mean of 64
    // builds over a stand-in address)
    cudaFuncAttributes fa;
    rc = (int)cudaFuncGetAttributes(&fa, kernel);
    if (rc != 0) return rc;
    int per_sm = 0;
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kI8Threads, L::kBytes);
    if (rc != 0) return rc;
    ArgsInt8TC s = a;
    s.xq = reinterpret_cast<const int8_t*>(uintptr_t{1} << 20);
    s.codes = reinterpret_cast<const uint8_t*>(uintptr_t{1} << 20);
    s.xsx = s.d = s.dmin = reinterpret_cast<const float*>(uintptr_t{1} << 20);
    const auto t0 = std::chrono::steady_clock::now();
    for (int i = 0; rc == 0 && i < 64; ++i) rc = tensor_maps<kS, kM, kN>(s, tm);
    if (rc != 0) return rc;
    const long ns = (long)std::chrono::duration_cast<std::chrono::nanoseconds>(
                        std::chrono::steady_clock::now() - t0).count() / 64;
    const int v[9] = {grid, 1, kI8Threads, L::kBytes, fa.numRegs, (int)fa.localSizeBytes, per_sm,
                      kN, (int)ns};
    for (int i = 0; i < 9; ++i) plan[i] = v[i];
    return 0;
  }
  rc = tensor_maps<kS, kM, kN>(a, tm);
  if (rc != 0) return rc;
  quant_matmul_int8_tc_kernel<kSub, kS, kM, kN><<<grid, kI8Threads, L::kBytes, st>>>(a, tm[0], tm[1], tm[2], tm[3], tm[4]);
  return (int)cudaGetLastError();
}

template <int kSub, int kS, int kM>
int launch_rows(const ArgsInt8TC& a, cudaStream_t st, int* plan) {
  if constexpr (kSub == 16) {
    return launch_i8<kSub, kS, kM, 64>(a, st, plan);
  } else {
    if (a.B <= 64) return launch_i8<kSub, kS, kM, 64>(a, st, plan);
    return launch_i8<kSub, kS, kM, 128>(a, st, plan);
  }
}

// The (scale side, min side) pairs lgt_quant_matmul_int8 takes.
template <int kSub>
int launch_sides(const ArgsInt8TC& a, int s_side, int m_side, cudaStream_t st, int* plan) {
#define LGT_CASE(S, M) \
  if (s_side == S && m_side == M) return launch_rows<kSub, S, M>(a, st, plan);
  LGT_CASE(kFlat, kNone) LGT_CASE(kFlat, kFlat)
  LGT_CASE(kHierU8, kNone) LGT_CASE(kHierU8, kHierU8) LGT_CASE(kHierU8, kHierI8)
  LGT_CASE(kHierI8, kNone) LGT_CASE(kHierI8, kHierU8) LGT_CASE(kHierI8, kHierI8)
#undef LGT_CASE
  return (int)cudaErrorInvalidValue;
}

int run(const ArgsInt8TC& a, int s_side, int m_side, cudaStream_t st, int* plan) {
  if (a.nsub <= 0 || a.in_f % a.nsub || a.nsub % kI8G || a.nd <= 0 || a.nd % 4 || a.nsub % a.nd)
    return (int)cudaErrorInvalidValue;
  if (plan == nullptr && (a.B == 0 || a.out_f == 0)) return 0;
  if (a.in_f / a.nsub == 32) return launch_sides<32>(a, s_side, m_side, st, plan);
  if (a.in_f / a.nsub == 16) return launch_sides<16>(a, s_side, m_side, st, plan);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// xq (B, nsub, sub) int8, each row's sub-blocks in turn (the block-minor
// quantize_acts codes permuted); xsx (B, nsub, 2) f32, each sub-block's
// activation scale and exact block sum; codes (out, in/2) u8 planar
// nibbles; d (out, nd) f32; sc (out, nsub) u8/i8 or null; dmin f32 or null
// ((out, nsub) flat, (out, nd) beside mn); mn (out, nsub) u8/i8 or null ->
// y (B, out) f32. Needs sub 16 or 32, nsub % 16 == 0, nd % 4 == 0 dividing
// nsub; 16-byte aligned arrays.
int lgt_quant_matmul_int8_tc(const void* xq, const void* xsx, const void* codes, const void* d,
                             const void* sc, const void* dmin, const void* mn, void* y, int B,
                             int in_f, int out_f, int nsub, int nd, int bias, int s_side,
                             int m_side, void* stream) {
  const ArgsInt8TC a{(const int8_t*)xq, (const float*)xsx, (const uint8_t*)codes,
                     (const float*)d, (const uint8_t*)sc, (const float*)dmin,
                     (const uint8_t*)mn, (float*)y, B, in_f, out_f, nsub, nd, bias};
  return run(a, s_side, m_side, (cudaStream_t)stream, nullptr);
}

// The launch a call of B rows would make, into info[9]: grid (x, y),
// threads, dynamic shared memory, registers (at the kernel's entry, before
// setmaxnreg), local bytes, resident blocks an SM, activation rows a tile,
// and the host's ns to build its tensor maps.
int lgt_quant_matmul_int8_tc_plan(int B, int in_f, int out_f, int nsub, int s_side, int m_side,
                                  int* info) {
  const int nd = s_side == kFlat ? nsub : in_f / 256;
  const ArgsInt8TC a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     B, in_f, out_f, nsub, nd, 0};
  return run(a, s_side, m_side, nullptr, info);
}

}  // extern "C"
