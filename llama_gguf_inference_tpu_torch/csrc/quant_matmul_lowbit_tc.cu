// Tensor-core path of the 2- and 4-bit dequantize + matmul, for prefill-sized
// row counts, for Hopper (sm_90a): wgmma, TMA and mbarriers.
//
// Replaces, from ops/quant_matmul.py's LOWBIT_TC_MIN_ROWS activation rows
// up, these TPU bodies of llama_gguf_inference_tpu/ops/pallas_matmul.py:
//   fsplit rule, pallas_call at :641:
//     lgt_quant_matmul_4bit_tc <- _make_kernel_fsplit (:421): planar nibbles
//                                (Q4_K, Q4_0, Q4_1; Q3_K's 3-bit codes with
//                                bias 4; the IQ2/IQ3 code->value maps)
//     lgt_quant_matmul_2bit_tc <- _make_kernel_qsplit (:481): planar quarters
//                                (Q2_K)
//   xsum rule, pallas_call at :641 (LGT_MM_VARIANT=xsum or split):
//     lgt_quant_matmul_4bit_tc, var xsum <- _make_kernel_xsum (:309) and
//                                _make_kernel_split (:362); 4-bit identity
//                                codes (Q4_K, Q4_0, Q4_1, Q3_K)
//   base rules, pallas_call at :247 (_make_kernel, LGT_MM_VARIANT=base):
//     lgt_quant_matmul_4bit_tc, var base <- the bf16-magic 4-bit branch
//                                (:157-171; Q4_K, Q4_0, Q4_1, Q3_K)
//     lgt_quant_matmul_{2,4}bit_tc, var base_f32 <- the f32 branch (:172-192;
//                                Q2_K, and the IQ2/IQ3-mapped 4-bit codes)
// Fewer rows, or a geometry this kernel does not take, run
// lgt_quant_matmul_lowbit in quant_matmul.cu, the decode kernel. Both take
// each rule's arithmetic from lowbit_rule.cuh.
//
// The xsum rule's weight is bf16(q * bf16(s)), the raw code times the scale
// rounded to bf16 first; its min term is fsplit's, xsum.m' with m' = bias*s
// + m in f32 (pallas_matmul.py:296-305). The split body differs from xsum
// only in summing the two nibble planes' dots apart and adding them at the
// end: an order of f32 sums. This kernel walks every plane as steps of its
// own into one accumulator under any rule, so split runs xsum's instances
// (its wrapper counts its launches under its own name).
//
// The base rules fold the min into the weight (w = bf16(bf16(q*bf16 s) -
// bf16 m') and w = bf16((v(q) - bias)*s - m) in f32), so their instances
// have no xsum term; the decode keeps the min beside the scale. The base
// rules take no mixed layout, as the JAX dispatcher sends it to matmul_xla.
//
// The fsplit rule computes what the decode kernel's fsplit rule computes: with P =
// 8/bits code planes, q = in/P stored bytes a row, plane i's code of stored
// byte j c_i = (byte >> bits*i) & (2^bits - 1) and k = j mod nsub,
//   y[b,o] = sum_i sum_j x[b, i*q + j] * bf16(v(c_i) * s[k])
//            - sum_k xsum[b,k] * m'[k],   m'[k] = bias*s[k] + m[k]
// s and m read in the layouts side_at reads (flat, or f32 per super-block
// times an 8-bit factor; the min side of the mixed layout per min_size, with
// xsum permuted into its order by the caller and bias 0). The weight is
// exact in bf16, so its products with bf16 x are exact in f32. The min term
// runs on the tensor cores in split bf16: -m' = h + l and xsum = xh + xl,
// each part rounded to bf16, and the term is h.xh + h.xl + l.xh; what it
// drops (l.xl and the parts' residues) is under 2^-16 of each product, a few
// 1e-7 of the output's scale at the 8B shapes, against the 1e-4 the card
// tests and chip_smoke.py hold it to (1e-5 in the CPU emulation).
//
// What bounds it: at B = 512 rows, operations (2*B*in*out over 989 TFLOP/s
// bf16: 0.1216 ms at gate+up 28672x4096); below about 64 rows, the weight
// bytes.
//
// Design: one persistent block an SM walks tiles of 128 output rows by kN
// activation rows (kN = 128; 64 for at most 64 rows), the activation tiles
// fastest, so the blocks that share a weight tile run together and read its
// codes once from the card's memory.
// - Warpgroups: a producer (warp 0 issues the TMA loads; warps 1-3 fill
//   each chunk's factor stage) and two consumers, each the M side of 64
//   output rows; setmaxnreg gives the consumers 192 registers and the
//   producer 120 (the split with no spill in any instance; 2 x 192 + 120 =
//   3 x 168, the registers a block starts with).
// - A step covers 64 positions of one code plane (wgmma's K of 4 x 16). Its
//   x tile (kN rows of 128 bytes) comes by TMA with the 128-byte swizzle that
//   wgmma's B descriptor reads; on a plane group's first step the group's
//   code tile (128 rows x 64 stored bytes, 64-byte swizzle, so the 8 rows a
//   warp reads fall on distinct banks) comes with it. A ring of 4 stages,
//   each with a full barrier (the TMA bytes) and an empty one (an arrival
//   from each consumer once its wgmma of the step has completed).
// - Planar storage: one stored byte feeds P steps. A step is (byte group t,
//   plane i) with planes innermost, chunk kc's steps at t*nsub + kc*64; a
//   consumer reads its codes from the group's tile once, on plane 0, and
//   keeps them in registers for the group's P steps.
// - The decode (weights as wgmma's A from registers): each thread decodes
//   the 32 weights of its m16n8k16 A fragments (rows g and g+8 of its warp's
//   16, positions 2t, 2t+1, 2t+8, 2t+9 of each 16) straight into the
//   registers wgmma reads; no weight tile in shared memory, no barrier
//   between decode and products. Each position of a step is its own
//   sub-block (block-minor layout), so a thread keeps its 32 positions'
//   factors of a chunk of 64 sub-blocks in registers, read at the chunk's
//   start from the factor stage. Elements are exact:
//   fsplit fma(2^23 + v, s, -2^23*s) = v*s rounded once, xsum and base
//   fma.rn.bf16x2(128 + v, bf16 s, -128*bf16 s) (base then sub.rn.bf16x2 of
//   bf16 m'), base_f32 ((2^23 + v) - (2^23 + bias))*s - m in f32. Two
//   fragment buffers: a step decodes into one while the other's wgmma runs.
// - The factor stage: the producer's warps 1-3 write a chunk's scale- and
//   min-side values (128 rows x 64 sub-blocks, f32; a flat side by TMA, two
//   32-column boxes with the 128-byte swizzle; a hierarchical one formed as
//   side_at forms it) and, with the min term, its xsum as bf16 parts (the
//   min term's B tile, 128-byte swizzle), while the consumers run the chunk
//   before. Loaded by the consumers themselves
//   at each chunk's start, the factors' latency cost a quarter of the time
//   at Q4_K and half at Q2_K; formed into the min term's A tile by the
//   producer, the work held Q2_K's chunks back (PERF.md §6).
// - The min term (fsplit, xsum): at a chunk's start each consumer thread
//   writes -m' of its 32 positions as bf16 parts (h + l) into its
//   warpgroup's A tile, the warpgroup meets at a named barrier, and three
//   wgmma groups (h.xh, h.xl, l.xh) join the chunk's products in the same
//   accumulators. The stage goes back to the producer once a chunk's second
//   step has retired its first step's group.
// - The epilogue stores the accumulators straight from registers: each warp
//   store writes 32-byte runs of 8 consecutive output columns, whole
//   sectors. Ragged rows and columns: TMA fills loads past B or out with
//   zeros, their factors are zero, and only rows < B and columns < out are
//   stored.
// - Needs nsub % 64 == 0, sub % P == 0 and nd % 4 == 0 (in = 4096 and 14336
//   at sub-blocks of 16 or 32); the wrapper keeps other geometries on the
//   decode kernel.

#include <chrono>

#include "tc_common.cuh"
#include "lowbit_rule.cuh"

namespace {

constexpr int kLtM = 128;             // output rows a tile, 64 a consumer warpgroup
constexpr int kLtThreads = 384;       // consumer warpgroups 0 and 1, producer 2
constexpr int kLtCode = kLtM * kBK;   // code tile bytes
constexpr int kLtConsRegs = 192, kLtProdRegs = 120;

// Whether rule kVar subtracts the min term xsum.m' (fsplit and xsum) rather
// than folding the min into the weight (base, base_f32).
template <int kVar>
constexpr bool kMinTerm = kVar == kFsplit || kVar == kXsum;

// Shared memory of a block, from a 1024-byte aligned base: the x ring, the
// code ring, then a chunk's stage of factors: the scale and min sides'
// values (f32, 128 rows x 64 sub-blocks each, ftab's order), the min term's
// -m' parts (its A, 64 rows a consumer) and xsum parts (its B); the
// barriers. 230,480 bytes at kN = 128, of the 232,448 a block may have.
template <int kN>
struct LtSmem {
  static constexpr int kStages = 4;   // TMA ring
  static constexpr int kX = kN * 128;
  static constexpr int kCs = kStages * kX;
  static constexpr int kFs = kCs + kStages * kLtCode;
  static constexpr int kFm = kFs + kLtM * kBK * 4;
  static constexpr int kAh = kFm + kLtM * kBK * 4;
  static constexpr int kAl = kAh + kLtM * 128;
  static constexpr int kXh = kAl + kLtM * 128;
  static constexpr int kXl = kXh + kX;
  static constexpr int kBar = kXl + kX;
  static constexpr int kBytes = kBar + (2 * kStages + 2) * 8 + 1024;
};

struct ArgsLowTC {
  const __nv_bfloat16* x;  // (B, in) block-minor
  const float* xsum;       // (B, nsub), in the min side's sub-block order
  const uint8_t* codes;    // (out, in * bits / 8) planar
  const float* d;          // (out, nd)
  const uint8_t* sc;       // (out, nsub) or null
  const float* dmin;       // (out, ndm) or null
  const uint8_t* mn;       // (out, nsub) or null
  float* y;                // (B, out)
  int B, in_f, out_f, nsub, nd, ndm, bias;
};

// Byte offset of (row, col) in a K-major tile of 64 bf16 a row with the
// 128-byte swizzle (the tile 1024-byte aligned), as TMA and wgmma lay it.
__device__ __forceinline__ int swz128(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// Index of (row, sub-block col) in a factor table, as TMA lays two (128 x
// 32) f32 boxes with the 128-byte swizzle: cols 0-31, then 32-63; row r's
// 16-byte chunk c at chunk c ^ (r mod 8), so a warp's reads of 8 rows at
// one column spread over the banks. 4 cols from a multiple of 4 stay
// together.
__device__ __forceinline__ int ftab(int row, int col) {
  return (col >> 5) * (kLtM * 32) + row * 32 + ((((col & 31) >> 2) ^ (row & 7)) << 2) + (col & 3);
}

// Sub-blocks k0..k0+15 of one side of a row, as side_at reads them: in
// 16-byte loads where the side's f32 array allows them (chunk_side), else
// one by one.
template <int kSide>
__device__ __forceinline__ void side16(const float* base, const uint8_t* sub, int k0, int nd,
                                       bool ok, float (&v)[16]) {
  if (kSide == kFlat || nd % 4 == 0) {
    chunk_side<kSide, 16>(base, sub, k0, nd, ok, v);
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] = ok ? side_at<kSide>(base, sub, k0 + e, (k0 + e) % nd) : 0.f;
  }
}

// Four codes of one plane (bytes of nib, at positions 2t, 2t+1, 2t+8, 2t+9
// of a 16-position slice) to two A fragment words, the lower position in the
// lower half, exactly as element() forms them. fa and fb hold the slice's
// factors in the form each rule reads:
//   fsplit    fa = s, fb = -2^23*s (f32 bits): fma(2^23 + v, s, -2^23*s);
//             a mapped code: ((2^23 + 128 + v) - magic)*s
//   base_f32  fa = s, fb = m: ((2^23 + v) - magic)*s - m
//   xsum      fa = {(b0, b1), -128*(b0, b1), (b2, b3), -128*(b2, b3)} as
//             bf16 pairs, b = bf16(s): fma.bf16x2(128 + v, b, -128*b)
//   base      the same (-128*b formed from b), then sub.bf16x2 of fb =
//             {(m0, m1), (m2, m3)}
// magic is 2^23 + bias (and + 128 for mapped codes).
template <int kVar, int kM, int kMap>
__device__ __forceinline__ void decode4(uint32_t nib, const uint32_t (&fa)[4],
                                        const uint32_t (&fb)[4], float magic, uint32_t& w0,
                                        uint32_t& w1) {
  if constexpr (kVar == kXsum || kVar == kSplit || kVar == kBase) {
    // base: -128*b formed here (exact: b times bf16 -128, plus -0), which
    // keeps its 16 registers of m' beside the scales within the budget
    const uint32_t n0 = kVar == kBase ? fma_bf16x2(fa[0], 0xC300C300u, 0x80008000u) : fa[1];
    const uint32_t n2 = kVar == kBase ? fma_bf16x2(fa[2], 0xC300C300u, 0x80008000u) : fa[3];
    w0 = fma_bf16x2(__byte_perm(nib, 0x43u, 0x4140u), fa[0], n0);
    w1 = fma_bf16x2(__byte_perm(nib, 0x43u, 0x4342u), fa[2], n2);
    if constexpr (kVar == kBase) {
      w0 = sub_bf16x2(w0, fb[0]);
      w1 = sub_bf16x2(w1, fb[1]);
    }
  } else {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float s = __uint_as_float(fa[e]);
      float c;
      if constexpr (kMap == kIdentity)
        c = __int_as_float((int)__byte_perm(nib, 0x4B000000u, 0x7440u | e));
      else
        c = __int_as_float(0x4B000000 | (code_value<kMap>((int)((nib >> (8 * e)) & 0xF)) + 128));
      if constexpr (kVar == kFsplit && kMap == kIdentity) {
        v[e] = __fmaf_rn(c, s, __uint_as_float(fb[e]));
      } else {
        v[e] = __fmul_rn(__fsub_rn(c, magic), s);
        if constexpr (kVar == kBaseF32 && kM != kNone) v[e] = __fsub_rn(v[e], __uint_as_float(fb[e]));
      }
    }
    w0 = bf16_bits(v[0], v[1]);
    w1 = bf16_bits(v[2], v[3]);
  }
}

template <int kBits, int kVar, int kMap, int kS, int kM, int kN>
__global__ void __launch_bounds__(kLtThreads, 1)
quant_matmul_lowbit_tc_kernel(const ArgsLowTC a, const __grid_constant__ CUtensorMap tmx,
                              const __grid_constant__ CUtensorMap tmc,
                              const __grid_constant__ CUtensorMap tmd,
                              const __grid_constant__ CUtensorMap tmm) {
  using L = LtSmem<kN>;
  constexpr int kP = 8 / kBits;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const sm =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
  uint64_t* const full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* const empty = full + L::kStages;
  uint64_t* const aux_full = empty + L::kStages;   // a chunk's factor stage written
  uint64_t* const aux_empty = aux_full + 1;       // both consumers done with it
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const bool min_live = kMinTerm<kVar> && (kM != kNone || a.bias != 0);
  if (tid == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);
    }
    mbar_init(aux_full, 3);
    mbar_init(aux_empty, 2);
    mbar_fence_init();
  }
  __syncthreads();

  const int q = a.in_f / kP;         // stored bytes a row
  const int sub = a.in_f / a.nsub;   // steps a chunk
  const int steps = a.in_f / kBK;
  const int chunks = a.nsub / kBK;
  const int tiles_n = (a.B + kN - 1) / kN;
  const int tiles = ((a.out_f + kLtM - 1) / kLtM) * tiles_n;

  if (wg == 2) {
    setmaxnreg_dec<kLtProdRegs>();
    const int pw = (tid >> 5) & 3;
    if (pw == 0) {
      if (lane == 0) {
        // step i of a tile: x columns p*q + j0.. of its kN rows, and on a
        // plane group's first step the group's code tile
        int it = 0;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
          const int m0 = (tile / tiles_n) * kLtM, n0 = (tile % tiles_n) * kN;
          for (int i = 0; i < steps; ++i, ++it) {
            const int st = it % L::kStages, n = i % sub, p = n % kP;
            const int j0 = (n / kP) * a.nsub + (i / sub) * kBK;
            mbar_wait(empty + st, ((it / L::kStages) & 1) ^ 1);
            mbar_arrive_tx(full + st, L::kX + (p == 0 ? kLtCode : 0));
            tma_load_2d(sm + st * L::kX, &tmx, p * q + j0, n0, full + st);
            if (p == 0) tma_load_2d(sm + L::kCs + st * kLtCode, &tmc, j0, m0, full + st);
          }
        }
      }
    } else {
      // a chunk's factor stage, one chunk ahead of the consumers: the scale
      // and min sides' values of the tile's 128 rows x 64 sub-blocks (a flat
      // side by TMA, a hierarchical one 16 a unit) and, with the min term,
      // the chunk's xsum (kN rows, 8 sub-blocks a unit, 4 units in flight)
      // as bf16 parts h = bf16(v), l = bf16(v - h) into the B tile
      const int pt = tid - 256 - 32;
      int ck = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * kLtM, n0 = (tile % tiles_n) * kN;
        for (int kc = 0; kc < chunks; ++kc, ++ck) {
          mbar_wait(aux_empty, (ck & 1) ^ 1);
          if (pt == 0 && (kS == kFlat || kM == kFlat)) {
            // a flat side's 128 x 64 values by TMA, two boxes of 32 columns
            mbar_expect_tx(aux_full, ((kS == kFlat) + (kM == kFlat)) * kLtM * kBK * 4);
            if constexpr (kS == kFlat) {
              tma_load_2d(sm + L::kFs, &tmd, kc * kBK, m0, aux_full);
              tma_load_2d(sm + L::kFs + kLtM * 128, &tmd, kc * kBK + 32, m0, aux_full);
            }
            if constexpr (kM == kFlat) {
              tma_load_2d(sm + L::kFm, &tmm, kc * kBK, m0, aux_full);
              tma_load_2d(sm + L::kFm + kLtM * 128, &tmm, kc * kBK + 32, m0, aux_full);
            }
          }
          // a hierarchical side's values, formed as side_at forms them: the
          // scale side's units, then the min side's
          float* const fs = reinterpret_cast<float*>(sm + L::kFs);
          float* const fm = reinterpret_cast<float*>(sm + L::kFm);
#pragma unroll
          for (int side = 0; side < 2; ++side) {
            constexpr bool kHs = kS != kFlat, kHm = kM != kNone && kM != kFlat;
            if ((side == 0 && !kHs) || (side == 1 && !kHm)) continue;
            for (int u = pt; u < kLtM * 4; u += 96) {
              const int o = m0 + (u >> 2), k0 = kc * kBK + (u & 3) * 16;
              const bool ok = o < a.out_f;
              const size_t orow = ok ? o : 0;
              float v[16];
              if (side == 0) {
                if constexpr (kHs) side16<kS>(a.d + orow * a.nd, a.sc + orow * a.nsub, k0, a.nd, ok, v);
              } else {
                if constexpr (kHm)
                  side16<kM>(a.dmin + orow * a.ndm, a.mn + orow * a.nsub, k0, a.ndm, ok, v);
              }
#pragma unroll
              for (int h = 0; h < 4; ++h)
                *reinterpret_cast<float4*>((side == 0 ? fs : fm) + ftab(u >> 2, (u & 3) * 16 + 4 * h)) =
                    float4{v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]};
            }
          }
          if (min_live) {
            for (int u0 = pt; u0 < kN * 8; u0 += 4 * 96) {
              float4 v[4][2];
#pragma unroll
              for (int h = 0; h < 4; ++h) {
                const int u = u0 + h * 96, b = n0 + (u >> 3);
                const bool ok = u < kN * 8 && b < a.B;
                const float4* src = reinterpret_cast<const float4*>(
                    a.xsum + (size_t)(ok ? b : 0) * a.nsub + kc * kBK + (u & 7) * 8);
                v[h][0] = ok ? __ldg(src) : float4{0.f, 0.f, 0.f, 0.f};
                v[h][1] = ok ? __ldg(src + 1) : float4{0.f, 0.f, 0.f, 0.f};
              }
#pragma unroll
              for (int h = 0; h < 4; ++h) {
                const int u = u0 + h * 96;
                if (u >= kN * 8) break;
                const float* f = reinterpret_cast<const float*>(v[h]);
                uint32_t hi[4], lo[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const float h0 = bf16_round(f[2 * e]), h1 = bf16_round(f[2 * e + 1]);
                  hi[e] = bf16_bits(h0, h1);
                  lo[e] = bf16_bits(__fsub_rn(f[2 * e], h0), __fsub_rn(f[2 * e + 1], h1));
                }
                const int off = swz128(u >> 3, (u & 7) * 8);
                *reinterpret_cast<uint4*>(sm + L::kXh + off) = uint4{hi[0], hi[1], hi[2], hi[3]};
                *reinterpret_cast<uint4*>(sm + L::kXl + off) = uint4{lo[0], lo[1], lo[2], lo[3]};
              }
            }
          }
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(aux_full);
        }
      }
    }
  } else {
    setmaxnreg_inc<kLtConsRegs>();
    // this thread's A fragment rows: r0 and r0 + 8 of the tile (rows g, g+8
    // of its warp's 16); positions 2t, 2t+1, 2t+8, 2t+9 of each 16
    const int w = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
    const int r0 = wg * 64 + w * 16 + g;
    const uint32_t csel = (t & 1) ? 0x7632u : 0x5410u;
    const float magic = kVar == kBaseF32
        ? __fadd_rn(kMap == kIdentity ? 8388608.f : 8388736.f, (float)a.bias) : 8388736.f;
    unsigned char* const ah = sm + L::kAh + wg * 64 * 128;
    unsigned char* const al = sm + L::kAl + wg * 64 * 128;
    float acc[kN / 2];
    uint32_t A0[4][4], A1[4][4];
    uint32_t fa[2][4][4], fb[2][4][4];   // factors of (row, slice), decode4's form
    uint32_t creg[2][4];                 // (row, slice): 4 codes of the group
    int it = 0, ck = 0, pend = -1;
    bool aux_pend = false;

    // step n of chunk kc: wait for its stage, decode plane n % P into A,
    // start its wgmma group, then retire the group before it: its stage goes
    // back to the producer, and after a chunk's second step the factor stage
    // (the first step's group has completed, so all four warps have read
    // their factors and issued the min term's group before it)
    auto step = [&](int n, uint32_t (&A)[4][4]) {
      const int st = it % L::kStages, p = n % kP;
      mbar_wait(full + st, (it / L::kStages) & 1);
      if (p == 0) {
        const unsigned char* ct = sm + L::kCs + st * kLtCode;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + 8 * r;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint4 v = *reinterpret_cast<const uint4*>(
                ct + row * kBK + ((kk ^ ((row >> 1) & 3)) << 4));
            creg[r][kk] = __byte_perm((t & 2) ? v.y : v.x, (t & 2) ? v.w : v.z, csel);
          }
        }
      }
      constexpr uint32_t kMask = kBits == 4 ? 0x0F0F0F0Fu : 0x03030303u;
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          decode4<kVar, kM, kMap>((creg[r][kk] >> (kBits * p)) & kMask, fa[r][kk], fb[r][kk],
                                  magic, A[kk][r], A[kk][2 + r]);
      wgmma_fence();
      const uint64_t dx = wgmma_desc(sm + st * L::kX);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, A[kk], dx + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();
      if ((tid & 127) == 0) {
        if (pend >= 0) mbar_arrive(empty + pend);
        if (aux_pend && n == 1) mbar_arrive(aux_empty);
      }
      pend = st;
      aux_pend = aux_pend && n == 0;
      ++it;
    };

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * kLtM, n0 = (tile % tiles_n) * kN;
#pragma unroll
      for (int e = 0; e < kN / 2; ++e) acc[e] = 0.f;
      for (int kc = 0; kc < chunks; ++kc, ++ck) {
        // the chunk's factors of this thread's 2 rows x 16 positions
        // (sub-blocks kc*64 + 16kk + 8h + 2t + e), from the factor stage
        mbar_wait(aux_full, ck & 1);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + 8 * r;
          const float* fs = reinterpret_cast<const float*>(sm + L::kFs);
          const float* fm = reinterpret_cast<const float*>(sm + L::kFm);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            float sv[4], mv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int at = ftab(row, 16 * kk + 8 * h + 2 * t);
              const float2 s2 = *reinterpret_cast<const float2*>(fs + at);
              sv[2 * h] = s2.x;
              sv[2 * h + 1] = s2.y;
              if constexpr (kM != kNone) {
                const float2 m2 = *reinterpret_cast<const float2*>(fm + at);
                mv[2 * h] = m2.x;
                mv[2 * h + 1] = m2.y;
              }
            }
            if constexpr (kVar == kXsum || kVar == kBase) {
              float sf[4], m[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int e = 0; e < 4; ++e) rule_factors<kVar, kM>(sv[e], mv[e], a.bias, sf[e], m[e]);
              fa[r][kk][0] = bf16_bits(sf[0], sf[1]);
              fa[r][kk][1] = bf16_bits(-128.f * sf[0], -128.f * sf[1]);
              fa[r][kk][2] = bf16_bits(sf[2], sf[3]);
              fa[r][kk][3] = bf16_bits(-128.f * sf[2], -128.f * sf[3]);
              fb[r][kk][0] = bf16_bits(m[0], m[1]);
              fb[r][kk][1] = bf16_bits(m[2], m[3]);
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                fa[r][kk][e] = __float_as_uint(sv[e]);
                fb[r][kk][e] = __float_as_uint(kVar == kFsplit ? __fmul_rn(-8388608.f, sv[e]) : mv[e]);
              }
            }
            if (min_live) {
              // -m' = -(bias*s + m), rounded as the decode kernel rounds it
              // (the mixed layout: m in its own order, bias 0), as bf16
              // parts h = bf16(v), l = bf16(v - h) into the warpgroup's A tile
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float nm[2], hv[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  float mp = mv[2 * h + e];
                  if (a.bias != 0) {
                    const float bs = __fmul_rn((float)a.bias, sv[2 * h + e]);
                    mp = kM == kNone ? bs : __fadd_rn(bs, mp);
                  }
                  nm[e] = -mp;
                  hv[e] = bf16_round(nm[e]);
                }
                const int off = swz128(w * 16 + g + 8 * r, 16 * kk + 8 * h + 2 * t);
                *reinterpret_cast<uint32_t*>(ah + off) = bf16_bits(hv[0], hv[1]);
                *reinterpret_cast<uint32_t*>(al + off) =
                    bf16_bits(__fsub_rn(nm[0], hv[0]), __fsub_rn(nm[1], hv[1]));
              }
            }
          }
        }
        if (min_live) {
          fence_proxy_async();
          named_bar_sync(1 + wg, 128);
          wgmma_fence();
          const uint64_t dh = wgmma_desc(ah), dl = wgmma_desc(al);
          const uint64_t xh = wgmma_desc(sm + L::kXh), xl = wgmma_desc(sm + L::kXl);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_ss(acc, dh + 2 * kk, xh + 2 * kk);
            wgmma_ss(acc, dh + 2 * kk, xl + 2 * kk);
            wgmma_ss(acc, dl + 2 * kk, xh + 2 * kk);
          }
          wgmma_commit();
        }
        aux_pend = true;
        for (int n = 0; n < sub; n += 2) {
          step(n, A0);
          step(n + 1, A1);
        }
      }
      wgmma_wait<0>();
      if ((tid & 127) == 0 && pend >= 0) mbar_arrive(empty + pend);
      pend = -1;

      // accumulator 4j + e: output row m0 + r0 (+8 for e >= 2), activation
      // row n0 + 8j + 2t + e%2
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int b = n0 + 8 * j + 2 * t + (e & 1), o = m0 + r0 + 8 * (e >> 1);
          if (b < a.B && o < a.out_f) a.y[(size_t)b * a.out_f + o] = acc[4 * j + e];
        }
      }
    }
  }
}

// A launch's tensor maps, built on the host for each call: x, the codes and
// each flat side (a side not flat: x's map, unused).
template <int kBits, int kS, int kM, int kN>
int tensor_maps(const ArgsLowTC& a, CUtensorMap (&tm)[4]) {
  int rc = tensor_map(&tm[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.x, a.in_f, a.B, kBK, kN,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = tensor_map(&tm[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.codes, a.in_f * kBits / 8,
                    a.out_f, kBK, kLtM, CU_TENSOR_MAP_SWIZZLE_64B);
  tm[2] = tm[3] = tm[0];
  if (rc == 0 && kS == kFlat)
    rc = tensor_map(&tm[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.d, a.nd, a.out_f, 32, kLtM,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0 && kM == kFlat)
    rc = tensor_map(&tm[3], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.dmin, a.ndm, a.out_f, 32, kLtM,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  return rc;
}

// kN activation rows a tile: 64 for at most 64 rows, else 128. The grid is
// the tiles, at most one block an SM of the current device.
template <int kBits, int kVar, int kMap, int kS, int kM, int kN>
int launch_lt(const ArgsLowTC& a, cudaStream_t st, int* plan) {
  using L = LtSmem<kN>;
  const auto kernel = quant_matmul_lowbit_tc_kernel<kBits, kVar, kMap, kS, kM, kN>;
  static CardCache cards;
  Card c;
  int rc = cards.get(kernel, 0, c);
  if (rc != 0) return rc;
  if (L::kBytes > c.smem_block) return (int)cudaErrorInvalidValue;
  const int tiles = ((a.out_f + kLtM - 1) / kLtM) * ((a.B + kN - 1) / kN);
  const int grid = tiles < c.sms ? tiles : c.sms;
  CUtensorMap tm[4];
  if (plan != nullptr) {
    // grid (x, y), threads, shared memory, registers, local bytes, blocks an
    // SM, kN, and the host's ns to build the tensor maps (the mean of 64
    // builds over a stand-in address)
    cudaFuncAttributes fa;
    rc = (int)cudaFuncGetAttributes(&fa, kernel);
    if (rc != 0) return rc;
    int per_sm = 0;
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kLtThreads,
                                                            L::kBytes);
    if (rc != 0) return rc;
    const uintptr_t stand_in = uintptr_t{1} << 20;
    ArgsLowTC s = a;
    s.x = reinterpret_cast<const __nv_bfloat16*>(stand_in);
    s.codes = reinterpret_cast<const uint8_t*>(stand_in);
    s.d = s.dmin = reinterpret_cast<const float*>(stand_in);
    const auto t0 = std::chrono::steady_clock::now();
    for (int i = 0; rc == 0 && i < 64; ++i) rc = tensor_maps<kBits, kS, kM, kN>(s, tm);
    if (rc != 0) return rc;
    const long ns = (long)std::chrono::duration_cast<std::chrono::nanoseconds>(
                        std::chrono::steady_clock::now() - t0).count() / 64;
    const int v[9] = {grid, 1, kLtThreads, L::kBytes, fa.numRegs, (int)fa.localSizeBytes, per_sm,
                      kN, (int)ns};
    for (int i = 0; i < 9; ++i) plan[i] = v[i];
    return 0;
  }
  rc = tensor_maps<kBits, kS, kM, kN>(a, tm);
  if (rc != 0) return rc;
  quant_matmul_lowbit_tc_kernel<kBits, kVar, kMap, kS, kM, kN><<<grid, kLtThreads, L::kBytes, st>>>(a, tm[0], tm[1], tm[2], tm[3]);
  return (int)cudaGetLastError();
}

template <int kBits, int kVar, int kMap, int kS, int kM>
int launch_low(const ArgsLowTC& a, cudaStream_t st, int* plan) {
  if (a.B <= 64) return launch_lt<kBits, kVar, kMap, kS, kM, 64>(a, st, plan);
  return launch_lt<kBits, kVar, kMap, kS, kM, 128>(a, st, plan);
}

// The min sides a scale side pairs with, as lgt_quant_matmul_lowbit takes
// them: none, or flat beside a flat scale, or hierarchical (compact beside
// a hierarchical scale; mixed beside a flat one, the fsplit and xsum rules
// only). Mapped codes come without a min.
template <int kBits, int kVar, int kMap, int kS>
int launch_low_m(const ArgsLowTC& a, int m_side, cudaStream_t st, int* plan) {
  if (m_side == kNone) return launch_low<kBits, kVar, kMap, kS, kNone>(a, st, plan);
  if constexpr (kMap == kIdentity) {
    if constexpr (kS == kFlat) {
      if (m_side == kFlat) return launch_low<kBits, kVar, kMap, kS, kFlat>(a, st, plan);
    }
    if constexpr (kS != kFlat || kMinTerm<kVar>) {
      if (m_side == kHierU8) return launch_low<kBits, kVar, kMap, kS, kHierU8>(a, st, plan);
      if (m_side == kHierI8) return launch_low<kBits, kVar, kMap, kS, kHierI8>(a, st, plan);
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <int kBits, int kVar, int kMap>
int launch_low_s(const ArgsLowTC& a, int s_side, int m_side, cudaStream_t st, int* plan) {
  if (s_side == kFlat) return launch_low_m<kBits, kVar, kMap, kFlat>(a, m_side, st, plan);
  if (s_side == kHierU8) return launch_low_m<kBits, kVar, kMap, kHierU8>(a, m_side, st, plan);
  if (s_side == kHierI8) return launch_low_m<kBits, kVar, kMap, kHierI8>(a, m_side, st, plan);
  return (int)cudaErrorInvalidValue;
}

// The rules and maps an instance takes, as lgt_quant_matmul_lowbit's
// launch_map: fsplit with any map at 4 bits, the identity at 2; xsum and
// split (one instance) and base, 4-bit identity codes only; base_f32 at 2
// bits, and at 4 bits for the IQ2/IQ3 maps only.
template <int kBits>
int launch_low_var(const ArgsLowTC& a, int var, int vmap, int s_side, int m_side,
                   cudaStream_t st, int* plan) {
  if (var == kFsplit && vmap == kIdentity)
    return launch_low_s<kBits, kFsplit, kIdentity>(a, s_side, m_side, st, plan);
  if constexpr (kBits == 2) {
    if (var == kBaseF32 && vmap == kIdentity)
      return launch_low_s<2, kBaseF32, kIdentity>(a, s_side, m_side, st, plan);
  } else {
    if ((var == kXsum || var == kSplit) && vmap == kIdentity)
      return launch_low_s<4, kXsum, kIdentity>(a, s_side, m_side, st, plan);
    if (var == kBase && vmap == kIdentity)
      return launch_low_s<4, kBase, kIdentity>(a, s_side, m_side, st, plan);
    if (var == kFsplit && vmap == kIq2)
      return launch_low_s<4, kFsplit, kIq2>(a, s_side, m_side, st, plan);
    if (var == kFsplit && vmap == kIq3)
      return launch_low_s<4, kFsplit, kIq3>(a, s_side, m_side, st, plan);
    if (var == kBaseF32 && vmap == kIq2)
      return launch_low_s<4, kBaseF32, kIq2>(a, s_side, m_side, st, plan);
    if (var == kBaseF32 && vmap == kIq3)
      return launch_low_s<4, kBaseF32, kIq3>(a, s_side, m_side, st, plan);
  }
  return (int)cudaErrorInvalidValue;
}

// The geometry this kernel takes: whole steps and chunks of 64 sub-blocks,
// plane groups that fit a chunk's sub steps, the scale side's 16-byte loads.
inline bool takes(int bits, int in_f, int nsub, int nd, int ndm) {
  const int planes = 8 / bits;
  return in_f % kBK == 0 && nsub > 0 && nsub % kBK == 0 && in_f % nsub == 0
         && (in_f / planes) % nsub == 0 && (in_f / nsub) % planes == 0 && nd > 0
         && nd % 4 == 0 && nsub % nd == 0 && ndm > 0 && nsub % ndm == 0;
}

int run(int bits, const void* x, const void* xsum, const void* codes, const void* d,
        const void* sc, const void* dmin, const void* mn, void* y, int B, int in_f, int out_f,
        int nsub, int nd, int ndm, int bias, int s_side, int m_side, int var, int vmap,
        void* stream, int* plan) {
  if (!takes(bits, in_f, nsub, nd, ndm)) return (int)cudaErrorInvalidValue;
  if (plan == nullptr && (B == 0 || out_f == 0)) return 0;
  const ArgsLowTC a{(const __nv_bfloat16*)x, (const float*)xsum, (const uint8_t*)codes,
                    (const float*)d, (const uint8_t*)sc, (const float*)dmin,
                    (const uint8_t*)mn, (float*)y, B, in_f, out_f, nsub, nd, ndm, bias};
  if (bits == 2) return launch_low_var<2>(a, var, vmap, s_side, m_side, (cudaStream_t)stream, plan);
  return launch_low_var<4>(a, var, vmap, s_side, m_side, (cudaStream_t)stream, plan);
}

}  // namespace

extern "C" {

// Arguments as lgt_quant_matmul_lowbit's: x (B, in) bf16 block-minor; xsum
// (B, nsub) f32 in the min side's order (fsplit, xsum; null for the base rules);
// codes (out, in*bits/8) u8 planar; d (out, nd) f32; sc (out, nsub) u8/i8 or
// null; dmin (out, ndm) f32 or null; mn (out, nsub) u8/i8 or null -> y (B,
// out) f32. s_side and m_side name each side's storage (Side), var the
// element rule (Var: fsplit, xsum, split, base, base_f32), vmap the code
// alphabet (Map,
// 4 bits only). Needs in % 64 == 0, nsub % 64 == 0, in/nsub a multiple of
// the planes, nd % 4 == 0; 16-byte aligned arrays.
int lgt_quant_matmul_4bit_tc(const void* x, const void* xsum, const void* codes,
                             const void* d, const void* sc, const void* dmin, const void* mn,
                             void* y, int B, int in_f, int out_f, int nsub, int nd, int ndm,
                             int bias, int s_side, int m_side, int var, int vmap, void* stream) {
  return run(4, x, xsum, codes, d, sc, dmin, mn, y, B, in_f, out_f, nsub, nd, ndm, bias, s_side,
             m_side, var, vmap, stream, nullptr);
}

// As lgt_quant_matmul_4bit_tc, with codes (out, in/4) planar quarters, the
// fsplit or base_f32 rule and no code map (vmap 0).
int lgt_quant_matmul_2bit_tc(const void* x, const void* xsum, const void* codes,
                             const void* d, const void* sc, const void* dmin, const void* mn,
                             void* y, int B, int in_f, int out_f, int nsub, int nd, int ndm,
                             int bias, int s_side, int m_side, int var, int vmap, void* stream) {
  return run(2, x, xsum, codes, d, sc, dmin, mn, y, B, in_f, out_f, nsub, nd, ndm, bias, s_side,
             m_side, var, vmap, stream, nullptr);
}

// The launch a call of B rows would make, into info[9]: grid (x, y),
// threads, dynamic shared memory, registers (at the kernel's entry, before
// setmaxnreg), local bytes, resident blocks an SM, activation rows a tile,
// and the host's ns to build its tensor maps.
int lgt_quant_matmul_lowbit_tc_plan(int B, int in_f, int out_f, int nsub, int s_side, int m_side,
                                    int bits, int var, int vmap, int* info) {
  const int nd = s_side == kFlat ? nsub : in_f / 256;
  const int ndm = m_side == kNone ? nd : (m_side == kFlat ? nsub : in_f / 256);
  return run(bits, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, B,
             in_f, out_f, nsub, nd, ndm, 0, s_side, m_side, var, vmap, nullptr, info);
}

}  // extern "C"
