// Fused dequantize + matmul over repacked quantized weights, for Hopper.
//
// Replaces every Pallas TPU matmul body of
// llama_gguf_inference_tpu/ops/pallas_matmul.py:
//
//   lgt_quant_matmul_lowbit, 2- and 4-bit codes, one template whose Var
//   parameter follows the element rule of one TPU body:
//     var fsplit, 2 bits  <- _make_kernel_qsplit (kern="qsplit"): planar
//                            quarters (Q2_K; the IQ1 trit codes share it)
//     var fsplit, 4 bits  <- _make_kernel_fsplit (kern="fsplit"): planar
//                            nibbles (Q4_K, Q4_0, Q4_1, Q3_K's 3-bit codes
//                            with bias 4; with the IQ2/IQ3 code->value map)
//     var xsum            <- _make_kernel_xsum (LGT_MM_VARIANT=xsum)
//     var split           <- _make_kernel_split (LGT_MM_VARIANT=split)
//     var base            <- _make_kernel's bf16-magic 4-bit branch
//                            (LGT_MM_VARIANT=base, or (in/sub) % 8 != 0)
//     var base_f32        <- _make_kernel's f32 branch for 2-bit codes and
//                            value-mapped 4-bit codes
//   lgt_quant_matmul_int8   <- _make_kernel_int8 (via _quant_matmul_2d_int8,
//                            LGT_MM_VARIANT=int8): Q8_1-style int8 activations
//                            (_quantize_acts, done by the caller) and exact
//                            int32 dots per sub-block with the 4-bit codes
//   lgt_quant_matmul_8bit   <- _make_kernel's 8-bit branch (via
//                            _quant_matmul_2d): int8 codes with compact
//                            hierarchical scales (Q6_K, IQ4_XS: f32 d per 256,
//                            i8 sc per sub-block; Q5_K: u8 sc and mn) or flat
//                            ones (Q8_0, Q5_0, Q5_1, Q8_1, Q8_K, IQ4_NL), with
//                            the min term of the asymmetric ones (Q5_K, Q5_1)
//
// All read the arrays the JAX kernels read, in the same block-minor element
// order (quant/repack.py block_minor_perm): stored position j of a row holds
// sub-block (j mod nsub), so a 16-byte code load meets a contiguous run of
// per-sub-block scales, and the activations arrive pre-permuted by the caller.
//
// 2- and 4-bit (P = 4 or 2 code planes, q = in/P stored codes per plane,
// v_i(c) = (c >> (8/P)*i) & (2^(8/P) - 1), mapped by code_value for IQ2/IQ3):
//   fsplit  y = sum_i sum_j x[i*q + j] * bf16(v_i * s[k]) - sum_k xsum[k] * m'[k]
//   xsum    as fsplit with bf16(v_i * bf16(s[k])), one sum over both planes
//   split   as xsum, the two planes summed apart and added at the end
//   base    w = bf16(bf16(v_i * bf16(s[k])) - bf16(m'[k])), no xsum term
//           (XLA on the CPU rounds after the multiply and again after the
//           subtract, like the TPU's bf16 arithmetic; checked by the tests)
//   base_f32  w = bf16((v_i - bias) * s[k] - m[k]) in f32, no xsum term
// with k = j mod nsub, the scale and min sides each read in one of the
// repack's layouts (_hier_scales in the JAX package), the side being a
// template parameter:
//   flat    s[k] = d[k]                           (d per sub-block)
//   hier    s[k] = d[k mod nd] * sc[k]            (d per super-block, sc u8/i8)
//   m'[k] = bias*s[k] + m[k], m[k] the min side read the same way (none,
//   flat, or hier with dmin per min super-block: nd for compact, in/min_size
//   for mixed, where the caller permuted xsum into the mn order and bias is 0;
//   the base variants take no mixed layout, as in the JAX dispatcher).
// int8:   p[k] = sum_t xq[t*nsub + k] * c[t*nsub + k] (exact int32, c the
//         unbiased 4-bit code), y = sum_k (p[k] * xs[k]) * s[k] - sum_k xsum[k] * m'[k]
// 8-bit:  y[b,o] = sum_j x[b,j] * bf16((c[o,j] - bias) * s_full[j] - m_full[j])
//         s_sub[k] = d[o, k mod nd] * sc[o,k] (k < nsub), s_full[j] = s_sub[j mod nsub]
//         (tiles, not repeat-interleave: that is what pltpu.repeat does), the
//         min side alike; the subtract follows the product in f32.
// Products are rounded to bf16 where the TPU kernel rounds them, sums run in
// f32, and the scale arithmetic uses __fmul_rn/__fadd_rn/__fsub_rn so nvcc
// cannot fuse it into an FMA the reference does not do.
//
// What bounds them on the card: at decode (a handful of activation rows)
// they stream their weight bytes once, so device-memory bandwidth bounds
// them. Bytes per weight: Q2_K 0.75 flat (6.0 bits), 0.578 mixed (4.625),
// 0.406 compact (3.25); Q4_K 0.75 flat, 0.672 mixed, 0.594 compact; Q3_K
// 0.75 flat, 0.578 compact; Q6_K about 1.08 compact; Q5_K 1.09 compact,
// 1.25 flat. At prefill (512 rows) they are bound by operations.
// Design of the 2/4-bit and int8 kernels: one warp per output row, lanes
// walking the row in 16-byte code loads (coalesced, 512 bytes per warp
// step, the next step's load in flight during this one's arithmetic; 64
// weights a lane at 2 bits, 32 at 4), the 2-bit lane's 16 sub-block scales
// formed once in registers and shared by the byte's four planes, the
// dequantized run applied to up to 8 activation rows at once; a second grid
// axis tiles further activation rows, so any row count works (prefill
// re-reads the weights from L2 once per 8 rows: right, not fast). The 8-bit
// kernel here serves fewer than TC_MIN_ROWS rows (ops/quant_matmul.py), the
// fsplit, base and base_f32 rules of the 2/4-bit kernel fewer than
// LOWBIT_TC_MIN_ROWS, the int8 kernel fewer than INT8_TC_MIN_ROWS; from
// there up the wrappers take the tensor-core kernels of quant_matmul_tc.cu,
// quant_matmul_lowbit_tc.cu and quant_matmul_int8_tc.cu, which decode each
// weight once per 128 rows. The int8 kernel here gives each lane four
// neighbouring sub-blocks and walks their elements (stride nsub), so a warp
// reads 128 neighbouring code bytes per step and keeps 4 exact int32 sums
// per activation row. The element rules live in lowbit_rule.cuh, shared
// with the tensor-core 2/4-bit kernel. Tensor cores for the xsum and split
// rules, TMA and split-K are later work.
//
// Design of the 8-bit decode kernel (quant_matmul_8bit_kernel), where the
// bytes a weight and the instructions a weight both sit near the card's
// limits (about 1.1 bytes and 4.5 instructions a weight at B = 4):
// - A block owns 8 output rows and 8 activation rows. Its warps split the
//   row into cells of 64 stored positions; cells q and q + C meet the same
//   sub-blocks (64*C = lcm(64, nsub)), so a warp that walks one chunk (the
//   cells c, c + C, ...) finds the same 16 sub-blocks in every cell.
// - Scales once a chunk: each lane forms the 16 scales (and mins) of its
//   row and positions once, in registers, with 16-byte loads where nsub %
//   16 == 0 and nd % 4 == 0 (every 8B weight: nsub 128, 256, 448, 896) and
//   one at a time otherwise; the 8-bit factors are read as exact floats by
//   byte_perm and a subtract, no int-to-float conversion. The element loop
//   reads no d, sc, dmin or mn and steps no sub-block index. ffn_down (nsub
//   448, C = 7) takes the same path as the rest.
// - Activations shared across rows: mma.sync.m16n8k16 with the activation
//   rows as A (rows 8-15 zero) and the 8 output rows as B, so one 32-byte x
//   fragment a lane feeds 8 output rows: 2*B/8 bytes of x (L1 and L2) a code
//   byte, 1.0 at B = 4.
// - Bytes in flight: each warp keeps a ring of 8 cells (4 KB) of codes in
//   flight through cp.async (L1 bypassed), 4 with a min side, requested before
//   the item's scales are formed; 95 registers with a min side, 71 without,
//   no spills, 14-28 warps an SM.
// - Lean element: byte_perm puts c + 128 into 2^23's mantissa, one subtract
//   of 2^23 + 128 + bias gives c - bias exactly, then __fmul_rn, __fsub_rn
//   with a min, and one cvt.rn.bf16x2 for two weights.
// - Filling the card: a chunk's run of cells is split across warps of the
//   block only as far as needed for two warps a resident slot (plan8); the
//   block merges its warps' partial sums in shared memory and writes y, so
//   nothing outlives a launch.
// Measured (PERF.md §6, tools/tc_ablate.py --kinds q5_k_decode,q6_k_decode):
// at Q5_K gate+up, B = 4, removing the activation loads, the decode or the
// products each takes 15-25% off the time; none alone bounds it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <numeric>

#include "lowbit_rule.cuh"
#include "tc_common.cuh"

namespace {

constexpr int kWarps = 4;   // output rows per block, one warp each
constexpr int kRows = 8;    // activation rows per block

// 16 consecutive bf16 at a 16-byte aligned address -> f32.
__device__ __forceinline__ void load_bf16x16(const __nv_bfloat16* p, float* out) {
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
  const uint4 a = p4[0], b = p4[1];
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct LowbitArgs {
  const __nv_bfloat16* x;  // (B, in) block-minor
  const float* xsum;       // (B, nsub), in the min side's sub-block order; null for base
  const uint8_t* codes;    // (out, in * kBits / 8)
  const float* d;          // (out, nd)
  const uint8_t* sc;       // (out, nsub) or null
  const float* dmin;       // (out, ndm) or null
  const uint8_t* mn;       // (out, nsub) or null
  float* y;                // (B, out)
  int B, in_f, out_f, nsub, nd, ndm, bias;
};

// Steps the sub-block index k of consecutive stored positions, and kd = k
// mod nd when a hierarchical side needs it.
template <bool kTrackKd>
__device__ __forceinline__ void next_sub(int& k, int& kd, int nsub, int nd) {
  if (++k == nsub) {
    k = 0;
    kd = 0;
  } else if (kTrackKd && ++kd == nd) {
    kd = 0;
  }
}

// Registers bound the occupancy of these latency-bound loops: the 2-bit
// instances keep 16 scales live across their four planes and are held to
// four blocks an SM, the 4-bit ones (no scale array) to six, as the flat
// Q4_K kernel ran before the layouts were added.
template <int kBits, int kVar, int kMap, int kS, int kM>
__global__ void __launch_bounds__(kWarps * 32, kBits == 2 ? 4 : 6)
quant_matmul_lowbit_kernel(const LowbitArgs a) {
  constexpr int kPlanes = 8 / kBits;
  constexpr int kMask = (1 << kBits) - 1;
  constexpr bool kBaseVar = kVar == kBase || kVar == kBaseF32;
  // the base variants read the min side at kd too (they take no mixed layout)
  constexpr bool kTrackKd = kS != kFlat || (kBaseVar && (kM == kHierU8 || kM == kHierI8));
  constexpr int kAcc = kVar == kSplit ? 2 : 1;  // split sums the planes apart
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int b0 = blockIdx.y * kRows;
  if (o >= a.out_f) return;  // warp-uniform; the kernel has no block barrier
  const int nb = min(kRows, a.B - b0);
  const int qn = a.in_f / kPlanes;  // codes per plane = stored bytes per row
  const uint8_t* crow = a.codes + (size_t)o * qn;
  const float* drow = a.d + (size_t)o * a.nd;
  const uint8_t* scrow = kS == kFlat ? nullptr : a.sc + (size_t)o * a.nsub;
  const float* dminrow = kM == kNone ? nullptr : a.dmin + (size_t)o * a.ndm;
  const uint8_t* mnrow = (kM == kHierU8 || kM == kHierI8) ? a.mn + (size_t)o * a.nsub
                                                          : nullptr;

  float acc[kAcc][kRows];
#pragma unroll
  for (int h = 0; h < kAcc; ++h)
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[h][r] = 0.f;

  // the next 16 code bytes are loaded while the current ones are applied
  int j0 = lane * 16;
  uint4 c_next = j0 < qn ? __ldg(reinterpret_cast<const uint4*>(crow + j0)) : uint4{};
  for (; j0 < qn; j0 += 32 * 16) {
    const uint4 c4 = c_next;
    if (j0 + 32 * 16 < qn) c_next = __ldg(reinterpret_cast<const uint4*>(crow + j0 + 32 * 16));
    const uint8_t* c = reinterpret_cast<const uint8_t*>(&c4);
    // stored byte j belongs to sub-block k = j mod nsub in every plane,
    // because q is a multiple of nsub
    int k = j0 % a.nsub;
    int kd = kTrackKd ? k % a.nd : 0;
    if constexpr (kBits == 4) {
      // two nibble planes, each product summed in the order of the flat
      // Q4_K kernel
      float wlo[16], whi[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        float s, m = 0.f;
        sub_factors<kVar, kS, kM>(drow, scrow, dminrow, mnrow, a.bias, k, kd, s, m);
        wlo[e] = element<kVar, kM, kMap>(c[e] & 0xF, s, m, a.bias);
        whi[e] = element<kVar, kM, kMap>(c[e] >> 4, s, m, a.bias);
        next_sub<kTrackKd>(k, kd, a.nsub, a.nd);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < nb) {
          const __nv_bfloat16* xr = a.x + (size_t)(b0 + r) * a.in_f;
          float xl[16], xh[16];
          load_bf16x16(xr + j0, xl);
          load_bf16x16(xr + qn + j0, xh);
          if constexpr (kVar == kSplit) {
            float tl = acc[0][r], th = acc[kAcc - 1][r];
#pragma unroll
            for (int e = 0; e < 16; ++e) {
              tl = fmaf(xl[e], wlo[e], tl);
              th = fmaf(xh[e], whi[e], th);
            }
            acc[0][r] = tl;
            acc[kAcc - 1][r] = th;
          } else {
            float t = acc[0][r];
#pragma unroll
            for (int e = 0; e < 16; ++e) {
              t = fmaf(xl[e], wlo[e], t);
              t = fmaf(xh[e], whi[e], t);
            }
            acc[0][r] = t;
          }
        }
      }
    } else {
      // the 16 scales (and mins), formed once and shared by the four planes
      float s[16], m[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        m[e] = 0.f;
        sub_factors<kVar, kS, kM>(drow, scrow, dminrow, mnrow, a.bias, k, kd, s[e], m[e]);
        next_sub<kTrackKd>(k, kd, a.nsub, a.nd);
      }
#pragma unroll
      for (int i = 0; i < kPlanes; ++i) {
        float w[16];
#pragma unroll
        for (int e = 0; e < 16; ++e)
          w[e] = element<kVar, kM, kMap>((c[e] >> (kBits * i)) & kMask, s[e], m[e], a.bias);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < nb) {
            float xv[16];
            load_bf16x16(a.x + (size_t)(b0 + r) * a.in_f + i * qn + j0, xv);
            float t = acc[0][r];
#pragma unroll
            for (int e = 0; e < 16; ++e) t = fmaf(xv[e], w[e], t);
            acc[0][r] = t;
          }
        }
      }
    }
  }

  // min term: m'[k] formed once per sub-block, applied to every row (the
  // base variants folded theirs into the weights)
  float macc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) macc[r] = 0.f;
  if (!kBaseVar && (kM != kNone || a.bias != 0)) {
    for (int k = lane; k < a.nsub; k += 32) {
      float mp = 0.f;
      if constexpr (kM != kNone) mp = side_at<kM>(dminrow, mnrow, k, kM == kFlat ? k : k % a.ndm);
      if (a.bias != 0) {
        const float bs = __fmul_rn((float)a.bias, side_at<kS>(drow, scrow, k, kS == kFlat ? k : k % a.nd));
        mp = kM == kNone ? bs : __fadd_rn(bs, mp);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nb) macc[r] = fmaf(a.xsum[(size_t)(b0 + r) * a.nsub + k], mp, macc[r]);
    }
  }
  for (int r = 0; r < nb; ++r) {
    float dot = warp_sum(acc[0][r]);
    if constexpr (kAcc == 2) dot = dot + warp_sum(acc[kAcc - 1][r]);
    const float mdot = kBaseVar ? 0.f : warp_sum(macc[r]);
    if (lane == 0) a.y[(size_t)(b0 + r) * a.out_f + o] = dot - mdot;
  }
}

template <int kBits, int kVar, int kMap, int kS, int kM>
int launch_one(const LowbitArgs& a, cudaStream_t st) {
  const dim3 grid((a.out_f + kWarps - 1) / kWarps, (a.B + kRows - 1) / kRows);
  quant_matmul_lowbit_kernel<kBits, kVar, kMap, kS, kM><<<grid, kWarps * 32, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// The min sides a scale side pairs with: none or flat beside a flat scale,
// none or hierarchical beside a hierarchical one, and the mixed layout (flat
// scale, hierarchical min) for the variants with an xsum term. Value-mapped
// codes come without a min.
template <int kBits, int kVar, int kMap, int kS>
int launch_m(const LowbitArgs& a, int m_side, cudaStream_t st) {
  constexpr bool kBaseVar = kVar == kBase || kVar == kBaseF32;
  if (m_side == kNone) return launch_one<kBits, kVar, kMap, kS, kNone>(a, st);
  if constexpr (kMap == kIdentity) {
    if constexpr (kS == kFlat) {
      if (m_side == kFlat) return launch_one<kBits, kVar, kMap, kS, kFlat>(a, st);
    }
    if constexpr (kS != kFlat || !kBaseVar) {
      if (m_side == kHierU8) return launch_one<kBits, kVar, kMap, kS, kHierU8>(a, st);
      if (m_side == kHierI8) return launch_one<kBits, kVar, kMap, kS, kHierI8>(a, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <int kBits, int kVar, int kMap>
int launch_s(const LowbitArgs& a, int s_side, int m_side, cudaStream_t st) {
  if (s_side == kFlat) return launch_m<kBits, kVar, kMap, kFlat>(a, m_side, st);
  if (s_side == kHierU8) return launch_m<kBits, kVar, kMap, kHierU8>(a, m_side, st);
  if (s_side == kHierI8) return launch_m<kBits, kVar, kMap, kHierI8>(a, m_side, st);
  return (int)cudaErrorInvalidValue;
}

// Which maps an instance takes: the fsplit rule and the 4-bit f32 base rule
// take the IQ2/IQ3 alphabets, the 4-bit f32 base rule nothing else (plain
// 4-bit codes take the bf16-magic base rule).
template <int kBits, int kVar>
int launch_map(const LowbitArgs& a, int vmap, int s_side, int m_side, cudaStream_t st) {
  constexpr bool kMapped = kBits == 4 && (kVar == kFsplit || kVar == kBaseF32);
  if constexpr (!(kBits == 4 && kVar == kBaseF32)) {
    if (vmap == kIdentity) return launch_s<kBits, kVar, kIdentity>(a, s_side, m_side, st);
  }
  if constexpr (kMapped) {
    if (vmap == kIq2) return launch_s<kBits, kVar, kIq2>(a, s_side, m_side, st);
    if (vmap == kIq3) return launch_s<kBits, kVar, kIq3>(a, s_side, m_side, st);
  }
  return (int)cudaErrorInvalidValue;
}

struct Int8Args {
  const int8_t* xq;        // (B, in) block-minor, Q8_1-style codes
  const float* xs;         // (B, nsub) activation scales
  const float* xsum;       // (B, nsub) exact block sums
  const uint8_t* codes;    // (out, in / 2) planar nibbles
  const float* d;          // (out, nd)
  const uint8_t* sc;       // (out, nsub) or null
  const float* dmin;       // (out, nd) or null
  const uint8_t* mn;       // (out, nsub) or null
  float* y;                // (B, out)
  int B, in_f, out_f, nsub, nd, bias;
};

// Byte q of a 32-bit word as a signed value.
__device__ __forceinline__ int sbyte(uint32_t w, int q) {
  return (int)(int8_t)(uint8_t)(w >> (8 * q));
}

template <int kS, int kM>
__global__ void __launch_bounds__(kWarps * 32, 6)
quant_matmul_int8_kernel(const Int8Args a) {
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int b0 = blockIdx.y * kRows;
  if (o >= a.out_f) return;  // warp-uniform; the kernel has no block barrier
  const int nb = min(kRows, a.B - b0);
  const int half = a.in_f / 2;      // stored bytes per row
  const int hsub = half / a.nsub;   // elements of a sub-block in one plane
  const uint8_t* crow = a.codes + (size_t)o * half;
  const float* drow = a.d + (size_t)o * a.nd;
  const uint8_t* scrow = kS == kFlat ? nullptr : a.sc + (size_t)o * a.nsub;

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  // a lane owns sub-blocks k0..k0+3: byte t*nsub + k holds element (t, k) in
  // its low nibble and (t + hsub, k) in its high one
  for (int k0 = lane * 4; k0 < a.nsub; k0 += 32 * 4) {
    int p[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) p[r][q] = 0;
    for (int t = 0; t < hsub; ++t) {
      const uint32_t c = __ldg(reinterpret_cast<const uint32_t*>(crow + (size_t)t * a.nsub + k0));
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < nb) {
          const int8_t* xr = a.xq + (size_t)(b0 + r) * a.in_f;
          const uint32_t xl = __ldg(reinterpret_cast<const uint32_t*>(xr + (size_t)t * a.nsub + k0));
          const uint32_t xh = __ldg(reinterpret_cast<const uint32_t*>(
              xr + (size_t)(t + hsub) * a.nsub + k0));
#pragma unroll
          for (int q = 0; q < 4; ++q)
            p[r][q] += sbyte(xl, q) * (int)((c >> (8 * q)) & 0xF)
                       + sbyte(xh, q) * (int)((c >> (8 * q + 4)) & 0xF);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + q;
      const float s = side_at<kS>(drow, scrow, k, k % a.nd);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nb)
          acc[r] = __fadd_rn(acc[r], __fmul_rn(__fmul_rn((float)p[r][q],
                                                         a.xs[(size_t)(b0 + r) * a.nsub + k]), s));
    }
  }

  // min term as in the 2/4-bit kernel: m'[k] = bias*s[k] + m[k]
  float macc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) macc[r] = 0.f;
  if (kM != kNone || a.bias != 0) {
    const float* dminrow = kM == kNone ? nullptr : a.dmin + (size_t)o * a.nd;
    const uint8_t* mnrow = (kM == kHierU8 || kM == kHierI8) ? a.mn + (size_t)o * a.nsub
                                                            : nullptr;
    for (int k = lane; k < a.nsub; k += 32) {
      float mp = 0.f;
      if constexpr (kM != kNone) mp = side_at<kM>(dminrow, mnrow, k, kM == kFlat ? k : k % a.nd);
      if (a.bias != 0) {
        const float bs = __fmul_rn((float)a.bias, side_at<kS>(drow, scrow, k, kS == kFlat ? k : k % a.nd));
        mp = kM == kNone ? bs : __fadd_rn(bs, mp);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nb) macc[r] = fmaf(a.xsum[(size_t)(b0 + r) * a.nsub + k], mp, macc[r]);
    }
  }
  for (int r = 0; r < nb; ++r) {
    const float dot = warp_sum(acc[r]);
    const float mdot = warp_sum(macc[r]);
    if (lane == 0) a.y[(size_t)(b0 + r) * a.out_f + o] = dot - mdot;
  }
}

template <int kS, int kM>
int launch_int8(const Int8Args& a, cudaStream_t st) {
  const dim3 grid((a.out_f + kWarps - 1) / kWarps, (a.B + kRows - 1) / kRows);
  quant_matmul_int8_kernel<kS, kM><<<grid, kWarps * 32, 0, st>>>(a);
  return (int)cudaGetLastError();
}

struct Args8 {
  const __nv_bfloat16* x;  // (B, in) block-minor
  const int8_t* codes;     // (out, in)
  const float* d;          // (out, nd)
  const uint8_t* sc;       // (out, nsub) or null
  const float* dmin;       // (out, nd) or null
  const uint8_t* mn;       // (out, nsub) or null
  float* y;                // (B, out)
  int B, in_f, out_f, nd, nsub, bias;
};

constexpr int k8Rows = 8;       // output rows a block: mma's n
constexpr int k8Acts = 8;       // activation rows a block (of mma's m = 16)
constexpr int k8Cell = 64;      // stored positions of a row a warp takes a step
constexpr int k8MaxWarps = 16;
// cp.async ring of code cells a warp (512 bytes a cell), which then holds
// the warp's partial sums: 8 cells without a min side, 4 with one (those
// instances keep 95 registers, so 20 warps an SM, and a deeper ring costs
// the activations' L1 more than it gains in flight: PERF.md §6)
template <int kM>
constexpr int k8Ring = kM == kNone ? 8 : 4;
template <int kM>
constexpr int k8WarpSmem = k8Ring<kM> * 32 * 16;

// How a block of 8 output rows splits its row. Cell q holds stored positions
// 64q..64q+63; cells q and q + C meet the same sub-blocks (64*C is the least
// multiple of 64 and of nsub), so chunk c is the cells c, c + C, c + 2C, ...
// A warp's item is one chunk and a run of up to `steps` of its cells; the
// block's warps take the items in turn, one each where items <= 16.
struct Plan8 {
  int cells, C, chunks, steps, items, warps;
};

// Items as long as the card allows: a chunk's run is split only until the
// grid holds two warps for each of the 16 an SM keeps resident (o and qkv
// split in 5 and 3, gate+up and the head not at all), at most 16 warps a
// block; more items than that are dealt evenly, two or more a warp.
inline Plan8 plan8(int B, int in_f, int out_f, int nsub, int sms) {
  Plan8 p;
  p.cells = (in_f + k8Cell - 1) / k8Cell;
  p.C = nsub / std::gcd(nsub, k8Cell);
  p.chunks = p.C < p.cells ? p.C : p.cells;
  const int run = (p.cells + p.C - 1) / p.C;   // cells of chunk 0
  const long blocks = (long)((out_f + k8Rows - 1) / k8Rows) * ((B + k8Acts - 1) / k8Acts);
  const long want = (32L * sms + blocks - 1) / blocks;   // items a block
  long split = (want + p.chunks - 1) / p.chunks;
  if (split > k8MaxWarps / p.chunks) split = k8MaxWarps / p.chunks;
  if (split > run) split = run;
  if (split < 1) split = 1;
  p.steps = (run + (int)split - 1) / (int)split;
  p.items = p.chunks * (int)split;
  const int per = (p.items + k8MaxWarps - 1) / k8MaxWarps;   // items a warp
  p.warps = (p.items + per - 1) / per;
  return p;
}

// Byte q of u, minus magic, as an exact f32: 0x4B0000zz is 2^23 + zz. With
// magic 2^23 an unsigned byte; with 2^23 + 128 (+ bias) a signed one whose
// sign bit was flipped first (minus the bias).
__device__ __forceinline__ float byte_f32(uint32_t u, int q, float magic) {
  return __fsub_rn(__int_as_float((int)__byte_perm(u, 0x4B000000u, 0x7440u | q)), magic);
}

// One side's values at this lane's 16 sub-blocks k0, k0+1, ... (mod nsub),
// as side_at forms them: 16-byte loads where nsub % 16 == 0 and nd % 4 == 0
// (a run then neither wraps nsub nor splits a 4-aligned run of nd), else
// one element at a time.
template <int kSide>
__device__ __forceinline__ void lane_side(const float* base, const uint8_t* sub, int k0, int nsub,
                                          int nd, bool vec, float (&v)[16]) {
  if (vec) {
    float4 f[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      f[q] = __ldg(reinterpret_cast<const float4*>(base + (kSide == kFlat ? k0 + 4 * q
                                                                          : (k0 + 4 * q) % nd)));
    const float* fv = reinterpret_cast<const float*>(f);
    if constexpr (kSide == kFlat) {
#pragma unroll
      for (int e = 0; e < 16; ++e) v[e] = fv[e];
    } else {
      constexpr uint32_t kFlip = kSide == kHierI8 ? 0x80808080u : 0u;
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(sub + k0));
      const uint32_t bw[4] = {b.x ^ kFlip, b.y ^ kFlip, b.z ^ kFlip, b.w ^ kFlip};
#pragma unroll
      for (int e = 0; e < 16; ++e)
        v[e] = __fmul_rn(fv[e], byte_f32(bw[e / 4], e % 4, kFlip ? 8388736.f : 8388608.f));
    }
    return;
  }
  int k = k0, kd = k0 % nd;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    v[e] = side_at<kSide>(base, sub, k, kd);
    if (++k == nsub) {
      k = 0;
      kd = 0;
    } else if (++kd == nd) {
      kd = 0;
    }
  }
}

// 16 codes to 8 words of bf16 pairs: bf16((c - bias) * s - m), the lower
// position in the lower half; magic is 2^23 + 128 + bias.
template <int kM>
__device__ __forceinline__ void decode16(const uint4& c4, const float (&s)[16],
                                         const float (&m)[16], float magic, uint32_t (&w)[8]) {
  const uint32_t u[4] = {c4.x ^ 0x80808080u, c4.y ^ 0x80808080u, c4.z ^ 0x80808080u,
                         c4.w ^ 0x80808080u};
#pragma unroll
  for (int e = 0; e < 16; e += 2) {
    float v0 = __fmul_rn(byte_f32(u[e / 4], e % 4, magic), s[e]);
    float v1 = __fmul_rn(byte_f32(u[e / 4], e % 4 + 1, magic), s[e + 1]);
    if constexpr (kM != kNone) {
      v0 = __fsub_rn(v0, m[e]);
      v1 = __fsub_rn(v1, m[e + 1]);
    }
    const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
    w[e / 2] = *reinterpret_cast<const uint32_t*>(&p);
  }
}

// Block (blockIdx.x, blockIdx.y): output rows 8*bx..+7, activation rows
// 8*by..+7. Lane (g, t) = (lane / 4, lane % 4) of a warp decodes output row
// g at positions 16t..16t+15 of each of its cells and brings activation row
// g at the same positions; mma.m16n8k16 q (q < 4) of a cell takes the
// lane's positions 4q..4q+3 as its k slots 2t, 2t+1, 2t+8, 2t+9, with the
// activations as A (rows 8-15 zero) and the weights as B (n = output row).
template <int kS, int kM>
__global__ void __launch_bounds__(k8MaxWarps * 32, 1)
quant_matmul_8bit_kernel(const Args8 a, const Plan8 p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = p.warps;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * k8Rows, b0 = blockIdx.y * k8Acts;
  const int nb = min(k8Acts, a.B - b0);
  // a row past out repeats the last row's loads; its sums are not stored
  const size_t o = (size_t)min(r0 + g, a.out_f - 1);
  const int8_t* crow = a.codes + o * a.in_f;
  const float* drow = a.d + o * a.nd;
  const uint8_t* scrow = kS == kFlat ? nullptr : a.sc + o * a.nsub;
  const float* dminrow = kM == kNone ? nullptr : a.dmin + o * a.nd;
  const uint8_t* mnrow = kM == kHierU8 ? a.mn + o * a.nsub : nullptr;
  const bool x_live = g < nb;
  const __nv_bfloat16* xrow = a.x + (size_t)(b0 + (x_live ? g : 0)) * a.in_f;
  const bool vec = a.nsub % 16 == 0 && a.nd % 4 == 0;
  const float magic = __fadd_rn(8388736.f, (float)a.bias);
  constexpr int kRing = k8Ring<kM>;
  unsigned char* const ring = smem + warp * k8WarpSmem<kM> + lane * 16;

  float acc[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[h][e] = 0.f;

  for (int item = warp; item < p.items; item += nwarps) {
    const int c = item % p.chunks, m0 = (item / p.chunks) * p.steps;
    const int n = min(p.steps, (p.cells - c + p.C - 1) / p.C - m0);   // cells of the item
    if (n <= 0) continue;
    // this lane's position in cell i of the item; past in only in a ragged
    // last cell, loaded as zeros
    auto pos = [&](int i) { return ((m0 + i) * p.C + c) * k8Cell + 16 * t; };
    auto load_codes = [&](int i) {
      const int j = pos(i);
      cp_async16(ring + (i % kRing) * 512, crow + (j < a.in_f ? j : 0), j < a.in_f);
    };
    auto load_x = [&](int i, uint4 (&xv)[2]) {
      const int j = pos(i);
      if (x_live && j < a.in_f) {
        xv[0] = __ldg(reinterpret_cast<const uint4*>(xrow + j));
        xv[1] = __ldg(reinterpret_cast<const uint4*>(xrow + j) + 1);
      } else {
        xv[0] = xv[1] = uint4{0, 0, 0, 0};
      }
    };
    // the item's first cells are in flight while its scales are formed
#pragma unroll
    for (int i = 0; i < kRing; ++i) {
      if (i < n) load_codes(i);
      cp_async_commit();
    }
    float s[16], m[16];
    const int k0 = (c * k8Cell + 16 * t) % a.nsub;
    lane_side<kS>(drow, scrow, k0, a.nsub, a.nd, vec, s);
    if constexpr (kM != kNone) lane_side<kM>(dminrow, mnrow, k0, a.nsub, a.nd, vec, m);
    uint4 xn[2];
    load_x(0, xn);
    for (int i = 0; i < n; ++i) {
      // the slot of cell i-1, read and used, takes cell i-1+kRing: group j
      // of the item holds cell j
      if (i > 0) {
        if (i - 1 + kRing < n) load_codes(i - 1 + kRing);
        cp_async_commit();
      }
      const uint4 xv[2] = {xn[0], xn[1]};
      if (i + 1 < n) load_x(i + 1, xn);
      cp_async_wait<kRing - 1>();
      __syncwarp();
      const uint4 c4 = *reinterpret_cast<const uint4*>(ring + (i % kRing) * 512);
      uint32_t w[8];
      decode16<kM>(c4, s, m, magic, w);
      const uint32_t xw[8] = {xv[0].x, xv[0].y, xv[0].z, xv[0].w,
                              xv[1].x, xv[1].y, xv[1].z, xv[1].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t af[4] = {xw[2 * q], 0u, xw[2 * q + 1], 0u};
        mma_bf16(acc[q & 1], af, w[2 * q], w[2 * q + 1]);
      }
    }
  }

  // partial sums through the warp's own ring (its copies have all landed):
  // accumulator e < 2 is activation row g, output row 2t + e
  cp_async_wait<0>();
  __syncwarp();
  float* part = reinterpret_cast<float*>(smem + warp * k8WarpSmem<kM>);
  part[g * 8 + 2 * t] = acc[0][0] + acc[1][0];
  part[g * 8 + 2 * t + 1] = acc[0][1] + acc[1][1];
  __syncthreads();
  for (int idx = threadIdx.x; idx < k8Acts * k8Rows; idx += nwarps * 32) {
    const int b = idx >> 3, r = idx & 7;
    float sum = 0.f;
    for (int v = 0; v < nwarps; ++v)
      sum += reinterpret_cast<const float*>(smem + v * k8WarpSmem<kM>)[idx];
    if (b < nb && r0 + r < a.out_f) a.y[(size_t)(b0 + b) * a.out_f + r0 + r] = sum;
  }
}

// The plan of a launch, the shared-memory limit of the instance set on its
// first use and the card's SM count read once.
template <int kS, int kM>
int prepare_8bit(int B, int in_f, int out_f, int nsub, Plan8& p) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    int rc = (int)cudaGetDevice(&dev);
    if (rc == 0) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == 0)
      rc = (int)cudaFuncSetAttribute(quant_matmul_8bit_kernel<kS, kM>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     k8MaxWarps * k8WarpSmem<kM>);
    if (rc != 0) {
      sms = 0;
      return rc;
    }
  }
  p = plan8(B, in_f, out_f, nsub, sms);
  return 0;
}

template <int kS, int kM>
int launch_8bit(const Args8& a, cudaStream_t st) {
  Plan8 p;
  const int rc = prepare_8bit<kS, kM>(a.B, a.in_f, a.out_f, a.nsub, p);
  if (rc != 0) return rc;
  const dim3 grid((a.out_f + k8Rows - 1) / k8Rows, (a.B + k8Acts - 1) / k8Acts);
  const int smem = p.warps * k8WarpSmem<kM>;
  quant_matmul_8bit_kernel<kS, kM><<<grid, p.warps * 32, smem, st>>>(a, p);
  return (int)cudaGetLastError();
}

// What a launch of one instance would be: grid x and y, threads, shared
// bytes, registers a thread, local bytes a thread (spills), blocks an SM.
template <int kS, int kM>
int plan_8bit(int B, int in_f, int out_f, int nsub, int* info) {
  Plan8 p;
  int rc = prepare_8bit<kS, kM>(B, in_f, out_f, nsub, p);
  cudaFuncAttributes fa;
  if (rc == 0) rc = (int)cudaFuncGetAttributes(&fa, quant_matmul_8bit_kernel<kS, kM>);
  int per_sm = 0;
  if (rc == 0)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, quant_matmul_8bit_kernel<kS, kM>, p.warps * 32, p.warps * k8WarpSmem<kM>);
  if (rc != 0) return rc;
  const int v[7] = {(out_f + k8Rows - 1) / k8Rows, (B + k8Acts - 1) / k8Acts, p.warps * 32,
                    p.warps * k8WarpSmem<kM>, fa.numRegs, (int)fa.localSizeBytes, per_sm};
  for (int i = 0; i < 7; ++i) info[i] = v[i];
  return 0;
}

}  // namespace

extern "C" {

// x (B, in) bf16 block-minor; xsum (B, nsub) f32 (null for the base
// variants); codes (out, in*bits/8) u8; d (out, nd) f32; sc (out, nsub)
// u8/i8 or null; dmin (out, ndm) f32 or null; mn (out, nsub) u8/i8 or null
// -> y (B, out) f32. s_side and m_side name each side's storage (Side),
// var the element rule (Var), vmap the code alphabet (Map). 4-bit: in % 32 ==
// 0; 2-bit: in % 64 == 0; both need (in * bits / 8) a multiple of nsub and
// 16-byte aligned rows.
int lgt_quant_matmul_lowbit(const void* x, const void* xsum, const void* codes,
                            const void* d, const void* sc, const void* dmin,
                            const void* mn, void* y, int B, int in_f, int out_f,
                            int nsub, int nd, int ndm, int bias, int s_side,
                            int m_side, int bits, int var, int vmap, void* stream) {
  const LowbitArgs a{(const __nv_bfloat16*)x, (const float*)xsum, (const uint8_t*)codes,
                     (const float*)d, (const uint8_t*)sc, (const float*)dmin,
                     (const uint8_t*)mn, (float*)y, B, in_f, out_f, nsub, nd, ndm, bias};
  const cudaStream_t st = (cudaStream_t)stream;
  if (bits == 4) {
    switch (var) {
      case kFsplit: return launch_map<4, kFsplit>(a, vmap, s_side, m_side, st);
      case kXsum: return launch_map<4, kXsum>(a, vmap, s_side, m_side, st);
      case kSplit: return launch_map<4, kSplit>(a, vmap, s_side, m_side, st);
      case kBase: return launch_map<4, kBase>(a, vmap, s_side, m_side, st);
      case kBaseF32: return launch_map<4, kBaseF32>(a, vmap, s_side, m_side, st);
    }
  } else if (bits == 2) {
    if (var == kFsplit) return launch_map<2, kFsplit>(a, vmap, s_side, m_side, st);
    if (var == kBaseF32) return launch_map<2, kBaseF32>(a, vmap, s_side, m_side, st);
  }
  return (int)cudaErrorInvalidValue;
}

// xq (B, in) int8 block-minor; xs, xsum (B, nsub) f32; codes (out, in/2) u8;
// d (out, nd) f32; sc (out, nsub) u8/i8 or null; dmin (out, nd) f32 or null;
// mn (out, nsub) u8/i8 or null -> y (B, out) f32. nsub % 4 == 0, in % 8 == 0.
int lgt_quant_matmul_int8(const void* xq, const void* xs, const void* xsum,
                          const void* codes, const void* d, const void* sc,
                          const void* dmin, const void* mn, void* y, int B, int in_f,
                          int out_f, int nsub, int nd, int bias, int s_side, int m_side,
                          void* stream) {
  const Int8Args a{(const int8_t*)xq, (const float*)xs, (const float*)xsum,
                   (const uint8_t*)codes, (const float*)d, (const uint8_t*)sc,
                   (const float*)dmin, (const uint8_t*)mn, (float*)y,
                   B, in_f, out_f, nsub, nd, bias};
  const cudaStream_t st = (cudaStream_t)stream;
#define LGT_CASE(S, M) \
  if (s_side == S && m_side == M) return launch_int8<S, M>(a, st);
  LGT_CASE(kFlat, kNone) LGT_CASE(kFlat, kFlat)
  LGT_CASE(kHierU8, kNone) LGT_CASE(kHierU8, kHierU8) LGT_CASE(kHierU8, kHierI8)
  LGT_CASE(kHierI8, kNone) LGT_CASE(kHierI8, kHierU8) LGT_CASE(kHierI8, kHierI8)
#undef LGT_CASE
  return (int)cudaErrorInvalidValue;
}

// x (B, in) bf16 block-minor; codes (out, in) int8; d (out, nd) f32;
// sc (out, nsub) u8/i8 or null; dmin (out, nd) f32 or null; mn (out, nsub)
// u8 or null -> y (B, out) f32. in % 16 == 0, nsub % nd == 0; 16-byte
// aligned rows.
int lgt_quant_matmul_8bit(const void* x, const void* codes, const void* d,
                          const void* sc, const void* dmin, const void* mn, void* y,
                          int B, int in_f, int out_f, int nd, int nsub, int bias,
                          int s_side, int m_side, void* stream) {
  if (in_f % 16 || nsub <= 0 || nd <= 0 || in_f % nsub || nsub % nd)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || out_f == 0) return 0;
  const Args8 a{(const __nv_bfloat16*)x, (const int8_t*)codes, (const float*)d,
                (const uint8_t*)sc, (const float*)dmin, (const uint8_t*)mn, (float*)y,
                B, in_f, out_f, nd, nsub, bias};
  const cudaStream_t st = (cudaStream_t)stream;
#define LGT_CASE(S, M) \
  if (s_side == S && m_side == M) return launch_8bit<S, M>(a, st);
  LGT_CASE(kFlat, kNone) LGT_CASE(kFlat, kFlat)
  LGT_CASE(kHierU8, kNone) LGT_CASE(kHierU8, kHierU8)
  LGT_CASE(kHierI8, kNone) LGT_CASE(kHierI8, kHierU8)
#undef LGT_CASE
  return (int)cudaErrorInvalidValue;
}

// The launch lgt_quant_matmul_8bit makes for these arguments, into info[7]:
// grid x, grid y, threads a block, dynamic shared bytes, registers a thread,
// local (spill) bytes a thread, resident blocks an SM.
int lgt_quant_matmul_8bit_plan(int B, int in_f, int out_f, int nsub, int s_side, int m_side,
                               void* info) {
  if (nsub <= 0) return (int)cudaErrorInvalidValue;
  int* const v = (int*)info;
#define LGT_CASE(S, M) \
  if (s_side == S && m_side == M) return plan_8bit<S, M>(B, in_f, out_f, nsub, v);
  LGT_CASE(kFlat, kNone) LGT_CASE(kFlat, kFlat)
  LGT_CASE(kHierU8, kNone) LGT_CASE(kHierU8, kHierU8)
  LGT_CASE(kHierI8, kNone) LGT_CASE(kHierI8, kHierU8)
#undef LGT_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
