// Fused dequantize + matmul over repacked quantized weights, for Hopper.
//
// Replaces three Pallas TPU kernels of llama_gguf_inference_tpu/ops/pallas_matmul.py:
//
//   lgt_quant_matmul_2bit  <- _make_kernel_qsplit (via _quant_matmul_2d_xsum,
//                             kern="qsplit"): 2-bit planar-quarter codes
//                             (Q2_K; the IQ1 trit codes share the geometry).
//   lgt_quant_matmul_4bit  <- _make_kernel_fsplit (via _quant_matmul_2d_xsum,
//                             kern="fsplit"): 4-bit planar-nibble codes
//                             (Q4_K, and Q3_K's 3-bit codes with bias 4).
//   lgt_quant_matmul_8bit  <- _make_kernel (via _quant_matmul_2d): int8 codes
//                             with compact hierarchical scales (Q6_K: f32 d per
//                             256, int8 sc per 16) or flat ones (Q8_0). The
//                             asymmetric 8-bit formats (dmin/mn) are not loaded
//                             by this package, so their min term is left out.
//
// All read the arrays the JAX kernels read, in the same block-minor element
// order (quant/repack.py block_minor_perm): stored position j of a row holds
// sub-block (j mod nsub), so a 16-byte code load meets a contiguous run of
// per-sub-block scales, and the activations arrive pre-permuted by the caller.
//
// 2- and 4-bit (P = 4 or 2 code planes, q = in/P stored codes per plane):
//   y[b,o] = sum_i sum_{j<q} x[b, i*q + j] * bf16(v_i(c[o,j]) * s[o, j mod nsub])
//          - sum_k xsum[b,k] * m'[o,k]
//   v_i(c) = (c >> (8/P)*i) & (2^(8/P) - 1)
// with the scale and min sides each read in one of the repack's layouts
// (_hier_scales in the JAX package), the side being a template parameter:
//   flat    s[k] = d[k]                           (d per sub-block)
//   hier    s[k] = d[k mod nd] * sc[k]            (d per super-block, sc u8/i8)
//   m'[k] = bias*s[k] + m[k], m[k] the min side read the same way (none,
//   flat, or hier with dmin per min super-block: nd for compact, in/min_size
//   for mixed, where the caller permuted xsum into the mn order and bias is 0).
// 8-bit:  y[b,o] = sum_j x[b,j] * bf16((c[o,j] - bias) * s_full[j])
//         s_sub[k] = d[o, k mod nd] * sc[o,k] (k < nsub), s_full[j] = s_sub[j mod nsub]
//         (tiles, not repeat-interleave: that is what pltpu.repeat does).
// Products are rounded to bf16 where the TPU kernel rounds them, sums run in
// f32, and the scale arithmetic uses __fmul_rn/__fadd_rn so nvcc cannot fuse
// it into an FMA the reference does not do.
//
// What bounds them on the card: at decode (a handful of activation rows)
// they stream their weight bytes once, so device-memory bandwidth bounds
// them. Bytes per weight: Q2_K 0.75 flat (6.0 bits), 0.578 mixed (4.625),
// 0.406 compact (3.25); Q4_K 0.75 flat, 0.672 mixed, 0.594 compact; Q3_K
// 0.75 flat, 0.578 compact; Q6_K about 1.08 compact.
// Design: one warp per output row, lanes walking the row in 16-byte code
// loads (coalesced, 512 bytes per warp step, the next step's load in flight
// during this one's arithmetic; 64 weights a lane at 2 bits, 32 at 4), the
// 2-bit lane's 16 sub-block scales formed once in registers and shared by
// the byte's four planes, the dequantized run applied to up to 8
// activation rows at once; a second grid axis tiles further activation rows,
// so any row count works (prefill re-reads the weights from L2 once per 8
// rows: right, not yet fast). Tensor cores, TMA, split-K and a shared-memory
// weight ring are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;   // output rows per block, one warp each
constexpr int kRows = 8;    // activation rows per block

// How one side (scale or min) of a 2/4-bit weight is stored.
enum Side : int { kNone = 0, kFlat = 1, kHierU8 = 2, kHierI8 = 3 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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

// Value of sub-block k on one side: a flat side's f32 array at k; a
// hierarchical side's f32 array at kb = k mod (its width) times the 8-bit
// sub-block factor sub[k].
template <int kSide>
__device__ __forceinline__ float side_at(const float* base, const uint8_t* sub,
                                         int k, int kb) {
  const float b = __ldg(base + (kSide == kFlat ? k : kb));
  if constexpr (kSide == kHierU8) return __fmul_rn(b, (float)__ldg(sub + k));
  if constexpr (kSide == kHierI8) return __fmul_rn(b, (float)(int8_t)__ldg(sub + k));
  return b;
}

struct LowbitArgs {
  const __nv_bfloat16* x;  // (B, in) block-minor
  const float* xsum;       // (B, nsub), in the min side's sub-block order
  const uint8_t* codes;    // (out, in * kBits / 8)
  const float* d;          // (out, nd)
  const uint8_t* sc;       // (out, nsub) or null
  const float* dmin;       // (out, ndm) or null
  const uint8_t* mn;       // (out, nsub) or null
  float* y;                // (B, out)
  int B, in_f, out_f, nsub, nd, ndm, bias;
};

// Steps the sub-block index k of consecutive stored positions, and kd = k
// mod nd for a hierarchical side (a flat side needs only k).
template <int kS>
__device__ __forceinline__ void next_sub(int& k, int& kd, int nsub, int nd) {
  if (++k == nsub) {
    k = 0;
    kd = 0;
  } else if (kS != kFlat && ++kd == nd) {
    kd = 0;
  }
}

// Registers bound the occupancy of these latency-bound loops: the 2-bit
// instance keeps 16 scales live across its four planes and is held to four
// blocks an SM, the 4-bit one (no scale array) to six, as the flat Q4_K
// kernel ran before the layouts were added.
template <int kBits, int kS, int kM>
__global__ void __launch_bounds__(kWarps * 32, kBits == 2 ? 4 : 6)
quant_matmul_lowbit_kernel(const LowbitArgs a) {
  constexpr int kPlanes = 8 / kBits;
  constexpr int kMask = (1 << kBits) - 1;
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int b0 = blockIdx.y * kRows;
  if (o >= a.out_f) return;  // warp-uniform; the kernel has no block barrier
  const int nb = min(kRows, a.B - b0);
  const int qn = a.in_f / kPlanes;  // codes per plane = stored bytes per row
  const uint8_t* crow = a.codes + (size_t)o * qn;
  const float* drow = a.d + (size_t)o * a.nd;
  const uint8_t* scrow = kS == kFlat ? nullptr : a.sc + (size_t)o * a.nsub;

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

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
    int kd = kS == kFlat ? 0 : k % a.nd;
    if constexpr (kBits == 4) {
      // two nibble planes, each product summed in the order of the flat
      // Q4_K kernel
      float wlo[16], whi[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float sv = side_at<kS>(drow, scrow, k, kd);
        wlo[e] = bf16_round(__fmul_rn((float)(c[e] & 0xF), sv));
        whi[e] = bf16_round(__fmul_rn((float)(c[e] >> 4), sv));
        next_sub<kS>(k, kd, a.nsub, a.nd);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < nb) {
          const __nv_bfloat16* xr = a.x + (size_t)(b0 + r) * a.in_f;
          float xl[16], xh[16];
          load_bf16x16(xr + j0, xl);
          load_bf16x16(xr + qn + j0, xh);
          float t = acc[r];
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            t = fmaf(xl[e], wlo[e], t);
            t = fmaf(xh[e], whi[e], t);
          }
          acc[r] = t;
        }
      }
    } else {
      // the 16 scales, formed once and shared by the four planes
      float s[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        s[e] = side_at<kS>(drow, scrow, k, kd);
        next_sub<kS>(k, kd, a.nsub, a.nd);
      }
#pragma unroll
      for (int i = 0; i < kPlanes; ++i) {
        float w[16];
#pragma unroll
        for (int e = 0; e < 16; ++e)
          w[e] = bf16_round(__fmul_rn((float)((c[e] >> (kBits * i)) & kMask), s[e]));
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < nb) {
            float xv[16];
            load_bf16x16(a.x + (size_t)(b0 + r) * a.in_f + i * qn + j0, xv);
            float t = acc[r];
#pragma unroll
            for (int e = 0; e < 16; ++e) t = fmaf(xv[e], w[e], t);
            acc[r] = t;
          }
        }
      }
    }
  }

  // min term: m'[k] formed once per sub-block, applied to every row
  float macc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) macc[r] = 0.f;
  if (kM != kNone || a.bias != 0) {
    const float* dminrow = kM == kNone ? nullptr : a.dmin + (size_t)o * a.ndm;
    const uint8_t* mnrow = (kM == kHierU8 || kM == kHierI8) ? a.mn + (size_t)o * a.nsub
                                                            : nullptr;
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
    const float dot = warp_sum(acc[r]);
    const float mdot = warp_sum(macc[r]);
    if (lane == 0) a.y[(size_t)(b0 + r) * a.out_f + o] = dot - mdot;
  }
}

template <int kBits>
int launch_lowbit(const LowbitArgs& a, int s_side, int m_side, cudaStream_t st) {
  const dim3 grid((a.out_f + kWarps - 1) / kWarps, (a.B + kRows - 1) / kRows);
#define LGT_CASE(S, M)                                                     \
  if (s_side == S && m_side == M) {                                        \
    quant_matmul_lowbit_kernel<kBits, S, M><<<grid, kWarps * 32, 0, st>>>(a); \
    return (int)cudaGetLastError();                                        \
  }
#define LGT_CASES(S) LGT_CASE(S, kNone) LGT_CASE(S, kFlat) LGT_CASE(S, kHierU8) \
  LGT_CASE(S, kHierI8)
  LGT_CASES(kFlat)
  LGT_CASES(kHierU8)
  LGT_CASES(kHierI8)
#undef LGT_CASES
#undef LGT_CASE
  return (int)cudaErrorInvalidValue;
}

__global__ void quant_matmul_8bit_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ codes,
    const float* __restrict__ d, const int8_t* __restrict__ sc,
    float* __restrict__ y, int B, int in_f, int out_f, int nd, int nsub,
    int bias) {
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int b0 = blockIdx.y * kRows;
  if (o >= out_f) return;
  const int nb = min(kRows, B - b0);
  const int8_t* crow = codes + (size_t)o * in_f;
  const float* drow = d + (size_t)o * nd;
  const int8_t* scrow = sc ? sc + (size_t)o * nsub : nullptr;

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  for (int j0 = lane * 16; j0 < in_f; j0 += 32 * 16) {
    const int4 c4 = __ldg(reinterpret_cast<const int4*>(crow + j0));
    const int8_t* c = reinterpret_cast<const int8_t*>(&c4);
    float w[16];
    int k = j0 % nsub;  // sub-block of position j
    int dd = k % nd;    // its super-block
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      float s = __ldg(drow + dd);
      if (scrow) s = __fmul_rn(s, (float)scrow[k]);
      w[e] = bf16_round(__fmul_rn((float)((int)c[e] - bias), s));
      if (++k == nsub) {
        k = 0;
        dd = 0;
      } else if (++dd == nd) {
        dd = 0;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nb) {
        float xv[16];
        load_bf16x16(x + (size_t)(b0 + r) * in_f + j0, xv);
        float a = acc[r];
#pragma unroll
        for (int e = 0; e < 16; ++e) a = fmaf(xv[e], w[e], a);
        acc[r] = a;
      }
    }
  }
  for (int r = 0; r < nb; ++r) {
    const float dot = warp_sum(acc[r]);
    if (lane == 0) y[(size_t)(b0 + r) * out_f + o] = dot;
  }
}

}  // namespace

extern "C" {

// x (B, in) bf16 block-minor; xsum (B, nsub) f32; codes (out, in*bits/8) u8;
// d (out, nd) f32; sc (out, nsub) u8/i8 or null; dmin (out, ndm) f32 or null;
// mn (out, nsub) u8/i8 or null -> y (B, out) f32. s_side and m_side name each
// side's storage (Side above). 4-bit: in % 32 == 0; 2-bit: in % 64 == 0; both
// need (in * bits / 8) a multiple of nsub and 16-byte aligned rows.
int lgt_quant_matmul_4bit(const void* x, const void* xsum, const void* codes,
                          const void* d, const void* sc, const void* dmin,
                          const void* mn, void* y, int B, int in_f, int out_f,
                          int nsub, int nd, int ndm, int bias, int s_side,
                          int m_side, void* stream) {
  const LowbitArgs a{(const __nv_bfloat16*)x, (const float*)xsum, (const uint8_t*)codes,
                     (const float*)d, (const uint8_t*)sc, (const float*)dmin,
                     (const uint8_t*)mn, (float*)y, B, in_f, out_f, nsub, nd, ndm, bias};
  return launch_lowbit<4>(a, s_side, m_side, (cudaStream_t)stream);
}

int lgt_quant_matmul_2bit(const void* x, const void* xsum, const void* codes,
                          const void* d, const void* sc, const void* dmin,
                          const void* mn, void* y, int B, int in_f, int out_f,
                          int nsub, int nd, int ndm, int bias, int s_side,
                          int m_side, void* stream) {
  const LowbitArgs a{(const __nv_bfloat16*)x, (const float*)xsum, (const uint8_t*)codes,
                     (const float*)d, (const uint8_t*)sc, (const float*)dmin,
                     (const uint8_t*)mn, (float*)y, B, in_f, out_f, nsub, nd, ndm, bias};
  return launch_lowbit<2>(a, s_side, m_side, (cudaStream_t)stream);
}

// x (B, in) bf16 block-minor; codes (out, in) int8; d (out, nd) f32;
// sc (out, nsub) int8 or null -> y (B, out) f32. in % 16 == 0.
int lgt_quant_matmul_8bit(const void* x, const void* codes, const void* d,
                          const void* sc, void* y, int B, int in_f, int out_f,
                          int nd, int nsub, int bias, void* stream) {
  const dim3 grid((out_f + kWarps - 1) / kWarps, (B + kRows - 1) / kRows);
  quant_matmul_8bit_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)codes, (const float*)d,
      (const int8_t*)sc, (float*)y, B, in_f, out_f, nd, nsub, bias);
  return (int)cudaGetLastError();
}

}  // extern "C"
