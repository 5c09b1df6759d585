// Tensor-core path of the int8-activation 4-bit matmul, for prefill-sized
// row counts, for Hopper (sm_90a).
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
// with s and m' = bias*s + m as min_prime forms them in
// quant_matmul_lowbit_tc.cu (flat, or f32 per super-block times an 8-bit
// factor; no mixed layout: the dispatcher sends that to the dequantize
// path, as the JAX package does). Formats: Q4_K (sub 32), Q4_0 (bias 8),
// Q4_1 (flat min), Q3_K (sub 16, bias 4), in the flat and compact layouts.
//
// What bounds it: the int8 products are 2*B*in*out operations (0.061 ms at
// gate+up 28672x4096, B = 512, over 1,979 TOP/s), but each sub-block's int32
// sum is then converted, scaled and added on CUDA cores: B*out*nsub sums,
// four f32 instructions each (0.19 ms of a full card's issue rate at that
// shape), plus the min term's one. The epilogue, not the products, is the
// expected bound; tools/tc_ablate.py times the kernel without it.
//
// Design (tc_common.cuh's tile: 128 activation rows a block, 8 warps, x
// rows padded to 144 bytes; a 3-stage cp.async ring of x tiles, since a
// step's epilogue outlasts a load, and its lead of 2 steps lets a 2-step
// group's slot be refilled only after its last products):
// - Activation layout. An s8 mma contracts 32 consecutive k, but a
//   sub-block's elements sit nsub apart in block-minor order. The wrapper
//   hands the kernel xq sub-block-major, (B, nsub, sub), so a 128-byte step
//   of x holds 128/sub whole sub-blocks, and xs beside xsum as (B, nsub, 2)
//   f32. Both permutes are one PyTorch op each, counted in the wrapper's
//   time.
// - Weight fragments straight from the codes. Stored byte t'*nsub + k holds
//   element t' of sub-block k in its low nibble and t' + sub/2 in its high
//   one. An m16n8k32 B fragment (b0: k-bytes 4*tg..+3 of column g, b1: the
//   same +16) is then, for sub 32, the low and high nibbles of the 4 code
//   bytes t' = 4*tg..+3 of one sub-block: a thread reads 4 words (4
//   sub-blocks each) from the code tile, transposes them bytewise
//   (__byte_perm) and masks the nibbles; codes 0..15 are valid s8. For
//   sub 16 (Q3_K) a sub-block is one m16n8k16 (b0 only): tg < 2 take low
//   nibbles of t' = 4*tg.., tg >= 2 high ones of t' = 4*(tg-2)..; the two
//   sub-blocks of a 32-byte x chunk use its A fragment's halves. No decoded
//   weight tile, no decode stage, no ldmatrix of weights.
// - Groups of 16 sub-blocks. The code tile of a group ((sub/2) x 16 bytes a
//   row, cp.async with the group's first step) and its xs/xsum tile sit in
//   2-slot rings; s and m' of the next group are loaded and stored at a
//   group's first step, k-major, as (s, m') pairs (storing them only after
//   that step's products kept 16 registers live across it and ran slower;
//   each A fragment is loaded in the m-tile loop that uses it). Shared
//   memory: 3 x 18,432 (x) + 2 x 34,816 (codes) + 2 x 18,432 (xs, xsum) +
//   2 x 16,384 (s, m') = 194,560 bytes, one block of 128 output rows an SM
//   (warps of 64 x 32 outputs, so each fragment and scale loaded feeds 16
//   to 64 outputs; 255 registers, no spills).
// - Exact sums, cheap conversion. Each mma starts its int32 sums at
//   0x4B400000, the bits of 1.5*2^23, so the sum's bits are those of the
//   float 1.5*2^23 + p (|p| < 2^22): one f32 subtract converts it, exactly,
//   in place of the slower integer-to-float conversion. Then (p * xs) * s
//   and - xsum * m' go into f32 accumulators per output: the same
//   arithmetic as the plain version, summed in another order.
// - Ragged rows and columns: loads past B or out are zero-filled, their
//   scales zero, and the epilogue writes only rows < B and columns < out.

#include "tc_common.cuh"

namespace {

constexpr int kBN8 = 128;                   // output rows a block
constexpr int kRing = 3;                    // x tiles in flight: a step's epilogue is long
constexpr int kGK = 16;                     // sub-blocks a group
constexpr int kCP = 16 * 16 + 16;           // bytes a row of a code tile (sub 32; 144 at sub 16)
constexpr int kCSlot = kBN8 * kCP;          // 34,816
constexpr int kXsPitch = kGK * 8 + 16;      // bytes a row of the xs/xsum tile (144)
constexpr int kXsSlot = kBM * kXsPitch;     // 18,432
constexpr int kSmSlot = kGK * kBN8 * 8;     // (s, m') pairs of a group: 16,384
constexpr int kSmemInt8 = kRing * kXTile + 2 * kCSlot + 2 * kXsSlot + 2 * kSmSlot;
constexpr int kMagic = 0x4B400000;          // the bits of 1.5 * 2^23
constexpr float kMagicF = 12582912.f;       // 1.5 * 2^23

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

// Sub-blocks k0..k0+7 of one side of a row, as side_at reads them: the f32
// values 4 at a time (nd % 4 == 0, k0 % 4 == 0: no run wraps a
// super-block), the 8-bit factors in one 8-byte load. Zeros when !ok.
// (chunk_side's 16-wide runs, 16 sub-blocks a thread, ran 6% slower on an H100.)
template <int kSide>
__device__ __forceinline__ void side8(const float* base, const uint8_t* sub, int k0, int nd,
                                      bool ok, float (&v)[8]) {
  float4 f[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int kb = kSide == kFlat ? k0 + 4 * q : (k0 + 4 * q) % nd;
    f[q] = ok ? __ldg(reinterpret_cast<const float4*>(base + kb)) : float4{0.f, 0.f, 0.f, 0.f};
  }
  uint2 b{0, 0};
  if constexpr (kSide != kFlat) {
    if (ok) b = __ldg(reinterpret_cast<const uint2*>(sub + k0));
  }
  const float* fv = reinterpret_cast<const float*>(f);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if constexpr (kSide == kHierU8)
      v[e] = __fmul_rn(fv[e], (float)reinterpret_cast<const uint8_t*>(&b)[e]);
    else if constexpr (kSide == kHierI8)
      v[e] = __fmul_rn(fv[e], (float)reinterpret_cast<const int8_t*>(&b)[e]);
    else
      v[e] = fv[e];
  }
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

template <int kSub, int kS, int kM>
__global__ void __launch_bounds__(kThreads, 1)
quant_matmul_int8_tc_kernel(const ArgsInt8TC a) {
  using T = Tile<kBN8>;
  constexpr int kSB = kBK * 2 / kSub;        // sub-blocks a step (128 bytes): 4 or 8
  constexpr int kSpg = kGK / kSB;            // steps a group: 4 or 2
  constexpr int kTr = kSub / 2;              // code rows t' a group
  constexpr int kCPs = kTr * 16 + 16;        // bytes a row of this instance's code tile
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const xs = smem;                              // kRing x (kBM x 144) s8
  unsigned char* const cs = smem + kRing * kXTile;           // 2 x (kBN8 x kCPs) u8
  unsigned char* const xt = cs + 2 * kCSlot;                   // 2 x (kBM x 16 x (xs, xsum))
  float* const smt = reinterpret_cast<float*>(xt + 2 * kXsSlot);  // 2 x (16 x kBN8 x (s, m'))
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN8;
  const int steps = a.in_f / (kBK * 2);
  const int groups = a.nsub / kGK;
  const int half = a.in_f / 2;               // stored code bytes a row

  // the loads of step i: its x tile into ring slot i % kRing (4 16-byte
  // chunks a thread) and, on a group's first step, the group's code tile
  // and xs/xsum tile into slot (i / kSpg) % 2
  auto load = [&](int i) {
    unsigned char* xd = xs + (i % kRing) * kXTile;
#pragma unroll
    for (int r = 0; r < kBM * 8 / kThreads; ++r) {
      const int c = tid + r * kThreads, row = c >> 3, col = (c & 7) * 16;
      const bool ok = m0 + row < a.B;
      cp_async16(xd + row * kPitch * 2 + col,
                 ok ? a.xq + (size_t)(m0 + row) * a.in_f + i * kBK * 2 + col : a.xq, ok);
    }
    if (i % kSpg == 0) {
      const int grp = i / kSpg, slot = grp & 1;
      unsigned char* cd = cs + slot * kCSlot;
#pragma unroll
      for (int r = 0; r < kBN8 * kTr / kThreads; ++r) {
        const int c = tid + r * kThreads, row = c / kTr, tp = c % kTr;
        const bool ok = n0 + row < a.out_f;
        cp_async16(cd + row * kCPs + tp * 16,
                   ok ? a.codes + (size_t)(n0 + row) * half + (size_t)tp * a.nsub + grp * kGK
                      : a.codes, ok);
      }
      unsigned char* td = xt + slot * kXsSlot;
#pragma unroll
      for (int r = 0; r < kBM * 8 / kThreads; ++r) {
        const int c = tid + r * kThreads, row = c >> 3, ch = c & 7;
        const bool ok = m0 + row < a.B;
        cp_async16(td + row * kXsPitch + ch * 16,
                   ok ? a.xsx + ((size_t)(m0 + row) * a.nsub + grp * kGK) * 2 + ch * 4 : a.xsx,
                   ok);
      }
    }
  };

  // this thread stages s and m' of output row sn, sub-blocks sk0..sk0+7 of
  // a group; m' = bias*s + m as min_prime in quant_matmul_lowbit_tc.cu
  // forms it
  const int sn = tid % kBN8, sk0 = (tid / kBN8) * 8;
  const int so = n0 + sn;
  const bool so_ok = so < a.out_f;
  const size_t srow = (size_t)(so_ok ? so : 0);
  const int ndm = kM == kFlat ? a.nsub : a.nd;
  auto stage_scales = [&](int grp) {
    const int k0 = grp * kGK + sk0;
    float sv[8], mv[8];
    side8<kS>(a.d + srow * a.nd, kS == kFlat ? nullptr : a.sc + srow * a.nsub, k0, a.nd, so_ok,
              sv);
    if constexpr (kM != kNone) {
      side8<kM>(a.dmin + srow * ndm, kM == kFlat ? nullptr : a.mn + srow * a.nsub, k0, a.nd,
                so_ok, mv);
    }
    float* st = smt + (grp & 1) * (kSmSlot / 4);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float mp = kM != kNone ? mv[e] : 0.f;
      if (a.bias != 0) {
        const float bs = __fmul_rn((float)a.bias, sv[e]);
        mp = kM == kNone ? bs : __fadd_rn(bs, mp);
      }
      *reinterpret_cast<float2*>(st + (sk0 + e) * kBN8 * 2 + sn * 2) = float2{sv[e], mp};
    }
  };

  // this warp's outputs: rows wm.., columns wn..; a warp whose rows all lie
  // past B skips its products
  const int wm = (warp / T::kWarpsN) * T::kWarpM, wn = (warp % T::kWarpsN) * 32;
  const bool warp_live = m0 + wm < a.B;
  float acc[T::kMT][4][4];
#pragma unroll
  for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int i = 0; i < kRing - 1; ++i) {
    if (i < steps) load(i);
    cp_async_commit();
  }
  stage_scales(0);

  for (int i = 0; i < steps; ++i) {
    // step i has landed, and every warp is done with the slots of step i-1
    cp_async_wait<kRing - 2>();
    __syncthreads();
    if (i + kRing - 1 < steps) load(i + kRing - 1);
    cp_async_commit();
    const int grp = i / kSpg, slot = grp & 1;
    if (i % kSpg == 0 && grp + 1 < groups) stage_scales(grp + 1);

    if (warp_live) {
      // the B fragments of the step's kSB sub-blocks for the warp's 4
      // column tiles, from the code tile
      const unsigned char* ct = cs + slot * kCSlot;
      const int kb = (i % kSpg) * kSB;        // the step's first sub-block in the group
      uint32_t bf[4][kSB][kSub == 32 ? 2 : 1];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const unsigned char* cr = ct + (wn + nt * 8 + g) * kCPs;
#pragma unroll
        for (int q = 0; q < kSB / 4; ++q) {
          const int tr = kSub == 32 ? 4 * tg : 4 * (tg & 1);
          uint32_t w[4], col[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            w[j] = *reinterpret_cast<const uint32_t*>(cr + (tr + j) * 16 + kb + 4 * q);
          transpose4(w, col);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if constexpr (kSub == 32) {
              bf[nt][4 * q + c][0] = col[c] & 0x0F0F0F0Fu;
              bf[nt][4 * q + c][1] = (col[c] >> 4) & 0x0F0F0F0Fu;
            } else {
              bf[nt][4 * q + c][0] = (col[c] >> (tg < 2 ? 0 : 4)) & 0x0F0F0F0Fu;
            }
          }
        }
      }
      const unsigned char* xtile = xs + (i % kRing) * kXTile;
      const unsigned char* xst = xt + slot * kXsSlot;
      const float* st = smt + slot * (kSmSlot / 4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {       // 32-byte chunks of the step
#pragma unroll
        for (int h = 0; h < 32 / kSub; ++h) {  // sub-blocks of the chunk
          const int kl = kb + kk * (32 / kSub) + h;   // in the group
          const int sb = kk * (32 / kSub) + h;        // in the step
          float4 smv[4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            smv[nt] = *reinterpret_cast<const float4*>(st + (kl * kBN8 + wn + nt * 8 + 2 * tg) * 2);
#pragma unroll
          for (int mt = 0; mt < T::kMT; ++mt) {
            uint32_t af[4];
            ldmatrix_x4(af, xtile + (wm + mt * 16 + (lane & 15)) * kPitch * 2 + kk * 32
                                + (lane >> 4) * 16);
            int p[4][4];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              if constexpr (kSub == 32)
                mma_s8_k32(p[nt], af, bf[nt][sb][0], bf[nt][sb][1], kMagic);
              else
                mma_s8_k16(p[nt], af[2 * h], af[2 * h + 1], bf[nt][sb][0], kMagic);
            }
            const int r0 = wm + mt * 16 + g;
            const float2 x0 = *reinterpret_cast<const float2*>(xst + r0 * kXsPitch + kl * 8);
            const float2 x1 = *reinterpret_cast<const float2*>(xst + (r0 + 8) * kXsPitch + kl * 8);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const float s2[2] = {smv[nt].x, smv[nt].z}, m2[2] = {smv[nt].y, smv[nt].w};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 xv = e < 2 ? x0 : x1;
                const float pf = __int_as_float(p[nt][e]) - kMagicF;
                const float t = __fmul_rn(pf, xv.x);
                acc[mt][nt][e] = fmaf(t, s2[e & 1], acc[mt][nt][e]);
                acc[mt][nt][e] = fmaf(-xv.y, m2[e & 1], acc[mt][nt][e]);
              }
            }
          }
        }
      }
    }
  }

  // accumulator (mt, nt, e): row wm + mt*16 + lane/4 (+8 for e >= 2),
  // column wn + nt*8 + (lane%4)*2 + e%2
#pragma unroll
  for (int mt = 0; mt < T::kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn + nt * 8 + tg * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mt * 16 + g + h * 8;
        if (row < a.B) {
          float* yr = a.y + (size_t)row * a.out_f;
          if (col < a.out_f) yr[col] = acc[mt][nt][2 * h];
          if (col + 1 < a.out_f) yr[col + 1] = acc[mt][nt][2 * h + 1];
        }
      }
    }
  }
}

template <int kSub, int kS, int kM>
int launch_int8_tc(const ArgsInt8TC& a, cudaStream_t st) {
  constexpr int smem = kSmemInt8;
  static bool sized = false;   // the shared-memory limit is set once an instance
  if (!sized) {
    const int rc = (int)cudaFuncSetAttribute(quant_matmul_int8_tc_kernel<kSub, kS, kM>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != 0) return rc;
    sized = true;
  }
  const dim3 grid((a.B + kBM - 1) / kBM, (a.out_f + kBN8 - 1) / kBN8);
  quant_matmul_int8_tc_kernel<kSub, kS, kM><<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The (scale side, min side) pairs lgt_quant_matmul_int8 takes.
template <int kSub>
int launch_int8_sides(const ArgsInt8TC& a, int s_side, int m_side, cudaStream_t st) {
#define LGT_CASE(S, M) \
  if (s_side == S && m_side == M) return launch_int8_tc<kSub, S, M>(a, st);
  LGT_CASE(kFlat, kNone) LGT_CASE(kFlat, kFlat)
  LGT_CASE(kHierU8, kNone) LGT_CASE(kHierU8, kHierU8) LGT_CASE(kHierU8, kHierI8)
  LGT_CASE(kHierI8, kNone) LGT_CASE(kHierI8, kHierU8) LGT_CASE(kHierI8, kHierI8)
#undef LGT_CASE
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
  if (nsub <= 0 || in_f % nsub || nsub % kGK || nd <= 0 || nd % 4 || nsub % nd)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || out_f == 0) return 0;
  const ArgsInt8TC a{(const int8_t*)xq, (const float*)xsx, (const uint8_t*)codes,
                     (const float*)d, (const uint8_t*)sc, (const float*)dmin,
                     (const uint8_t*)mn, (float*)y, B, in_f, out_f, nsub, nd, bias};
  const cudaStream_t st = (cudaStream_t)stream;
  if (in_f / nsub == 32) return launch_int8_sides<32>(a, s_side, m_side, st);
  if (in_f / nsub == 16) return launch_int8_sides<16>(a, s_side, m_side, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
