// Tensor-core path of the 2- and 4-bit dequantize + matmul, for prefill-sized
// row counts, for Hopper (sm_90a).
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
// rounded to bf16 first (rule_factors keeps that rounded scale in the decode
// stage's registers); its min term is fsplit's, xsum.m' with m' = bias*s + m
// in f32 (pallas_matmul.py:296-305). The split body differs from xsum only in
// summing the two nibble planes' dots apart and adding them at the end: an
// order of f32 sums. This kernel walks every plane as steps of its own into
// one accumulator under any rule, so split runs xsum's instances (its
// wrapper counts its launches under its own name).
//
// The base rules fold the min into the weight (w = bf16(bf16(q*bf16 s) -
// bf16 m') and w = bf16((v(q) - bias)*s - m) in f32), so their instances
// have no xsum term and skip the min-term prologue below; the decode stage
// keeps a second register array, the chunk's m' (or m), beside its scales.
// The base rules take no mixed layout, as the JAX dispatcher sends it to
// matmul_xla.
//
// The fsplit rule computes what the decode kernel's fsplit rule computes: with P =
// 8/bits code planes, q = in/P stored bytes a row, plane i's code of stored
// byte j c_i = (byte >> bits*i) & (2^bits - 1) and k = j mod nsub,
//   y[b,o] = sum_i sum_j x[b, i*q + j] * bf16(v(c_i) * s[k])
//            - sum_k xsum[b,k] * m'[k],   m'[k] = bias*s[k] + m[k]
// s and m read in the layouts side_at reads (flat, or f32 per super-block
// times an 8-bit factor; the min side of the mixed layout per min_size, with
// xsum permuted into its order by the caller and bias 0). The weight is
// exact in bf16, so its products with bf16 x are exact in f32, and this
// kernel differs from the plain version only in the order of its f32 sums.
// The min term stays f32: it is formed on CUDA cores in the epilogue, as the
// decode kernel forms it, never on bf16 or TF32 tensor cores.
//
// What bounds it: at B = 512 rows, operations (2*B*in*out over 989 TFLOP/s
// bf16: 0.1216 ms at gate+up 28672x4096); below about 64 rows, the weight
// bytes.
//
// Design: quant_matmul_tc.cu's kernel (tc_common.cuh: 128 activation rows a
// block, a 4-stage cp.async ring of x tiles, each code tile decoded once
// into a bf16 shared-memory tile that all rows share, ldmatrix +
// mma.sync.m16n8k16 with f32 accumulators, the row walked by chunks of 64
// sub-blocks with each thread's scales loaded once a chunk and kept in
// registers), with its own decode stage and a min-term prologue, always 64
// output rows a block and two blocks an SM: one block's min term then runs
// beside the other's products (measured faster than 128-row tiles at every
// 8B projection, 16 to 512 rows; PERF.md §6).
// - Planar storage: one stored byte feeds P weight columns and P slices of
//   x. A step is sized in weights, not stored bytes: it covers 64 positions
//   of one plane, so the x tile, the weight tile and the products are the
//   8-bit kernel's. The P steps of one plane group read the same 64 stored
//   bytes; chunk kc's sub steps are (t, i) for t < sub/P stored-byte groups
//   at t*nsub + kc*64 and planes i < P, planes innermost. Taking 64 stored
//   bytes a step instead would widen the x tile P-fold (4 stages x 36,864
//   bytes of x at 4 bits, 73,728 at 2 bits), past the 227 KB a block has.
// - The code tile of a plane group is loaded with its first plane's x tile
//   into a ring of 2 code slots (slot g mod 2 for group g): a group's P >= 2
//   steps outlast the ring's lead of 3 steps, so the next group's load never
//   meets a slot still decoded. Shared memory: 4 x 18,432 (x) + 2 x 5,120
//   (codes) + 2 x 9,216 (weights) = 102,400 bytes.
// - The decode: a thread takes kPer bytes of one output row, shifts out
//   plane i's code, maps it (IQ2/IQ3), multiplies by its register-held scale
//   (__fmul_rn) and rounds to bf16: a shift, a mask, a convert, a multiply
//   and half a pack per weight. This needs nsub % 64 == 0, sub % P == 0 and
//   nd % 4 == 0 (in = 4096 and 14336 at sub-blocks of 16 or 32); the
//   wrapper keeps other geometries on the decode kernel.
// - The min term, -sum_k xsum[b,k]*m'[o,k], is 1/sub of the main product's
//   multiply-adds (1/32 for Q4_K, 1/16 for Q2_K). Before the main loop,
//   while its first loads are in flight, the block stages xsum (its 128
//   rows) and m' (its output rows, formed from the scale and min sides as
//   the decode kernel forms them) 32 sub-blocks at a time in ring slots the
//   main loop has not filled yet, and each thread starts its accumulators at
//   its outputs' -min dots, in f32 fused multiply-adds on CUDA cores. A
//   thread issues all its loads of a chunk at once; the loads cost more than
//   the multiply-adds (PERF.md §6), but loading the next chunk while summing
//   this one held more registers than the 128 of two blocks an SM allow,
//   and the spills ran 10% slower. Summing
//   the term after the main loop in accumulators of its own, as the decode
//   kernel's dot - mdot does, kept the output 5x closer to the plain version
//   (2e-6 of its scale at Q2_K, against 1.1e-5 here) but ran 10-25% slower:
//   no block's own loads overlap it, and at one wave of blocks nothing does.
// - Ragged rows and columns: loads past B or out are zero-filled, their
//   scales zero, and the epilogue writes only rows < B and columns < out.

#include "tc_common.cuh"
#include "lowbit_rule.cuh"

namespace {

constexpr int kBN = 64;         // output rows a block, two blocks an SM
constexpr int kCodeStages = 2;  // code slots, one per plane group
constexpr int kEK = 32;         // sub-blocks of the min term staged at a time

// Whether rule kVar subtracts the min term xsum.m' after the products (fsplit
// and xsum) rather than folding the min into the weight (base, base_f32).
template <int kVar>
constexpr bool kMinTerm = kVar == kFsplit || kVar == kXsum;

constexpr int kSmemLow = kStages * kXTile + kCodeStages * Tile<kBN>::kCTile
                         + 2 * Tile<kBN>::kWTile;   // 102,400 bytes

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

// This thread's run of kPer stored bytes c: plane p's codes to the weights
// of the element rule kVar (lowbit_rule.cuh) with the sub-block factors s[e]
// and m[e], stored at wd as bf16. The fsplit rule, bf16(v(code) * s[e]),
// rounds once, in the pack.
template <int kVar, int kBits, int kMap, int kM, int kPer>
__device__ __forceinline__ void decode_plane(const uint8_t* c, int p, const float (&s)[kPer],
                                             const float (&m)[kPer], int bias,
                                             unsigned char* wd) {
  constexpr int kMask = (1 << kBits) - 1;
  const int sh = kBits * p;
  uint32_t w[kPer / 2];
#pragma unroll
  for (int e = 0; e < kPer; e += 2) {
    const int q0 = (c[e] >> sh) & kMask, q1 = (c[e + 1] >> sh) & kMask;
    float v0, v1;
    if constexpr (kVar == kFsplit) {
      v0 = __fmul_rn((float)code_value<kMap>(q0), s[e]);
      v1 = __fmul_rn((float)code_value<kMap>(q1), s[e + 1]);
    } else {
      v0 = element<kVar, kM, kMap>(q0, s[e], m[e], bias);
      v1 = element<kVar, kM, kMap>(q1, s[e + 1], m[e + 1], bias);
    }
    const __nv_bfloat162 pr = __floats2bfloat162_rn(v0, v1);
    w[e / 2] = *reinterpret_cast<const uint32_t*>(&pr);
  }
#pragma unroll
  for (int h = 0; h < kPer / 8; ++h)
    reinterpret_cast<uint4*>(wd)[h] = uint4{w[4 * h], w[4 * h + 1], w[4 * h + 2], w[4 * h + 3]};
}

// m'[o,k] = bias*s[k] + m[k], each side read as side_at reads it, rounded as
// the decode kernel rounds it.
template <int kS, int kM>
__device__ __forceinline__ float min_prime(const ArgsLowTC& a, int o, int k) {
  float mp = 0.f;
  if constexpr (kM != kNone)
    mp = side_at<kM>(a.dmin + (size_t)o * a.ndm, kM == kFlat ? nullptr : a.mn + (size_t)o * a.nsub,
                     k, kM == kFlat ? k : k % a.ndm);
  if (a.bias != 0) {
    const float bs = __fmul_rn((float)a.bias,
                               side_at<kS>(a.d + (size_t)o * a.nd,
                                           kS == kFlat ? nullptr : a.sc + (size_t)o * a.nsub,
                                           k, kS == kFlat ? k : k % a.nd));
    mp = kM == kNone ? bs : __fadd_rn(bs, mp);
  }
  return mp;
}

template <int kBits, int kVar, int kMap, int kS, int kM>
__global__ void __launch_bounds__(kThreads, 2)
quant_matmul_lowbit_tc_kernel(const ArgsLowTC a) {
  using T = Tile<kBN>;
  constexpr int kP = 8 / kBits;
  constexpr int kPer = T::kPer;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const xs = smem;                            // kStages x (kBM x kPitch) bf16
  unsigned char* const cs = smem + kStages * kXTile;         // kCodeStages x (kBN x kCPitch) u8
  unsigned char* const ws = cs + kCodeStages * T::kCTile;    // 2 x (kBN x kPitch) bf16
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int q = a.in_f / kP;         // stored bytes a row
  const int sub = a.in_f / a.nsub;   // steps a chunk
  const int steps = a.in_f / kBK;

  // the loads of step i: its x tile into ring slot i % kStages (4 16-byte
  // chunks a thread) and, on a plane group's first step, the group's code
  // tile into code slot (i / kP) % kCodeStages (2 or 1 chunks a thread)
  auto load = [&](int i) {
    const int n = i % sub, p = n % kP;
    const int j0 = (n / kP) * a.nsub + (i / sub) * kBK;
    const int xcol = p * q + j0;
    unsigned char* xd = xs + (i % kStages) * kXTile;
#pragma unroll
    for (int r = 0; r < kBM * kBK / 8 / kThreads; ++r) {
      const int c = tid + r * kThreads, row = c >> 3, col = (c & 7) * 8;
      const bool ok = m0 + row < a.B;
      cp_async16(xd + (row * kPitch + col) * 2,
                 ok ? a.x + (size_t)(m0 + row) * a.in_f + xcol + col : a.x, ok);
    }
    if (p == 0) {
      unsigned char* cd = cs + ((i / kP) % kCodeStages) * T::kCTile;
#pragma unroll
      for (int r = 0; r < kBN * kBK / 16 / kThreads; ++r) {
        const int c = tid + r * kThreads, row = c >> 2, col = (c & 3) * 16;
        const bool ok = n0 + row < a.out_f;
        cp_async16(cd + row * kCPitch + col,
                   ok ? a.codes + (size_t)(n0 + row) * q + j0 + col : a.codes, ok);
      }
    }
  };

  // this thread decodes output row n of the tile, stored bytes kk0..kk0+kPer-1
  // of each group, sub-blocks kc*64 + kk0.. of chunk kc; s holds their scales
  const int n = tid % kBN, kk0 = (tid / kBN) * kPer;
  const int o = n0 + n;
  const bool o_ok = o < a.out_f;
  const size_t orow = (size_t)(o_ok ? o : 0);
  const float* drow = a.d + orow * a.nd;
  const uint8_t* scrow = kS == kFlat ? nullptr : a.sc + orow * a.nsub;
  // the base rules' min side, as wide as the scale side (no mixed layout)
  const float* dminrow = kM == kNone ? nullptr : a.dmin + orow * a.ndm;
  const uint8_t* mnrow = (kM == kHierU8 || kM == kHierI8) ? a.mn + orow * a.nsub : nullptr;
  float s[kPer], m[kPer];

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

  for (int i = 0; i < kStages - 2; ++i) {
    if (i < steps) load(i);
    cp_async_commit();
  }

  // While the first steps' loads are in flight, the min term starts the
  // sums: acc = -sum_k xsum[b,k] * m'[o,k], kEK sub-blocks at a time. xsum
  // (kEK x kBM) and m' (kEK x kBN) are staged k-major in ring slots 2 and 3,
  // which the main loop first fills after its first barrier; rows padded by
  // one float, so the stores of consecutive sub-blocks fall on distinct
  // banks. A thread issues all its loads of a chunk before it uses any, and
  // before the barrier that waits for the other warps' sums of the chunk
  // before.
  if (kMinTerm<kVar> && (kM != kNone || a.bias != 0)) {
    constexpr int kXE = kEK * kBM / kThreads, kME = kEK * kBN / kThreads;
    float* const xsm = reinterpret_cast<float*>(xs + (kStages - 2) * kXTile);
    float* const msm = xsm + kEK * (kBM + 1);
    for (int k0 = 0; k0 < a.nsub; k0 += kEK) {
      float xl[kXE], ml[kME];
#pragma unroll
      for (int r = 0; r < kXE; ++r) {
        const int e = tid + r * kThreads, row = m0 + e / kEK;
        xl[r] = row < a.B ? __ldg(a.xsum + (size_t)row * a.nsub + k0 + e % kEK) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kME; ++r) {
        const int e = tid + r * kThreads, o = n0 + e / kEK;
        ml[r] = o < a.out_f ? min_prime<kS, kM>(a, o, k0 + e % kEK) : 0.f;
      }
      if (k0 > 0) __syncthreads();   // every warp is done with the chunk before
#pragma unroll
      for (int r = 0; r < kXE; ++r) {
        const int e = tid + r * kThreads;
        xsm[(e % kEK) * (kBM + 1) + e / kEK] = xl[r];
      }
#pragma unroll
      for (int r = 0; r < kME; ++r) {
        const int e = tid + r * kThreads;
        msm[(e % kEK) * (kBN + 1) + e / kEK] = ml[r];
      }
      __syncthreads();
      if (warp_live) {
#pragma unroll 4
        for (int kk = 0; kk < kEK; ++kk) {
          const float* xr = xsm + kk * (kBM + 1) + wm + (lane >> 2);
          const float* mr = msm + kk * (kBN + 1) + wn + (lane & 3) * 2;
          float xv[T::kMT][2], mv[4][2];
#pragma unroll
          for (int mt = 0; mt < T::kMT; ++mt) {
            xv[mt][0] = xr[mt * 16];
            xv[mt][1] = xr[mt * 16 + 8];
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            mv[nt][0] = mr[nt * 8];
            mv[nt][1] = mr[nt * 8 + 1];
          }
#pragma unroll
          for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[mt][nt][e] = fmaf(-xv[mt][e >> 1], mv[nt][e & 1], acc[mt][nt][e]);
        }
      }
    }
  }

  // iteration i decodes step i+1 and multiplies step i; the first only decodes
  for (int i = -1; i < steps; ++i) {
    // steps <= i+1 have landed, weight tile i is decoded, and every warp is
    // done with the slots of step i-1
    cp_async_wait<kStages - 3>();
    __syncthreads();
    if (i + kStages - 1 < steps) load(i + kStages - 1);
    cp_async_commit();

    const int nx = i + 1;
    if (nx < steps) {
      if (nx % sub == 0) {   // a new chunk: its scales (and the base rules' mins)
        const int k0 = (nx / sub) * kBK + kk0;
        chunk_side<kS>(drow, scrow, k0, a.nd, o_ok, s);
        if constexpr (kVar != kFsplit) {
          // the xsum rule's min side feeds only the min term (and may be the
          // mixed layout's, narrower than the scale side)
          float mv[kPer];
          if constexpr (!kMinTerm<kVar> && kM != kNone) {
            chunk_side<kM>(dminrow, mnrow, k0, a.nd, o_ok, mv);
          } else {
#pragma unroll
            for (int e = 0; e < kPer; ++e) mv[e] = 0.f;
          }
#pragma unroll
          for (int e = 0; e < kPer; ++e) rule_factors<kVar, kM>(s[e], mv[e], a.bias, s[e], m[e]);
        }
      }
      const unsigned char* cp = cs + ((nx / kP) % kCodeStages) * T::kCTile + n * kCPitch + kk0;
      uint4 cq[kPer / 16];
#pragma unroll
      for (int h = 0; h < kPer / 16; ++h) cq[h] = *reinterpret_cast<const uint4*>(cp + 16 * h);
      decode_plane<kVar, kBits, kMap, kM, kPer>(reinterpret_cast<const uint8_t*>(cq),
                                                (nx % sub) % kP, s, m, a.bias,
                                                ws + (nx & 1) * T::kWTile + (n * kPitch + kk0) * 2);
    }

    if (i >= 0 && warp_live) {
      step_products<T::kMT>(acc, xs + (i % kStages) * kXTile, ws + (i & 1) * T::kWTile, wm, wn,
                            lane);
    }
  }

  // accumulator (mt, nt, e): row wm + mt*16 + lane/4 (+8 for e >= 2),
  // column wn + nt*8 + (lane%4)*2 + e%2
#pragma unroll
  for (int mt = 0; mt < T::kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn + nt * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mt * 16 + (lane >> 2) + h * 8;
        if (row < a.B) {
          float* yr = a.y + (size_t)row * a.out_f;
          if (col < a.out_f) yr[col] = acc[mt][nt][2 * h];
          if (col + 1 < a.out_f) yr[col + 1] = acc[mt][nt][2 * h + 1];
        }
      }
    }
  }
}

template <int kBits, int kVar, int kMap, int kS, int kM>
int launch_low(const ArgsLowTC& a, cudaStream_t st) {
  constexpr int smem = kSmemLow;
  static bool sized = false;   // the shared-memory limit is set once an instance
  if (!sized) {
    const int rc = (int)cudaFuncSetAttribute(
        quant_matmul_lowbit_tc_kernel<kBits, kVar, kMap, kS, kM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != 0) return rc;
    sized = true;
  }
  const dim3 grid((a.B + kBM - 1) / kBM, (a.out_f + kBN - 1) / kBN);
  quant_matmul_lowbit_tc_kernel<kBits, kVar, kMap, kS, kM><<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The min sides a scale side pairs with, as lgt_quant_matmul_lowbit takes
// them: none, or flat beside a flat scale, or hierarchical (compact beside
// a hierarchical scale; mixed beside a flat one, the fsplit and xsum rules
// only). Mapped codes come without a min.
template <int kBits, int kVar, int kMap, int kS>
int launch_low_m(const ArgsLowTC& a, int m_side, cudaStream_t st) {
  if (m_side == kNone) return launch_low<kBits, kVar, kMap, kS, kNone>(a, st);
  if constexpr (kMap == kIdentity) {
    if constexpr (kS == kFlat) {
      if (m_side == kFlat) return launch_low<kBits, kVar, kMap, kS, kFlat>(a, st);
    }
    if constexpr (kS != kFlat || kMinTerm<kVar>) {
      if (m_side == kHierU8) return launch_low<kBits, kVar, kMap, kS, kHierU8>(a, st);
      if (m_side == kHierI8) return launch_low<kBits, kVar, kMap, kS, kHierI8>(a, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <int kBits, int kVar, int kMap>
int launch_low_s(const ArgsLowTC& a, int s_side, int m_side, cudaStream_t st) {
  if (s_side == kFlat) return launch_low_m<kBits, kVar, kMap, kFlat>(a, m_side, st);
  if (s_side == kHierU8) return launch_low_m<kBits, kVar, kMap, kHierU8>(a, m_side, st);
  if (s_side == kHierI8) return launch_low_m<kBits, kVar, kMap, kHierI8>(a, m_side, st);
  return (int)cudaErrorInvalidValue;
}

// The rules and maps an instance takes, as lgt_quant_matmul_lowbit's
// launch_map: fsplit with any map at 4 bits, the identity at 2; xsum and
// split (one instance) and base, 4-bit identity codes only; base_f32 at 2
// bits, and at 4 bits for the IQ2/IQ3 maps only.
template <int kBits>
int launch_low_var(const ArgsLowTC& a, int var, int vmap, int s_side, int m_side,
                   cudaStream_t st) {
  if (var == kFsplit && vmap == kIdentity)
    return launch_low_s<kBits, kFsplit, kIdentity>(a, s_side, m_side, st);
  if constexpr (kBits == 2) {
    if (var == kBaseF32 && vmap == kIdentity)
      return launch_low_s<2, kBaseF32, kIdentity>(a, s_side, m_side, st);
  } else {
    if ((var == kXsum || var == kSplit) && vmap == kIdentity)
      return launch_low_s<4, kXsum, kIdentity>(a, s_side, m_side, st);
    if (var == kBase && vmap == kIdentity)
      return launch_low_s<4, kBase, kIdentity>(a, s_side, m_side, st);
    if (var == kFsplit && vmap == kIq2)
      return launch_low_s<4, kFsplit, kIq2>(a, s_side, m_side, st);
    if (var == kFsplit && vmap == kIq3)
      return launch_low_s<4, kFsplit, kIq3>(a, s_side, m_side, st);
    if (var == kBaseF32 && vmap == kIq2)
      return launch_low_s<4, kBaseF32, kIq2>(a, s_side, m_side, st);
    if (var == kBaseF32 && vmap == kIq3)
      return launch_low_s<4, kBaseF32, kIq3>(a, s_side, m_side, st);
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
  if (!takes(4, in_f, nsub, nd, ndm)) return (int)cudaErrorInvalidValue;
  if (B == 0 || out_f == 0) return 0;
  const ArgsLowTC a{(const __nv_bfloat16*)x, (const float*)xsum, (const uint8_t*)codes,
                    (const float*)d, (const uint8_t*)sc, (const float*)dmin,
                    (const uint8_t*)mn, (float*)y, B, in_f, out_f, nsub, nd, ndm, bias};
  return launch_low_var<4>(a, var, vmap, s_side, m_side, (cudaStream_t)stream);
}

// As lgt_quant_matmul_4bit_tc, with codes (out, in/4) planar quarters, the
// fsplit or base_f32 rule and no code map (vmap 0).
int lgt_quant_matmul_2bit_tc(const void* x, const void* xsum, const void* codes,
                             const void* d, const void* sc, const void* dmin, const void* mn,
                             void* y, int B, int in_f, int out_f, int nsub, int nd, int ndm,
                             int bias, int s_side, int m_side, int var, int vmap, void* stream) {
  if (!takes(2, in_f, nsub, nd, ndm)) return (int)cudaErrorInvalidValue;
  if (B == 0 || out_f == 0) return 0;
  const ArgsLowTC a{(const __nv_bfloat16*)x, (const float*)xsum, (const uint8_t*)codes,
                    (const float*)d, (const uint8_t*)sc, (const float*)dmin,
                    (const uint8_t*)mn, (float*)y, B, in_f, out_f, nsub, nd, ndm, bias};
  return launch_low_var<2>(a, var, vmap, s_side, m_side, (cudaStream_t)stream);
}

}  // extern "C"
