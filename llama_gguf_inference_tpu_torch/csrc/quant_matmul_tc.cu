// Tensor-core path of the 8-bit dequantize + matmul, for prefill-sized row
// counts, for Hopper (sm_90a).
//
// Replaces, from ops/quant_matmul.py's TC_MIN_ROWS activation rows up, the
// TPU body of _make_kernel's 8-bit branch
// (llama_gguf_inference_tpu/ops/pallas_matmul.py:123, its min term :152-155,
// launched by the pallas_call at :247): int8 codes with compact hierarchical
// scales (Q6_K, IQ4_XS: f32 d per 256 times an i8 sc per sub-block; Q5_K:
// u8 sc and mn) or flat ones (Q8_0, Q5_0, Q5_1, Q8_1, Q8_K, IQ4_NL). Fewer
// rows take lgt_quant_matmul_8bit in quant_matmul.cu, the decode kernel.
//
// It computes what lgt_quant_matmul_8bit computes:
//   y[b,o] = sum_j x[b,j] * bf16(((float)(c[o,j] - bias) * s_full[j]) - m_full[j])
// s_full[j] = s_sub[j mod nsub] read as side_at reads it (flat: d[o,k];
// hierarchical: d[o, k mod nd] * sc[o,k]), the min side alike; the product
// and the subtract rounded in f32 on their own (__fmul_rn/__fsub_rn), the
// weight rounded once to bf16. A bf16 x bf16 product is exact in f32, so
// this kernel and the plain version differ only in the order of the f32
// sums.
//
// What bounds it: at B = 512 rows, operations (2*B*in*out over 989 TFLOP/s
// bf16: 0.1216 ms at gate+up 28672x4096); below about 64 rows, the weight
// bytes.
//
// Design. One block of 8 warps owns a tile of 128 activation rows by 128
// output rows (64 output rows, two blocks an SM, where 128-row tiles would
// leave SMs without a block: one tile of rows and a narrow out) and walks the
// stored positions in steps of 64:
// - cp.async brings each step's x tile (bf16) and int8 code tile into a
//   ring of 4 shared-memory stages; a step's loads are issued three steps
//   ahead of its products.
// - The block dequantizes each code tile once into a bf16 weight tile in
//   shared memory (double-buffered), shared by all 128 rows: a weight is
//   decoded ceil(B/128) times in all (4 at B = 512), where the decode
//   kernel decodes it once per 8 rows (64 times).
// - Block-minor order puts sub-block j mod nsub at stored position j, so 64
//   consecutive positions meet 64 consecutive sub-blocks. The block walks
//   the row by sub-block chunk: chunk kc covers sub-blocks kc*64..kc*64+63,
//   and its sub_size steps sit at positions t*nsub + kc*64 (t < sub_size).
//   A thread decodes the same (row, sub-block) slots, 32 (or 16) of one row,
//   in every step of a chunk, so it loads their scales and mins once a chunk
//   (16-byte loads, all in flight together) and keeps them in registers: a
//   weight then costs a convert, a multiply, a subtract and half a bf16
//   pack. This needs nsub % 64 == 0 (in = 4096 and 14336 at sub-blocks of
//   16 or 32); the wrapper sends other geometries to the decode kernel.
// - One barrier a step: after it, the threads decode step i+1's tile, then
//   run step i's products.
// - ldmatrix feeds mma.sync.m16n8k16 (bf16 in, f32 accumulators): x is A
//   (row-major, rows x positions), the weight tile is B in .col form (output
//   rows x positions, row-major). Each warp owns 64 x 32 outputs (32 x 32 in
//   the 64-row tile); a warp whose rows all lie past B skips its products.
//   Rows of the x and weight tiles are padded to 144 bytes so the 8 rows an
//   ldmatrix reads fall on distinct banks.
// - Ragged rows and columns: loads past B or out are zero-filled, their
//   weights zero, and the epilogue writes only rows < B and columns < out.
// - Consecutive blocks share a weight tile and differ in rows, so the
//   ceil(B/128) blocks that read one weight tile run together and read it
//   from device memory about once.
// Measured (PERF.md §6, tools/tc_ablate.py): at 512 rows neither the decode
// nor the products alone bound it; either one removed leaves 55-74% of the
// time. mma.sync runs on Hopper's tensor cores below wgmma's rate, with
// every fragment staged through registers by ldmatrix; a wgmma + TMA version
// (the weight tile written in wgmma's swizzled layout, x fetched by TMA) is
// the next step (ROADMAP B.1).

#include "tc_common.cuh"

namespace {

template <int kBN>
constexpr int kSmem8 = kStages * (kXTile + Tile<kBN>::kCTile) + 2 * Tile<kBN>::kWTile;  // 151,552 or 112,640 bytes

// This thread's run of kPer weights: code c[e] to bf16((c - bias) * s[e] -
// m[e]), stored at wd.
template <int kM, int kPer>
__device__ __forceinline__ void decode_run(const int8_t* c, const float (&s)[kPer],
                                           const float (&m)[kPer], int bias, unsigned char* wd) {
  uint32_t w[kPer / 2];
#pragma unroll
  for (int e = 0; e < kPer; e += 2) {
    float v0 = __fmul_rn((float)((int)c[e] - bias), s[e]);
    float v1 = __fmul_rn((float)((int)c[e + 1] - bias), s[e + 1]);
    if constexpr (kM != kNone) {
      v0 = __fsub_rn(v0, m[e]);
      v1 = __fsub_rn(v1, m[e + 1]);
    }
    const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
    w[e / 2] = *reinterpret_cast<const uint32_t*>(&p);
  }
#pragma unroll
  for (int h = 0; h < kPer / 8; ++h)
    reinterpret_cast<uint4*>(wd)[h] = uint4{w[4 * h], w[4 * h + 1], w[4 * h + 2], w[4 * h + 3]};
}

struct ArgsTC {
  const __nv_bfloat16* x;  // (B, in) block-minor
  const int8_t* codes;     // (out, in)
  const float* d;          // (out, nd)
  const uint8_t* sc;       // (out, nsub) or null
  const float* dmin;       // (out, nd) or null
  const uint8_t* mn;       // (out, nsub) or null
  float* y;                // (B, out)
  int B, in_f, out_f, nd, nsub, bias;
};

template <int kS, int kM, int kBN>
__global__ void __launch_bounds__(kThreads, kBN == 64 ? 2 : 1)
quant_matmul_8bit_tc_kernel(const ArgsTC a) {
  using T = Tile<kBN>;
  constexpr int kPer = T::kPer;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const xs = smem;                        // kStages x (kBM x kPitch) bf16
  unsigned char* const cs = smem + kStages * kXTile;     // kStages x (kBN x kCPitch) int8
  unsigned char* const ws = cs + kStages * T::kCTile;    // 2 x (kBN x kPitch) bf16
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int sub = a.in_f / a.nsub;   // steps a chunk
  const int steps = a.in_f / kBK;

  // the loads of step i into ring slot i % kStages: 16-byte chunks, 4 of x
  // and 2 (or 1) of codes a thread
  auto load = [&](int i) {
    const int j0 = (i % sub) * a.nsub + (i / sub) * kBK;
    unsigned char* xd = xs + (i % kStages) * kXTile;
    unsigned char* cd = cs + (i % kStages) * T::kCTile;
#pragma unroll
    for (int r = 0; r < kBM * kBK / 8 / kThreads; ++r) {
      const int c = tid + r * kThreads, row = c >> 3, col = (c & 7) * 8;
      const bool ok = m0 + row < a.B;
      cp_async16(xd + (row * kPitch + col) * 2,
                 ok ? a.x + (size_t)(m0 + row) * a.in_f + j0 + col : a.x, ok);
    }
#pragma unroll
    for (int r = 0; r < kBN * kBK / 16 / kThreads; ++r) {
      const int c = tid + r * kThreads, row = c >> 2, col = (c & 3) * 16;
      const bool ok = n0 + row < a.out_f;
      cp_async16(cd + row * kCPitch + col,
                 ok ? a.codes + (size_t)(n0 + row) * a.in_f + j0 + col : a.codes, ok);
    }
  };

  // this thread decodes output row n of the tile, sub-blocks kk0..kk0+kPer-1
  // of each chunk; s and m hold their scales and mins for the current chunk
  const int n = tid % kBN, kk0 = (tid / kBN) * kPer;
  const int o = n0 + n;
  const bool o_ok = o < a.out_f;
  const size_t orow = (size_t)(o_ok ? o : 0);
  const float* drow = a.d + orow * a.nd;
  const uint8_t* scrow = kS == kFlat ? nullptr : a.sc + orow * a.nsub;
  const float* dminrow = kM == kNone ? nullptr : a.dmin + orow * a.nd;
  const uint8_t* mnrow = kM == kHierU8 ? a.mn + orow * a.nsub : nullptr;
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
      if (nx % sub == 0) {   // a new chunk: its scales and mins
        const int k0 = (nx / sub) * kBK + kk0;
        chunk_side<kS>(drow, scrow, k0, a.nd, o_ok, s);
        if constexpr (kM != kNone) chunk_side<kM>(dminrow, mnrow, k0, a.nd, o_ok, m);
      }
      const unsigned char* cp = cs + (nx % kStages) * T::kCTile + n * kCPitch + kk0;
      uint4 q[kPer / 16];
#pragma unroll
      for (int h = 0; h < kPer / 16; ++h) q[h] = *reinterpret_cast<const uint4*>(cp + 16 * h);
      decode_run<kM, kPer>(reinterpret_cast<const int8_t*>(q), s, m, a.bias,
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

// The current device as instance (kS, kM, kBN) reads it, its shared-memory
// opt-in set there to the instance's bytes on first use (CardCache).
template <int kS, int kM, int kBN>
int card_tc(Card& c) {
  static CardCache cards;
  return cards.get(quant_matmul_8bit_tc_kernel<kS, kM, kBN>, kSmem8<kBN>, c);
}

template <int kS, int kM, int kBN>
int launch_tc(const ArgsTC& a, cudaStream_t st) {
  constexpr int smem = kSmem8<kBN>;
  Card c;
  const int rc = card_tc<kS, kM, kBN>(c);
  if (rc != 0) return rc;
  if (smem > c.smem_block) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.B + kBM - 1) / kBM, (a.out_f + kBN - 1) / kBN);
  quant_matmul_8bit_tc_kernel<kS, kM, kBN><<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// 128 output rows a block, or 64 where 128-row tiles would not give every
// SM of the current device a block
template <int kS, int kM>
int launch_tile(const ArgsTC& a, cudaStream_t st) {
  Card c;
  const int rc = card_tc<kS, kM, 128>(c);
  if (rc != 0) return rc;
  const long blocks = (long)((a.B + kBM - 1) / kBM) * ((a.out_f + 127) / 128);
  return a.B <= kBM && blocks < c.sms ? launch_tc<kS, kM, 64>(a, st)
                                      : launch_tc<kS, kM, 128>(a, st);
}

}  // namespace

extern "C" {

// Arguments as lgt_quant_matmul_8bit's: x (B, in) bf16 block-minor; codes
// (out, in) int8; d (out, nd) f32; sc (out, nsub) u8/i8 or null; dmin (out,
// nd) f32 or null; mn (out, nsub) u8 or null -> y (B, out) f32. Needs in %
// 64 == 0, nsub % 64 == 0 and nd % 4 == 0; 16-byte aligned arrays.
int lgt_quant_matmul_8bit_tc(const void* x, const void* codes, const void* d,
                             const void* sc, const void* dmin, const void* mn, void* y,
                             int B, int in_f, int out_f, int nd, int nsub, int bias,
                             int s_side, int m_side, void* stream) {
  if (in_f % kBK || nsub <= 0 || nsub % kBK || in_f % nsub || nd % 4)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || out_f == 0) return 0;
  const ArgsTC a{(const __nv_bfloat16*)x, (const int8_t*)codes, (const float*)d,
                 (const uint8_t*)sc, (const float*)dmin, (const uint8_t*)mn, (float*)y,
                 B, in_f, out_f, nd, nsub, bias};
  const cudaStream_t st = (cudaStream_t)stream;
#define LGT_CASE(S, M) \
  if (s_side == S && m_side == M) return launch_tile<S, M>(a, st);
  LGT_CASE(kFlat, kNone) LGT_CASE(kFlat, kFlat)
  LGT_CASE(kHierU8, kNone) LGT_CASE(kHierU8, kHierU8)
  LGT_CASE(kHierI8, kNone) LGT_CASE(kHierI8, kHierU8)
#undef LGT_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
