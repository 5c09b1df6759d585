// Tensor-core path of the 8-bit dequantize + matmul, for prefill-sized row
// counts, for Hopper (sm_90a): wgmma, TMA and mbarriers.
//
// Replaces, from ops/quant_matmul.py's TC_MIN_ROWS activation rows up, the
// TPU body of _make_kernel's 8-bit branch
// (llama_gguf_inference_tpu/ops/pallas_matmul.py:123, its f32 branch
// w = (q - bias)*s - m at :172-192, launched by the pallas_call at :247):
// int8 codes with compact hierarchical scales (Q6_K, IQ4_XS: f32 d per 256
// times an i8 sc per sub-block; Q5_K: u8 sc and mn) or flat ones (Q8_0,
// Q5_0, Q5_1, Q8_1, Q8_K, IQ4_NL). Fewer rows take lgt_quant_matmul_8bit in
// quant_matmul.cu, the decode kernel.
//
// It computes what lgt_quant_matmul_8bit computes:
//   y[b,o] = sum_j x[b,j] * bf16(((float)(c[o,j] - bias) * s_full[j]) - m_full[j])
// s_full[j] = s_sub[j mod nsub] read as side_at reads it (flat: d[o,k];
// hierarchical: d[o, k mod nd] * sc[o,k]), the min side alike; the product
// and the subtract rounded in f32 on their own (__fmul_rn/__fsub_rn), the
// weight rounded once to bf16. A bf16 x bf16 product is exact in f32, so
// this kernel and the plain version differ only in the order of the f32
// sums. The weight carries its own min: no block-sum term.
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
//   output rows; setmaxnreg gives the consumers 208 registers and the
//   producer 88 (2 x 208 + 88 = 3 x 168, the registers a block starts
//   with).
// - A step covers 64 stored positions (wgmma's K of 4 x 16): its x tile (kN
//   rows of 128 bytes) comes by TMA with the 128-byte swizzle that wgmma's
//   B descriptor reads, and its code tile (128 rows x 64 int8, 64-byte
//   swizzle, so the 8 rows a warp reads fall on distinct banks) with it. A
//   ring of 4 to 10 stages (what shared memory holds beside the factor
//   stages), each with a full barrier (the TMA bytes) and an empty one (an
//   arrival from each consumer once its wgmma of the step has completed).
//   A consumer's four wgmmas of a step accumulate into one m64nkN chain;
//   steps alternate two fragment buffers in pairs, so no step decodes into
//   a buffer an unretired wgmma reads (ptxas serializes the wgmmas where a
//   path could).
// - Block-minor order puts sub-block j mod nsub at stored position j, so a
//   step's 64 positions are 64 consecutive sub-blocks. The block walks the
//   row by sub-block chunk: chunk kc covers sub-blocks kc*64..kc*64+63, its
//   sub steps at positions t*nsub + kc*64 (t < sub).
// - The decode (weights as wgmma's A from registers): each consumer thread
//   decodes the 32 weights of its m16n8k16 A fragments (rows g and g+8 of
//   its warp's 16, positions 2t, 2t+1, 2t+8, 2t+9 of each 16) straight into
//   the registers wgmma reads; no weight tile in shared memory, no barrier
//   between decode and products. Its 32 positions are the same sub-blocks
//   in every step of a chunk, so it keeps their factors in registers, read
//   at the chunk's first step from the factor stage. A code byte becomes
//   f32 without I2F: its sign bit flipped (u = c + 128), 2^23 + u laid out
//   by one byte permute, then (2^23 + u) - (2^23 + 128 + bias) = c - bias
//   exactly, times s and minus m each rounded in f32: about 25 instructions
//   a thread for 4 weights. A step decodes into one fragment buffer while
//   the other's wgmma runs.
// - The factor stage, two buffers: the producer's warps 1-3 write a chunk's
//   scale- and min-side values (128 rows x 64 sub-blocks, f32; a flat side
//   by TMA, two 32-column boxes with the 128-byte swizzle; a hierarchical
//   one formed as side_at forms it, 32 sub-blocks of a row a thread, or 16
//   of each side where both are hierarchical) up to two chunks ahead of the
//   consumers, since a fill waits on several rounds of global loads. A
//   buffer goes back to the producer once
//   the chunk's second step has retired its first step's group (so all four
//   warps of each consumer have read their factors).
// - The epilogue stores the accumulators straight from registers: each warp
//   store writes 32-byte runs of 8 consecutive output columns, whole
//   sectors. Ragged rows and columns: TMA fills loads past B or out with
//   zeros, their factors are zero, and only rows < B and columns < out are
//   stored.
// - Needs in % 64 == 0, nsub % 64 == 0 and nd % 4 == 0 (in = 4096 and
//   14336 at sub-blocks of 16 or 32); the wrapper keeps other geometries on
//   the decode kernel.

#include <chrono>

#include "tc_common.cuh"

namespace {

constexpr int kT8M = 128;               // output rows a tile, 64 a consumer warpgroup
constexpr int kT8Threads = 384;         // consumer warpgroups 0 and 1, producer 2
constexpr int kT8Code = kT8M * kBK;     // code tile bytes
constexpr int kT8Side = kT8M * kBK * 4; // one side's factors of a chunk, f32
constexpr int kT8ConsRegs = 208, kT8ProdRegs = 88;

// Shared memory of a block, from a 1024-byte aligned base: the x ring, the
// code ring, two factor stages (each the scale side's values, then the min
// side's, ftab's order), the barriers. The ring takes what the factor
// stages leave of the 232,448 bytes a block may have: 4 stages of 24 KB at
// kN = 128 with a min side (230,496 bytes), 6 without; 6 of 16 KB at kN =
// 64 with a min side, 10 without.
template <int kN, int kM>
struct T8Smem {
  static constexpr int kFac = 2;                           // factor stages
  static constexpr int kFacBytes = (kM == kNone ? 1 : 2) * kT8Side;
  static constexpr int kX = kN * 128;
  // TMA ring: 230,400 is the 232,448 less the alignment pad and barriers
  static constexpr int kStages = (230400 - kFac * kFacBytes) / (kX + kT8Code);
  static constexpr int kCs = kStages * kX;
  static constexpr int kF = kCs + kStages * kT8Code;
  static constexpr int kBar = kF + kFac * kFacBytes;
  static constexpr int kBytes = kBar + (2 * kStages + 2 * kFac) * 8 + 1024;
};

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

// Index of (row, sub-block col) in a factor table, as TMA lays two (128 x
// 32) f32 boxes with the 128-byte swizzle: cols 0-31, then 32-63; row r's
// 16-byte chunk c at chunk c ^ (r mod 8), so a warp's reads of 8 rows at
// one column spread over the banks. 4 cols from a multiple of 4 stay
// together.
__device__ __forceinline__ int ftab(int row, int col) {
  return (col >> 5) * (kT8M * 32) + row * 32 + ((((col & 31) >> 2) ^ (row & 7)) << 2) + (col & 3);
}

// Four codes (bytes of c4, sign bits flipped: c + 128, at positions 2t,
// 2t+1, 2t+8, 2t+9 of a 16-position slice) to two A fragment words, the
// lower position in the lower half: bf16(((2^23 + u) - magic)*s - m), magic
// = 2^23 + 128 + bias.
template <int kM>
__device__ __forceinline__ void decode4(uint32_t c4, const float (&s)[4], const float (&m)[4],
                                        float magic, uint32_t& w0, uint32_t& w1) {
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float c = __int_as_float((int)__byte_perm(c4, 0x4B000000u, 0x7440u | e));
    v[e] = __fmul_rn(__fsub_rn(c, magic), s[e]);
    if constexpr (kM != kNone) v[e] = __fsub_rn(v[e], m[e]);
  }
  w0 = bf16_bits(v[0], v[1]);
  w1 = bf16_bits(v[2], v[3]);
}

template <int kS, int kM, int kN>
__global__ void __launch_bounds__(kT8Threads, 1)
quant_matmul_8bit_tc_kernel(const ArgsTC a, const __grid_constant__ CUtensorMap tmx,
                            const __grid_constant__ CUtensorMap tmc,
                            const __grid_constant__ CUtensorMap tmd,
                            const __grid_constant__ CUtensorMap tmm) {
  using L = T8Smem<kN, kM>;
  extern __shared__ __align__(16) unsigned char smem[];
  // the base rounded up to 1024 bytes by pointer arithmetic on smem, so the
  // compiler keeps every access in the shared window (LDS/STS, not generic)
  unsigned char* const sm = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  uint64_t* const full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* const empty = full + L::kStages;
  uint64_t* const ffull = empty + L::kStages;   // a chunk's factor stage written
  uint64_t* const fempty = ffull + L::kFac;     // both consumers done with it
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);
    }
    for (int f = 0; f < L::kFac; ++f) {
      mbar_init(ffull + f, 3);
      mbar_init(fempty + f, 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int sub = a.in_f / a.nsub;   // steps a chunk
  const int steps = a.in_f / kBK;
  const int chunks = a.nsub / kBK;
  const int tiles_n = (a.B + kN - 1) / kN;
  const int tiles = ((a.out_f + kT8M - 1) / kT8M) * tiles_n;

  if (wg == 2) {
    setmaxnreg_dec<kT8ProdRegs>();
    const int pw = (tid >> 5) & 3;
    if (pw == 0) {
      if (lane == 0) {
        // each step of a tile: x columns j0.. of its kN rows, codes j0.. of
        // its 128 output rows
        int it = 0;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
          const int m0 = (tile / tiles_n) * kT8M, n0 = (tile % tiles_n) * kN;
          for (int i = 0, n = 0, j = 0; i < steps; ++i, ++it) {
            // step n of the chunk at sub-block j: positions n*nsub + j..
            const int st = it % L::kStages;
            const int j0 = n * a.nsub + j;
            if (++n == sub) {
              n = 0;
              j += kBK;
            }
            mbar_wait(empty + st, ((it / L::kStages) & 1) ^ 1);
            mbar_arrive_tx(full + st, L::kX + kT8Code);
            tma_load_2d(sm + st * L::kX, &tmx, j0, n0, full + st);
            tma_load_2d(sm + L::kCs + st * kT8Code, &tmc, j0, m0, full + st);
          }
        }
      }
    } else {
      // a chunk's factor stage, up to kFac chunks ahead of the consumers:
      // the scale and min sides' values of the tile's 128 rows x 64
      // sub-blocks (a flat side by TMA, a hierarchical one 16 a unit)
      const int pt = tid - 256 - 32;
      int ck = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * kT8M;
        for (int kc = 0; kc < chunks; ++kc, ++ck) {
          const int fb = ck % L::kFac;
          float* const fs = reinterpret_cast<float*>(sm + L::kF + fb * L::kFacBytes);
          float* const fm = fs + kT8M * kBK;
          mbar_wait(fempty + fb, ((ck / L::kFac) & 1) ^ 1);
          if (pt == 0 && (kS == kFlat || kM == kFlat)) {
            mbar_expect_tx(ffull + fb, ((kS == kFlat) + (kM == kFlat)) * kT8Side);
            if constexpr (kS == kFlat) {
              tma_load_2d(fs, &tmd, kc * kBK, m0, ffull + fb);
              tma_load_2d(fs + kT8M * 32, &tmd, kc * kBK + 32, m0, ffull + fb);
            }
            if constexpr (kM == kFlat) {
              tma_load_2d(fm, &tmm, kc * kBK, m0, ffull + fb);
              tma_load_2d(fm + kT8M * 32, &tmm, kc * kBK + 32, m0, ffull + fb);
            }
          }
          // a hierarchical side's values, formed as side_at forms them, kU
          // sub-blocks of a row a unit: 32 with one such side, 16 with two,
          // both sides' loads of a unit in flight together
          constexpr bool kHs = kS != kFlat, kHm = kM != kNone && kM != kFlat;
          constexpr int kU = kHs && kHm ? 16 : 32, kUr = kBK / kU;   // units a row
          if (kHs || kHm) {
            for (int u = pt; u < kT8M * kUr; u += 96) {
              const int o = m0 + u / kUr, k0 = kc * kBK + (u % kUr) * kU;
              const bool ok = o < a.out_f;
              const size_t orow = ok ? o : 0;
              float v[kU], w[kU];
              if constexpr (kHs)
                chunk_side<kS, kU>(a.d + orow * a.nd, a.sc + orow * a.nsub, k0, a.nd, ok, v);
              if constexpr (kHm)
                chunk_side<kM, kU>(a.dmin + orow * a.nd, a.mn + orow * a.nsub, k0, a.nd, ok, w);
#pragma unroll
              for (int h = 0; h < kU / 4; ++h) {
                const int at = ftab(u / kUr, (u % kUr) * kU + 4 * h);
                if constexpr (kHs)
                  *reinterpret_cast<float4*>(fs + at) = float4{v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]};
                if constexpr (kHm)
                  *reinterpret_cast<float4*>(fm + at) = float4{w[4 * h], w[4 * h + 1], w[4 * h + 2], w[4 * h + 3]};
              }
            }
          }
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(ffull + fb);
        }
      }
    }
  } else {
    setmaxnreg_inc<kT8ConsRegs>();
    // this thread's A fragment rows: r0 and r0 + 8 of the tile (rows g, g+8
    // of its warp's 16); positions 2t, 2t+1, 2t+8, 2t+9 of each 16
    const int w = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
    const int r0 = wg * 64 + w * 16 + g;
    const uint32_t csel = (t & 1) ? 0x7632u : 0x5410u;
    const float magic = __fadd_rn(8388736.f, (float)a.bias);   // 2^23 + 128 + bias
    float acc[kN / 2];
    uint32_t A0[4][4], A1[4][4];
    float fs[2][4][4], fm[2][4][4];   // factors of (row, slice), positions as the codes
    int it = 0, ck = 0, pend = -1, fdue = -1, n = 0;   // n: the step within its chunk

    // the next step of a tile: on a chunk's first step its factors from the
    // stage; wait for the step's stage, decode its codes into A, start its
    // wgmma group, then retire the group before it: its stage goes back to
    // the producer, and so does a factor stage whose chunk's first step
    // that group was
    auto step = [&](uint32_t (&A)[4][4]) {
      const int st = it % L::kStages;
      const bool first = n == 0;
      if (++n == sub) n = 0;
      if (first) {
        const int fb = ck % L::kFac;
        mbar_wait(ffull + fb, (ck / L::kFac) & 1);
        const float* const ss = reinterpret_cast<const float*>(sm + L::kF + fb * L::kFacBytes);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int at = ftab(r0 + 8 * r, 16 * kk + 8 * h + 2 * t);
              const float2 s2 = *reinterpret_cast<const float2*>(ss + at);
              fs[r][kk][2 * h] = s2.x;
              fs[r][kk][2 * h + 1] = s2.y;
              if constexpr (kM != kNone) {
                const float2 m2 = *reinterpret_cast<const float2*>(ss + kT8M * kBK + at);
                fm[r][kk][2 * h] = m2.x;
                fm[r][kk][2 * h + 1] = m2.y;
              }
            }
      }
      mbar_wait(full + st, (it / L::kStages) & 1);
      const unsigned char* const ct = sm + L::kCs + st * kT8Code;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // bytes 2t, 2t+1 (word t/2) and 2t+8, 2t+9 (word 2 + t/2) of the
          // row's 16-byte chunk kk, swizzled
          const unsigned char* p = ct + row * kBK + ((kk ^ ((row >> 1) & 3)) << 4) + ((t >> 1) << 2);
          const uint32_t lo = *reinterpret_cast<const uint32_t*>(p);
          const uint32_t hi = *reinterpret_cast<const uint32_t*>(p + 8);
          decode4<kM>(__byte_perm(lo, hi, csel) ^ 0x80808080u, fs[r][kk], fm[r][kk], magic,
                      A[kk][r], A[kk][2 + r]);
        }
      }
      wgmma_fence();
      const uint64_t dx = wgmma_desc(sm + st * L::kX);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, A[kk], dx + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();
      if ((tid & 127) == 0) {
        if (pend >= 0) mbar_arrive(empty + pend);
        if (fdue >= 0) mbar_arrive(fempty + fdue);
      }
      pend = st;
      fdue = first ? ck % L::kFac : -1;
      ck += first;
      ++it;
    };

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * kT8M, n0 = (tile % tiles_n) * kN;
#pragma unroll
      for (int e = 0; e < kN / 2; ++e) acc[e] = 0.f;
      // pairs of steps, one buffer each; an odd last step decodes into A0,
      // whose wgmma the pair before has retired (a step that could decode
      // into a buffer an unretired wgmma reads makes ptxas serialize them)
      for (int i = 0; i + 1 < steps; i += 2) {
        step(A0);
        step(A1);
      }
      if (steps & 1) step(A0);
      wgmma_wait<0>();
      if ((tid & 127) == 0) {
        if (pend >= 0) mbar_arrive(empty + pend);
        if (fdue >= 0) mbar_arrive(fempty + fdue);
      }
      pend = fdue = -1;

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
template <int kS, int kM, int kN>
int tensor_maps(const ArgsTC& a, CUtensorMap (&tm)[4]) {
  int rc = tensor_map(&tm[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.x, a.in_f, a.B, kBK, kN,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = tensor_map(&tm[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.codes, a.in_f, a.out_f, kBK,
                    kT8M, CU_TENSOR_MAP_SWIZZLE_64B);
  tm[2] = tm[3] = tm[0];
  if (rc == 0 && kS == kFlat)
    rc = tensor_map(&tm[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.d, a.nd, a.out_f, 32, kT8M,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0 && kM == kFlat)
    rc = tensor_map(&tm[3], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.dmin, a.nd, a.out_f, 32, kT8M,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  return rc;
}

// kN activation rows a tile: 64 for at most 64 rows, else 128. The grid is
// the tiles, at most one block an SM of the current device. With plan set,
// fills it instead of launching: grid (x, y), threads, shared memory,
// registers, local bytes, blocks an SM, kN, and the host's ns to build the
// tensor maps (the mean of 64 builds over a stand-in address).
template <int kS, int kM, int kN>
int launch_t8(const ArgsTC& a, cudaStream_t st, int* plan) {
  using L = T8Smem<kN, kM>;
  const auto kernel = quant_matmul_8bit_tc_kernel<kS, kM, kN>;
  static CardCache cards;
  Card c;
  int rc = cards.get(kernel, 0, c);
  if (rc != 0) return rc;
  if (L::kBytes > c.smem_block) return (int)cudaErrorInvalidValue;
  const int tiles = ((a.out_f + kT8M - 1) / kT8M) * ((a.B + kN - 1) / kN);
  const int grid = tiles < c.sms ? tiles : c.sms;
  CUtensorMap tm[4];
  if (plan != nullptr) {
    cudaFuncAttributes fa;
    rc = (int)cudaFuncGetAttributes(&fa, kernel);
    if (rc != 0) return rc;
    int per_sm = 0;
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kT8Threads,
                                                            L::kBytes);
    if (rc != 0) return rc;
    const uintptr_t stand_in = uintptr_t{1} << 20;
    ArgsTC s = a;
    s.x = reinterpret_cast<const __nv_bfloat16*>(stand_in);
    s.codes = reinterpret_cast<const int8_t*>(stand_in);
    s.d = s.dmin = reinterpret_cast<const float*>(stand_in);
    const auto t0 = std::chrono::steady_clock::now();
    for (int i = 0; rc == 0 && i < 64; ++i) rc = tensor_maps<kS, kM, kN>(s, tm);
    if (rc != 0) return rc;
    const long ns = (long)std::chrono::duration_cast<std::chrono::nanoseconds>(
                        std::chrono::steady_clock::now() - t0).count() / 64;
    const int v[9] = {grid, 1, kT8Threads, L::kBytes, fa.numRegs, (int)fa.localSizeBytes, per_sm,
                      kN, (int)ns};
    for (int i = 0; i < 9; ++i) plan[i] = v[i];
    return 0;
  }
  rc = tensor_maps<kS, kM, kN>(a, tm);
  if (rc != 0) return rc;
  quant_matmul_8bit_tc_kernel<kS, kM, kN><<<grid, kT8Threads, L::kBytes, st>>>(a, tm[0], tm[1], tm[2], tm[3]);
  return (int)cudaGetLastError();
}

template <int kS, int kM>
int launch_tile(const ArgsTC& a, cudaStream_t st, int* plan) {
  if (a.B <= 64) return launch_t8<kS, kM, 64>(a, st, plan);
  return launch_t8<kS, kM, 128>(a, st, plan);
}

int run(const void* x, const void* codes, const void* d, const void* sc, const void* dmin,
        const void* mn, void* y, int B, int in_f, int out_f, int nd, int nsub, int bias,
        int s_side, int m_side, void* stream, int* plan) {
  if (in_f % kBK || nsub <= 0 || nsub % kBK || in_f % nsub || nd <= 0 || nd % 4)
    return (int)cudaErrorInvalidValue;
  if (plan == nullptr && (B == 0 || out_f == 0)) return 0;
  const ArgsTC a{(const __nv_bfloat16*)x, (const int8_t*)codes, (const float*)d,
                 (const uint8_t*)sc, (const float*)dmin, (const uint8_t*)mn, (float*)y,
                 B, in_f, out_f, nd, nsub, bias};
  const cudaStream_t st = (cudaStream_t)stream;
#define LGT_CASE(S, M) \
  if (s_side == S && m_side == M) return launch_tile<S, M>(a, st, plan);
  LGT_CASE(kFlat, kNone) LGT_CASE(kFlat, kFlat)
  LGT_CASE(kHierU8, kNone) LGT_CASE(kHierU8, kHierU8)
  LGT_CASE(kHierI8, kNone) LGT_CASE(kHierI8, kHierU8)
#undef LGT_CASE
  return (int)cudaErrorInvalidValue;
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
  return run(x, codes, d, sc, dmin, mn, y, B, in_f, out_f, nd, nsub, bias, s_side, m_side, stream,
             nullptr);
}

// The launch a call of B rows would make, into info[9]: grid (x, y),
// threads, dynamic shared memory, registers (at the kernel's entry, before
// setmaxnreg), local bytes, resident blocks an SM, activation rows a tile,
// and the host's ns to build its tensor maps.
int lgt_quant_matmul_8bit_tc_plan(int B, int in_f, int out_f, int nsub, int s_side, int m_side,
                                  int* info) {
  const int nd = s_side == kFlat ? nsub : in_f / 256;
  return run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, B, in_f, out_f, nd,
             nsub, 0, s_side, m_side, nullptr, info);
}

}  // extern "C"
