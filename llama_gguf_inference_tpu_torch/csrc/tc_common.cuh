// What the tensor-core kernels share (quant_matmul_tc.cu, 8-bit codes;
// quant_matmul_lowbit_tc.cu, 2- and 4-bit codes; quant_matmul_int8_tc.cu,
// int8 activations; flash_attention_tc.cu, prefill attention): the matmuls'
// block tile, the inline PTX (cp.async, ldmatrix, mma.sync), the scale
// side's loads and the products of one step. Each kernel keeps its own
// loads, decode stage and epilogue. The decode flash kernel
// (flash_attention.cu) takes only its cp.async helpers.
//
// A block of 8 warps owns kBM = 128 activation rows by kBN = 128 or 64
// output rows and walks 64 positions of x a step; x and the decoded bf16
// weight tile sit in shared memory with rows padded to 144 bytes, so the 8
// rows an ldmatrix reads fall on distinct banks.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "side.cuh"

namespace {

constexpr int kBM = 128;        // activation rows a block
constexpr int kBK = 64;         // positions of x a step
constexpr int kStages = 4;      // cp.async ring of x tiles
constexpr int kThreads = 256;   // 8 warps
constexpr int kPitch = kBK + 8;         // bf16 a row of the x and weight tiles (144 bytes)
constexpr int kCPitch = kBK + 16;       // bytes a row of a code tile (80)
constexpr int kXTile = kBM * kPitch * 2;

// The tile geometry of kBN output rows a block (128 or 64): the warps split
// 2 x 4 (64 x 32 outputs each) or 4 x 2 (32 x 32); a thread decodes kPer
// weights of one output row a step.
template <int kBN>
struct Tile {
  static constexpr int kCTile = kBN * kCPitch;
  static constexpr int kWTile = kBN * kPitch * 2;
  static constexpr int kPer = kBN * kBK / kThreads;                       // 32 or 16
  static constexpr int kWarpsN = kBN / 32;
  static constexpr int kWarpM = kBM / (kThreads / 32 / kWarpsN);           // 64 or 32 rows a warp
  static constexpr int kMT = kWarpM / 16;                                  // m16 tiles a warp
};

// PTX: the only inline assembly of the tensor-core kernels.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, asynchronously; zeros when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(pred ? 16 : 0));
}

// 4 bytes from global to shared memory, asynchronously; zeros when !pred.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kN>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kN));
}

// Four 8x8 bf16 matrices; lanes 8q..8q+7 give the row addresses of matrix q.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// The same, each matrix transposed: lane t takes elements (2*(t%4), t/4)
// and (2*(t%4)+1, t/4) of each, so a row-major [k][n] tile gives mma's B
// fragments.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d = a (16x32 s8, row) * b (32x8 s8, col) + c, exact int32 sums; the
// fragments hold the same bytes as mma_bf16's at m16n8k16.
__device__ __forceinline__ void mma_s8_k32(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                           uint32_t b1, int c) {
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(c));
}

// d = a (16x16 s8, row) * b (16x8 s8, col) + c: the first half of the k32
// fragments (a0, a1 and b0), or the second (a2, a3 and b1).
__device__ __forceinline__ void mma_s8_k16(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0,
                                           int c) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
               "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(a0), "r"(a1), "r"(b0), "r"(c));
}

// Two bf16 at once: d = a * b + c, the exact result rounded once to bf16.
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Two bf16 at once: d = a - b, the exact result rounded once to bf16.
__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// end PTX

// Sub-blocks k0..k0+kPer-1 of one side of a row, as side_at reads them,
// into v. The 8-bit factors and the f32 values come in 16-byte loads, all
// issued before any is used; the f32 ones 4 at a time, which never wrap the
// super-blocks (nd % 4 == 0 and k0 % 4 == 0). Zeros for a row past out.
template <int kSide, int kPer>
__device__ __forceinline__ void chunk_side(const float* base, const uint8_t* sub, int k0, int nd,
                                           bool ok, float (&v)[kPer]) {
  float4 f[kPer / 4];
  uint4 b[kPer / 16];
#pragma unroll
  for (int q = 0; q < kPer / 4; ++q) {
    const int kb = kSide == kFlat ? k0 + 4 * q : (k0 + 4 * q) % nd;
    f[q] = ok ? __ldg(reinterpret_cast<const float4*>(base + kb)) : float4{0.f, 0.f, 0.f, 0.f};
  }
  if constexpr (kSide != kFlat) {
#pragma unroll
    for (int h = 0; h < kPer / 16; ++h)
      b[h] = ok ? __ldg(reinterpret_cast<const uint4*>(sub + k0) + h) : uint4{0, 0, 0, 0};
  }
  const float* fv = reinterpret_cast<const float*>(f);
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    if constexpr (kSide == kHierU8)
      v[e] = __fmul_rn(fv[e], (float)reinterpret_cast<const uint8_t*>(b)[e]);
    else if constexpr (kSide == kHierI8)
      v[e] = __fmul_rn(fv[e], (float)reinterpret_cast<const int8_t*>(b)[e]);
    else
      v[e] = fv[e];
  }
}

// The products of one step: the warp's kMT x 4 m16n8 accumulator tiles
// (rows wm.., columns wn..) += the x tile xt (rows x 64 positions) times the
// weight tile wt (output rows x 64 positions), both bf16 row-major at kPitch.
template <int kMT>
__device__ __forceinline__ void step_products(float (&acc)[kMT][4][4], const unsigned char* xt,
                                              const unsigned char* wt, int wm, int wn, int lane) {
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t b[4][2];
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      const int row = wn + np * 16 + (lane & 7) + ((lane >> 4) << 3);
      const int col = kk + ((lane >> 3) & 1) * 8;
      uint32_t r[4];
      ldmatrix_x4(r, wt + (row * kPitch + col) * 2);
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      uint32_t af[4];
      ldmatrix_x4(af, xt + ((wm + mt * 16 + (lane & 15)) * kPitch + kk + (lane >> 4) * 8) * 2);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af, b[nt][0], b[nt][1]);
    }
  }
}

}  // namespace
