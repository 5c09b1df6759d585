// Fused dequantize + matmul over repacked quantized weights, for Hopper.
//
// Replaces two Pallas TPU kernels of llama_gguf_inference_tpu/ops/pallas_matmul.py:
//
//   lgt_quant_matmul_4bit  <- _make_kernel_fsplit (via _quant_matmul_2d_xsum,
//                             kern="fsplit"): 4-bit planar-nibble codes with a
//                             flat f32 scale and min per 32-element sub-block
//                             (Q4_K under the default scale layout).
//   lgt_quant_matmul_8bit  <- _make_kernel (via _quant_matmul_2d): int8 codes
//                             with compact hierarchical scales (Q6_K: f32 d per
//                             256, int8 sc per 16) or flat ones (Q8_0). The
//                             asymmetric 8-bit formats (dmin/mn) are not loaded
//                             by this package, so their min term is left out.
//
// Both read the arrays the JAX kernels read, in the same block-minor element
// order (quant/repack.py block_minor_perm): stored position j of a row holds
// sub-block (j mod nsub), so a 16-byte code load meets a contiguous run of
// per-sub-block scales, and the activations arrive pre-permuted by the caller.
//
// 4-bit:  y[b,o] = sum_j x[b,j]   * bf16(lo(c[o,j]) * d[o, j mod nsub])
//                + sum_j x[b,j+h] * bf16(hi(c[o,j]) * d[o, j mod nsub])
//                - sum_s xsum[b,s] * m[o,s]                 (h = in/2)
// 8-bit:  y[b,o] = sum_j x[b,j] * bf16((c[o,j] - bias) * s_full[j])
//         s_sub[k] = d[o, k mod nd] * sc[o,k] (k < nsub), s_full[j] = s_sub[j mod nsub]
//         (tiles, not repeat-interleave: that is what pltpu.repeat does).
// Products are rounded to bf16 where the TPU kernel rounds them, sums run in
// f32, and the scale arithmetic uses __fmul_rn/__fsub_rn so nvcc cannot fuse
// it into an FMA the reference does not do.
//
// What bounds them on the card: at decode (a handful of activation rows)
// both stream their weight bytes once, 0.75 B per weight for flat Q4_K and
// about 1.08 B for compact Q6_K, so device-memory bandwidth bounds them.
// Design: one warp per output row, lanes walking the row in 16-byte code
// loads (coalesced, 512 bytes per warp step), the dequantized run held in
// registers and applied to up to 8 activation rows at once; a second grid
// axis tiles further activation rows, so any row count works (prefill
// re-reads the weights from L2 once per 8 rows: right, not yet fast).
// Tensor cores, TMA and a shared-memory weight ring are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;   // output rows per block, one warp each
constexpr int kRows = 8;    // activation rows per block

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 16 consecutive bf16 at a 32-byte aligned address -> f32.
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

__global__ void quant_matmul_4bit_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ xsum,
    const uint8_t* __restrict__ codes, const float* __restrict__ d,
    const float* __restrict__ m, float* __restrict__ y,
    int B, int in_f, int out_f, int nsub) {
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int b0 = blockIdx.y * kRows;
  if (o >= out_f) return;  // warp-uniform; the kernel has no block barrier
  const int nb = min(kRows, B - b0);
  const int h = in_f >> 1;
  const uint8_t* crow = codes + (size_t)o * h;
  const float* drow = d + (size_t)o * nsub;
  const float* mrow = m + (size_t)o * nsub;

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  for (int j0 = lane * 16; j0 < h; j0 += 32 * 16) {
    const uint4 c4 = __ldg(reinterpret_cast<const uint4*>(crow + j0));
    const uint8_t* c = reinterpret_cast<const uint8_t*>(&c4);
    float wlo[16], whi[16];
    int s = j0 % nsub;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float sc = __ldg(drow + s);
      wlo[k] = bf16_round(__fmul_rn((float)(c[k] & 0xF), sc));
      whi[k] = bf16_round(__fmul_rn((float)(c[k] >> 4), sc));
      if (++s == nsub) s = 0;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nb) {
        const __nv_bfloat16* xr = x + (size_t)(b0 + r) * in_f;
        float xl[16], xh[16];
        load_bf16x16(xr + j0, xl);
        load_bf16x16(xr + h + j0, xh);
        float a = acc[r];
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          a = fmaf(xl[k], wlo[k], a);
          a = fmaf(xh[k], whi[k], a);
        }
        acc[r] = a;
      }
    }
  }
  for (int r = 0; r < nb; ++r) {
    const float* xs = xsum + (size_t)(b0 + r) * nsub;
    float t = 0.f;
    for (int s = lane; s < nsub; s += 32) t = fmaf(xs[s], __ldg(mrow + s), t);
    const float dot = warp_sum(acc[r]);
    const float mdot = warp_sum(t);
    if (lane == 0) y[(size_t)(b0 + r) * out_f + o] = dot - mdot;
  }
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

// x (B, in) bf16 block-minor; xsum (B, nsub) f32; codes (out, in/2) u8;
// d, m (out, nsub) f32 -> y (B, out) f32. in % 32 == 0, 16-byte aligned.
int lgt_quant_matmul_4bit(const void* x, const void* xsum, const void* codes,
                          const void* d, const void* m, void* y, int B,
                          int in_f, int out_f, int nsub, void* stream) {
  const dim3 grid((out_f + kWarps - 1) / kWarps, (B + kRows - 1) / kRows);
  quant_matmul_4bit_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)xsum, (const uint8_t*)codes,
      (const float*)d, (const float*)m, (float*)y, B, in_f, out_f, nsub);
  return (int)cudaGetLastError();
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
