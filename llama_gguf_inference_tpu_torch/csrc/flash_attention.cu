// Causal flash attention over the offset-indexed bf16 KV cache, for Hopper.
//
// Replaces the Pallas TPU kernel _flash_jit (with its body _flash_step) of
// llama_gguf_inference_tpu/ops/flash_attention.py.
//
//   q (B, T, H, D) bf16, k/v caches (B, KVH, S, D) bf16, offsets (B,) int32
//   -> out (B, T, H, D) bf16
//
// Query t of sequence b sees cache slots s <= offsets[b] + t. GQA folds the
// group of query heads sharing a KV head into rows r = g*T + t of one block
// column (the (g, t) row order of the reference). The running max, sum and
// output accumulator are f32; q is pre-scaled by 1/sqrt(D); masked scores
// are -1e30 (not -inf), and the output is acc / max(l, 1e-30), as in the
// reference. Blocks stop at the last key any of their rows can see, so cost
// follows the live context, not the allocated S.
//
// What bounds it on the card: at decode each layer reads the live K and V
// once (4 MB per sequence at 1024 live tokens for 8 KV heads of 128), so
// device-memory bandwidth bounds it. Design: one block per (b, kv head, 4
// query rows), one warp per row. K and V tiles of BS keys are staged in
// shared memory once per block and read by every row of the GQA group; the
// K tile rows are padded by one 32-bit word so that lane i reading key i
// hits bank i. Scores: each lane owns keys (no shuffles per key); P.V: each
// lane owns D/32 output dims. Decode has only B*KVH blocks, so one SM walks
// each sequence's whole cache: splitting S across blocks is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // query rows per block, one warp each

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int D, int BS>
__global__ void flash_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ offsets,
    __nv_bfloat16* __restrict__ out, int T, int H, int KVH, int S, float scale) {
  constexpr int KP = D + 2;     // padded K row, in bf16 elements
  constexpr int DPL = D / 32;   // output dims per lane
  constexpr int KPL = BS / 32;  // keys per lane per tile
  __shared__ __align__(16) __nv_bfloat16 ks[BS * KP];
  __shared__ __align__(16) __nv_bfloat16 vs[BS * D];
  __shared__ float qs[kWarps][D];
  __shared__ float ps[kWarps][BS];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int group = H / KVH;
  const int R = group * T;
  const int r = blockIdx.x * kWarps + warp;
  const bool active = r < R;
  const int t = active ? r % T : 0;
  const int head = kvh * group + (active ? r / T : 0);
  const int off = offsets[b];
  const int limit = off + t;  // last visible slot of this row

  int tmax = 0;  // last key any row of this block can see
  for (int w = 0; w < kWarps; ++w) {
    const int rr = blockIdx.x * kWarps + w;
    if (rr < R) tmax = max(tmax, rr % T);
  }
  const int n_tiles = min(S - 1, off + tmax) / BS + 1;

  if (active) {
    const __nv_bfloat16* qr = q + (((size_t)b * T + t) * H + head) * D;
    for (int e = lane; e < D; e += 32) qs[warp][e] = __bfloat162float(qr[e]) * scale;
  }
  const size_t kv_base = ((size_t)b * KVH + kvh) * (size_t)S * D;
  const __nv_bfloat16* kb = k + kv_base;
  const __nv_bfloat16* vb = v + kv_base;

  float m_i = -1e30f, l_i = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int s0 = tile * BS;
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int i = threadIdx.x; i < BS * D / 8; i += kWarps * 32) {
      const int row = i / (D / 8), col = (i % (D / 8)) * 8;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (s0 + row < S) {
        kv4 = __ldg(reinterpret_cast<const uint4*>(kb + (size_t)(s0 + row) * D + col));
        vv4 = __ldg(reinterpret_cast<const uint4*>(vb + (size_t)(s0 + row) * D + col));
      }
      *reinterpret_cast<uint4*>(vs + row * D + col) = vv4;
      uint32_t* kd = reinterpret_cast<uint32_t*>(ks + row * KP + col);
      kd[0] = kv4.x;
      kd[1] = kv4.y;
      kd[2] = kv4.z;
      kd[3] = kv4.w;
    }
    __syncthreads();
    if (!active || s0 > limit) continue;  // warp-uniform

    float sc[KPL];
    float tile_max = -1e30f;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int s = j * 32 + lane;
      const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(ks + s * KP);
      float dot = 0.f;
#pragma unroll 8
      for (int e2 = 0; e2 < D / 2; ++e2) {
        const float2 kf = __bfloat1622float2(kr[e2]);
        dot = fmaf(qs[warp][2 * e2], kf.x, dot);
        dot = fmaf(qs[warp][2 * e2 + 1], kf.y, dot);
      }
      const int pos = s0 + s;
      sc[j] = (pos <= limit && pos < S) ? dot : -1e30f;
      tile_max = fmaxf(tile_max, sc[j]);
    }
    const float m_new = fmaxf(m_i, warp_max(tile_max));
    const float alpha = expf(m_i - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const float p = expf(sc[j] - m_new);
      ps[warp][j * 32 + lane] = p;
      psum += p;
    }
    l_i = l_i * alpha + warp_sum(psum);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
    for (int s = 0; s < BS; ++s) {
      const float p = ps[warp][s];
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        acc[i] = fmaf(p, __bfloat162float(vs[s * D + lane + 32 * i]), acc[i]);
    }
    m_i = m_new;
    __syncwarp();  // ps is rewritten by the next tile
  }
  if (active) {
    __nv_bfloat16* orow = out + (((size_t)b * T + t) * H + head) * D;
    const float l = fmaxf(l_i, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) orow[lane + 32 * i] = __float2bfloat16_rn(acc[i] / l);
  }
}

template <int D, int BS>
int launch(const void* q, const void* k, const void* v, const void* offsets,
           void* out, int B, int T, int H, int KVH, int S, float scale,
           cudaStream_t stream) {
  const int R = (H / KVH) * T;
  const dim3 grid((R + kWarps - 1) / kWarps, KVH, B);
  flash_attention_kernel<D, BS><<<grid, kWarps * 32, 0, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const int*)offsets, (__nv_bfloat16*)out, T, H, KVH, S, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lgt_flash_attention(const void* q, const void* k, const void* v,
                                   const void* offsets, void* out, int B, int T,
                                   int H, int KVH, int S, int D, float scale,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64: return launch<64, 128>(q, k, v, offsets, out, B, T, H, KVH, S, scale, st);
    case 128: return launch<128, 64>(q, k, v, offsets, out, B, T, H, KVH, S, scale, st);
    case 256: return launch<256, 32>(q, k, v, offsets, out, B, T, H, KVH, S, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
