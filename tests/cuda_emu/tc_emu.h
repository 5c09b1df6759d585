// CPU stand-ins for the block-wide parts of CUDA that the tensor-core
// kernels and the decode flash and 8-bit matmul kernels use
// (csrc/quant_matmul_tc.cu, quant_matmul_lowbit_tc.cu,
// quant_matmul_int8_tc.cu, flash_attention_tc.cu, flash_attention.cu,
// quant_matmul.cu), beside cuda_runtime.h's:
// a whole block runs at once, one thread per CUDA thread; __syncthreads
// meets at a block barrier, __shfl_xor_sync at its warp's; dynamic shared
// memory is one buffer a block, filled with 0xff bytes (a bf16 NaN) so that
// a read of a slot nothing wrote shows; a cp.async copy (16 or 4 bytes)
// lands only at the wait_group that covers it; ldmatrix (plain and .trans)
// and mma.sync (bf16, and s8 at k32 and k16) exchange their fragments
// through a warp barrier, laid out as the PTX ISA lays them out. It checks
// the kernels' tiling, ring and index arithmetic, not what nvcc makes of
// them. Blocks run one after another, so an atomicAdd is a plain add, a
// __threadfence does nothing and an __ldcg is a plain load: that holds the
// decode flash kernel's split partials, merge and counter reset, not their
// ordering between blocks running at once.
#pragma once
#include <cstring>
#include <deque>
#include <memory>
#include <thread>
#include <vector>

#include "cuda_bf16.h"
#include "cuda_runtime.h"

struct float4 { float x, y, z, w; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}

struct uint2 { unsigned x, y; };
struct float2 { float x, y; };

inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
// byte i of the result is byte (s >> 4*i) & 7 of the pair {y, x}
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = ((uint64_t)y << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) r |= (uint32_t)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return r;
}

enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class K> inline int cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
// what a launch would use: nothing is compiled for a card here, so no
// registers, no local memory and one block an SM
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
template <class K> inline int cudaFuncGetAttributes(cudaFuncAttributes* fa, K) {
  *fa = {0, 0};
  return 0;
}
template <class K>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return 0;
}
// a card of 4 SMs (grids of fewer than 4 blocks of 128 output rows take the
// 64-row tiles), each with an H100's shared memory, threads and registers
enum cudaDeviceAttr {
  cudaDevAttrMultiProcessorCount = 16,
  cudaDevAttrMaxThreadsPerMultiProcessor = 39,
  cudaDevAttrMaxSharedMemoryPerMultiprocessor = 81,
  cudaDevAttrMaxRegistersPerMultiprocessor = 82,
  cudaDevAttrMaxSharedMemoryPerBlockOptin = 97,
  cudaDevAttrReservedSharedMemoryPerBlock = 111
};
inline int cudaGetDevice(int* dev) { *dev = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr attr, int) {
  switch (attr) {
    case cudaDevAttrMultiProcessorCount: *v = 4; break;
    case cudaDevAttrMaxThreadsPerMultiProcessor: *v = 2048; break;
    case cudaDevAttrMaxSharedMemoryPerMultiprocessor: *v = 233472; break;
    case cudaDevAttrMaxRegistersPerMultiprocessor: *v = 65536; break;
    case cudaDevAttrMaxSharedMemoryPerBlockOptin: *v = 232448; break;
    case cudaDevAttrReservedSharedMemoryPerBlock: *v = 1024; break;
  }
  return 0;
}

struct emu_block {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
  std::vector<unsigned char> smem;
  const unsigned char* addr[32][32];
  uint32_t regs[32][32][6];
};
inline thread_local emu_block* emu_blk;
inline thread_local int emu_tid;

inline unsigned char* emu_smem() { return emu_blk->smem.data(); }
inline void __syncthreads() { emu_blk->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_blk->warp_bar[emu_tid >> 5]->arrive_and_wait();
}

inline int atomicAdd(int* p, int v) { const int old = *p; *p += v; return old; }
inline void __threadfence() {}
template <class T> inline T __ldcg(const T* p) { return *p; }

struct emu_copy { void* dst; const void* src; bool ok; int n; };
inline thread_local std::vector<emu_copy> emu_open;
inline thread_local std::deque<std::vector<emu_copy>> emu_groups;

inline void cp_async16(void* dst, const void* src, bool pred) {
  emu_open.push_back({dst, src, pred, 16});
}
inline void cp_async4(void* dst, const void* src, bool pred) {
  emu_open.push_back({dst, src, pred, 4});
}
inline void cp_async_commit() {
  emu_groups.push_back(std::move(emu_open));
  emu_open.clear();
}
template <int kN> inline void cp_async_wait() {
  while ((int)emu_groups.size() > kN) {
    for (const emu_copy& c : emu_groups.front()) {
      if (c.ok) std::memcpy(c.dst, c.src, c.n);
      else std::memset(c.dst, 0, c.n);
    }
    emu_groups.pop_front();
  }
}

// matrix q's row t/4 comes from the address lane 8q + t/4 gave; lane t takes
// its bytes (t%4)*4 .. +3
inline void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  emu_block* b = emu_blk;
  const int w = emu_tid >> 5, l = emu_tid & 31;
  b->addr[w][l] = static_cast<const unsigned char*>(p);
  b->warp_bar[w]->arrive_and_wait();
  for (int q = 0; q < 4; ++q) std::memcpy(&r[q], b->addr[w][8 * q + l / 4] + (l % 4) * 4, 4);
  b->warp_bar[w]->arrive_and_wait();
}

// matrix q's rows 2*(t%4) and 2*(t%4)+1 come from the addresses lanes
// 8q + 2*(t%4) (+1) gave; lane t takes their b16 element t/4, the first in
// its low half
inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  emu_block* b = emu_blk;
  const int w = emu_tid >> 5, l = emu_tid & 31;
  b->addr[w][l] = static_cast<const unsigned char*>(p);
  b->warp_bar[w]->arrive_and_wait();
  for (int q = 0; q < 4; ++q) {
    uint16_t lo, hi;
    std::memcpy(&lo, b->addr[w][8 * q + 2 * (l % 4)] + 2 * (l / 4), 2);
    std::memcpy(&hi, b->addr[w][8 * q + 2 * (l % 4) + 1] + 2 * (l / 4), 2);
    r[q] = (uint32_t)lo | ((uint32_t)hi << 16);
  }
  b->warp_bar[w]->arrive_and_wait();
}

inline float emu_half(uint32_t reg, int hi) {
  const uint32_t u = (hi ? reg >> 16 : reg & 0xffffu) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

// m16n8k16, A row-major: a[r] holds rows g (+8 for r odd) and columns
// 2*tg, 2*tg+1 (+8 for r >= 2); B col-major: b0 holds rows 2*tg, 2*tg+1
// (b1 +8) of column g; d[e] is row g (+8 for e >= 2), column 2*tg + e%2.
inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  emu_block* b = emu_blk;
  const int w = emu_tid >> 5, l = emu_tid & 31;
  uint32_t* mine = b->regs[w][l];
  for (int i = 0; i < 4; ++i) mine[i] = a[i];
  mine[4] = b0;
  mine[5] = b1;
  b->warp_bar[w]->arrive_and_wait();
  const int g = l >> 2, tg = l & 3;
  for (int e = 0; e < 4; ++e) {
    const int row = g + (e >= 2 ? 8 : 0), col = 2 * tg + (e & 1);
    float sum = d[e];
    for (int k = 0; k < 16; ++k) {
      const float av = emu_half(b->regs[w][(row % 8) * 4 + (k % 8) / 2][row / 8 + 2 * (k / 8)],
                                k % 2);
      const float bv = emu_half(b->regs[w][col * 4 + (k % 8) / 2][4 + k / 8], k % 2);
      sum += av * bv;
    }
    d[e] = sum;
  }
  b->warp_bar[w]->arrive_and_wait();
}

// fma.rn.bf16x2 and sub.rn.bf16x2, each half in double and rounded to bf16
// through f32: one rounding wherever the exact result fits an f32, as it
// does for the 2/4-bit decode kernel's operands (a bf16 scale times a code
// of at most 8 bits; two bf16 weights at most 2^16 apart).
inline uint32_t emu_bf16_op(uint32_t a, uint32_t b, uint32_t c, bool fma) {
  uint32_t r = 0;
  for (int h = 0; h < 2; ++h) {
    const double v = fma ? (double)emu_half(a, h) * emu_half(b, h) + emu_half(c, h)
                         : (double)emu_half(a, h) - emu_half(b, h);
    r |= (uint32_t)__float2bfloat16_rn((float)v).v << (16 * h);
  }
  return r;
}
inline uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) { return emu_bf16_op(a, b, c, true); }
inline uint32_t sub_bf16x2(uint32_t a, uint32_t b) { return emu_bf16_op(a, b, 0, false); }

inline int emu_s8(uint32_t reg, int byte) { return (int)(int8_t)(uint8_t)(reg >> (8 * byte)); }

// m16n8k32 s8: a[r] holds row g (+8 for r odd), bytes 4*tg..+3 (+16 for
// r >= 2); b0 bytes 4*tg..+3 of column g (b1 +16); d as mma_bf16's, each
// the exact int32 sum plus c.
inline void mma_s8_k32(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1, int c) {
  emu_block* b = emu_blk;
  const int w = emu_tid >> 5, l = emu_tid & 31;
  uint32_t* mine = b->regs[w][l];
  for (int i = 0; i < 4; ++i) mine[i] = a[i];
  mine[4] = b0;
  mine[5] = b1;
  b->warp_bar[w]->arrive_and_wait();
  const int g = l >> 2, tg = l & 3;
  for (int e = 0; e < 4; ++e) {
    const int row = g + (e >= 2 ? 8 : 0), col = 2 * tg + (e & 1);
    int sum = c;
    for (int k = 0; k < 32; ++k)
      sum += emu_s8(b->regs[w][(row % 8) * 4 + (k % 16) / 4][row / 8 + 2 * (k / 16)], k % 4)
             * emu_s8(b->regs[w][col * 4 + (k % 16) / 4][4 + k / 16], k % 4);
    d[e] = sum;
  }
  b->warp_bar[w]->arrive_and_wait();
}

// m16n8k16 s8: a0 row g, a1 row g+8, bytes 4*tg..+3; b0 bytes 4*tg..+3 of
// column g.
inline void mma_s8_k16(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0, int c) {
  emu_block* b = emu_blk;
  const int w = emu_tid >> 5, l = emu_tid & 31;
  uint32_t* mine = b->regs[w][l];
  mine[0] = a0;
  mine[1] = a1;
  mine[4] = b0;
  b->warp_bar[w]->arrive_and_wait();
  const int g = l >> 2, tg = l & 3;
  for (int e = 0; e < 4; ++e) {
    const int row = g + (e >= 2 ? 8 : 0), col = 2 * tg + (e & 1);
    int sum = c;
    for (int k = 0; k < 16; ++k)
      sum += emu_s8(b->regs[w][(row % 8) * 4 + k / 4][row / 8], k % 4)
             * emu_s8(b->regs[w][col * 4 + k / 4][4], k % 4);
    d[e] = sum;
  }
  b->warp_bar[w]->arrive_and_wait();
}

// kernel<<<grid, block, smem, stream>>>(args) is rewritten to
// emu_launch_block(grid, block, smem, stream, [&] { kernel(args); }).
template <class F>
void emu_launch_block(dim3 grid, int threads, int smem, cudaStream_t, F f) {
  for (unsigned gz = 0; gz < grid.z; ++gz)
    for (unsigned gy = 0; gy < grid.y; ++gy)
      for (unsigned gx = 0; gx < grid.x; ++gx) {
        emu_block blk;
        blk.bar = std::make_unique<std::barrier<>>(threads);
        std::vector<emu_warp> warps(threads / 32);
        for (int w = 0; w < threads / 32; ++w) {
          blk.warp_bar.push_back(std::make_unique<std::barrier<>>(32));
          warps[w].bar = blk.warp_bar[w].get();
        }
        blk.smem.assign(smem, 0xff);
        std::vector<std::thread> ts;
        for (int t = 0; t < threads; ++t)
          ts.emplace_back([&, t] {
            threadIdx = {(unsigned)t, 0, 0};
            blockIdx = {gx, gy, gz};
            gridDim = {grid.x, grid.y, grid.z};
            emu_tid = t;
            emu_blk = &blk;
            emu_lane = t & 31;
            emu_this_warp = &warps[t >> 5];
            f();
          });
        for (auto& t : ts) t.join();
      }
}
