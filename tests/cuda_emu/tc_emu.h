// CPU stand-ins for the block-wide parts of CUDA that the tensor-core
// kernels and the decode flash and 8-bit matmul kernels use
// (csrc/quant_matmul_tc.cu, quant_matmul_lowbit_tc.cu,
// quant_matmul_int8_tc.cu, flash_attention_tc.cu, flash_attention.cu,
// quant_matmul.cu), beside cuda_runtime.h's:
// a whole block runs at once, one thread per CUDA thread; __syncthreads
// meets at a block barrier, __shfl_xor_sync at its warp's; dynamic shared
// memory is one buffer a block, filled with 0xff bytes (a bf16 NaN) so that
// a read of a slot nothing wrote shows; a cp.async copy (16 or 4 bytes)
// lands only at the wait_group that covers it; mma.sync (bf16, and s8 at
// k32 and k16) exchanges its fragments through a warp barrier, laid out as
// the PTX ISA lays them out. It checks
// the kernels' tiling, ring and index arithmetic, not what nvcc makes of
// them. Blocks run one after another, so an atomicAdd is a plain add, a
// __threadfence does nothing and an __ldcg is a plain load: that holds the
// decode flash kernel's split partials, merge and counter reset, not their
// ordering between blocks running at once.
//
// For the Hopper kernels (quant_matmul_tc.cu, quant_matmul_lowbit_tc.cu,
// quant_matmul_int8_tc.cu, flash_attention_tc.cu):
// an mbarrier is a counter of arrivals and expected bytes with a phase,
// waited on by parity; a TMA tile load (its tensor map from cuda.h's
// stand-in encoder) lands, swizzled by the address bits as the
// hardware swizzles them and with zeros past the array's edge, only when the
// phase that expects its bytes completes; a wgmma (bf16 into f32, or s8 into
// s32 at k32) is queued at its issue and runs at the wait_group that retires
// its group, reading then (not at issue) the A fragment registers of its
// warpgroup's 128 threads and the shared-memory tiles its descriptors name,
// and writing the accumulators then (the s8 one adds to them only with
// scale-d set; the bf16 wgmma_rs with scale-d clear overwrites them), so a
// register or a stage reused before the wait shows; B may be MN-major (the
// flash kernel's V, wgmma_rs_tb). setmaxnreg, the proxy fences and the
// register fences do nothing; bar.sync and bar.arrive with an id meet at a
// barrier of its own; cp.async.mbarrier.arrive lands the thread's copies,
// then arrives; ex2.approx is std::exp2.
#pragma once
#include <condition_variable>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#include "cuda.h"
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

struct emu_tma {
  unsigned char* dst;
  CUtensorMap map;
  int c0, c1;
};
struct emu_mbar {
  int count, pending, phase;
  long expect, issued;
  std::vector<emu_tma> copies;
};

struct emu_block {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
  std::vector<std::unique_ptr<std::barrier<>>> wg_bar;
  std::unique_ptr<std::barrier<>> named[16];
  std::vector<unsigned char> smem_buf;
  unsigned char* smem;   // 1024-byte aligned within smem_buf
  uint32_t regs[32][32][6];
  uint32_t wg_regs[4][128][4];
  std::mutex mu;
  std::condition_variable cv;
  std::map<const void*, emu_mbar> mbars;
};
inline thread_local emu_block* emu_blk;
inline thread_local int emu_tid;

inline unsigned char* emu_smem() { return emu_blk->smem; }
// a shared-memory address: the offset in the block's buffer
inline uint32_t smem_u32(const void* p) {
  return (uint32_t)(static_cast<const unsigned char*>(p) - emu_smem());
}
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


// ---- Hopper: mbarriers, TMA, wgmma ----
#define __grid_constant__

inline void mbar_init(uint64_t* bar, int count) {
  std::lock_guard<std::mutex> lk(emu_blk->mu);
  emu_blk->mbars[bar] = emu_mbar{count, count, 0, 0, 0, {}};
}
inline void mbar_fence_init() {}

// the byte offset in shared memory where a swizzled access to `off` lands:
// the 128-byte mode XORs address bits 4-6 with bits 7-9, the 64-byte mode
// bits 4-5 with bits 7-8
inline int emu_swizzle(int off, int mode) {
  if (mode == CU_TENSOR_MAP_SWIZZLE_128B) return off ^ ((off >> 3) & 0x70);
  if (mode == CU_TENSOR_MAP_SWIZZLE_64B) return off ^ ((off >> 3) & 0x30);
  return off;
}

// with the block's lock held: completes the phase once every arrival and
// every expected byte is in, landing the phase's copies first
inline void emu_mbar_try(emu_mbar& m) {
  if (m.pending > 0 || m.issued < m.expect) return;
  unsigned char* sm = emu_smem();
  for (const emu_tma& c : m.copies) {
    const CUtensorMap& t = c.map;
    const int base = (int)(c.dst - sm);
    for (uint32_t r = 0; r < t.box[1]; ++r)
      for (uint32_t e = 0; e < t.box[0]; ++e) {
        const uint64_t gc = (uint64_t)c.c0 + e, gr = (uint64_t)c.c1 + r;
        const int off = emu_swizzle(base + (int)((r * t.box[0] + e) * t.esize), t.swizzle);
        if (gc < t.dims[0] && gr < t.dims[1])
          std::memcpy(sm + off, t.base + gr * t.stride + gc * t.esize, t.esize);
        else
          std::memset(sm + off, 0, t.esize);
      }
  }
  m.copies.clear();
  m.phase ^= 1;
  m.pending = m.count;
  m.expect = m.issued = 0;
  emu_blk->cv.notify_all();
}

inline void mbar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> lk(emu_blk->mu);
  emu_mbar& m = emu_blk->mbars.at(bar);
  --m.pending;
  emu_mbar_try(m);
}
inline void mbar_arrive_tx(uint64_t* bar, int bytes) {
  std::lock_guard<std::mutex> lk(emu_blk->mu);
  emu_mbar& m = emu_blk->mbars.at(bar);
  m.expect += bytes;
  --m.pending;
  emu_mbar_try(m);
}
inline void mbar_expect_tx(uint64_t* bar, int bytes) {
  std::lock_guard<std::mutex> lk(emu_blk->mu);
  emu_blk->mbars.at(bar).expect += bytes;
}
// the phase of parity `parity` has completed once the current one differs
inline void mbar_wait(uint64_t* bar, int parity) {
  std::unique_lock<std::mutex> lk(emu_blk->mu);
  emu_mbar& m = emu_blk->mbars.at(bar);
  emu_blk->cv.wait(lk, [&] { return m.phase != parity; });
}
inline void tma_load_2d(void* dst, const void* map, int c0, int c1, uint64_t* bar) {
  std::lock_guard<std::mutex> lk(emu_blk->mu);
  emu_mbar& m = emu_blk->mbars.at(bar);
  const CUtensorMap& t = *static_cast<const CUtensorMap*>(map);
  m.copies.push_back({static_cast<unsigned char*>(dst), t, c0, c1});
  m.issued += (long)t.box[0] * t.box[1] * t.esize;
  emu_mbar_try(m);
}

inline void fence_proxy_async() {}
template <int kRegs> inline void setmaxnreg_inc() {}
template <int kRegs> inline void setmaxnreg_dec() {}
inline std::barrier<>* emu_named(int id, int count) {
  std::lock_guard<std::mutex> lk(emu_blk->mu);
  if (!emu_blk->named[id]) emu_blk->named[id] = std::make_unique<std::barrier<>>(count);
  return emu_blk->named[id].get();
}
inline void named_bar_sync(int id, int count) { emu_named(id, count)->arrive_and_wait(); }
inline void named_bar_arrive(int id, int count) { (void)emu_named(id, count)->arrive(); }
// the thread's open cp.async copies land, then one arrival on bar
inline void cp_async_mbar_arrive(uint64_t* bar) {
  for (const emu_copy& c : emu_open) {
    if (c.ok) std::memcpy(c.dst, c.src, c.n);
    else std::memset(c.dst, 0, c.n);
  }
  emu_open.clear();
  mbar_arrive(bar);
}

template <int kN> inline void fence_regs(int (&)[kN]) {}
template <int kN> inline void fence_regs(uint32_t (&)[kN]) {}
template <int kN> inline void fence_regs(float (&)[kN]) {}

// The descriptor of a K-major tile with the 128-byte swizzle as the card's
// wgmma_desc builds it: start address / 16 (here the offset in the block's
// shared memory), leading byte offset 16, stride byte offset 1024, layout 1.
inline uint64_t wgmma_desc(const void* p) {
  const uint64_t off = (uint64_t)(static_cast<const unsigned char*>(p) - emu_smem());
  return ((off & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
// The shared-memory byte offset of byte `kb` (< 32) of row `row` of the
// operand at descriptor desc: rows of 8-row core-matrix groups
// stride-byte-offset apart, each row 128 bytes, then the 128-byte swizzle on
// the address bits (layout 1, the only one these kernels use). A bf16
// element k sits at byte 2k, an s8 one at k.
inline int emu_desc_addr(uint64_t desc, int row, int kb) {
  const int start = (int)(desc & 0x3FFF) << 4, sbo = (int)((desc >> 32) & 0x3FFF) << 4;
  const int addr = start + (row / 8) * sbo + (row % 8) * 128 + kb;
  return (desc >> 62) == 1 ? emu_swizzle(addr, CU_TENSOR_MAP_SWIZZLE_128B) : addr;
}

// The PTX ISA's register fragment of a warpgroup's A for 8-bit types at
// m64nNk32: element (row, k) of the 64 x 32 tile sits in thread 32*(row/16)
// + 4*(row%8) + (k%16)/4 of the warpgroup, register (row%16)/8 + 2*(k/16),
// byte k%4 (each warp's 16 rows as mma.sync's m16n8k32 A).
inline void emu_s8_a_slot(int row, int k, int& thread, int& reg, int& byte) {
  thread = 32 * (row / 16) + 4 * (row % 8) + (k % 16) / 4;
  reg = (row % 16) / 8 + 2 * (k / 16);
  byte = k % 4;
}
// The accumulator fragment of m64nN (f32 or s32): register i of thread th
// of the warpgroup holds (row, col) = (16*(th/32) + (th%32)/4 + 8*((i%4)/2),
// 8*(i/4) + 2*(th%4) + i%2).
inline void emu_acc_at(int th, int i, int& row, int& col) {
  row = 16 * (th / 32) + (th % 32) / 4 + 8 * ((i % 4) / 2);
  col = 8 * (i / 4) + 2 * (th % 4) + i % 2;
}

// The descriptor of an MN-major tile with the 128-byte swizzle as the card's
// wgmma_desc_mn builds it: start address / 16, leading byte offset `lbo`
// (between 64-column panels along n), stride byte offset 1024 (between
// 8-row groups along k), layout 1.
inline uint64_t wgmma_desc_mn(const void* p, int lbo) {
  const uint64_t off = (uint64_t)(static_cast<const unsigned char*>(p) - emu_smem());
  return ((off & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
// The shared-memory byte offset of element (k, n) of a bf16 B operand
// MN-major at descriptor desc (the PTX ISA's canonical 128-byte swizzled
// MN-major layout, CUTLASS's ((64, m), (8, k)) : ((1, LBO), (64, SBO)) in
// elements): row k of n's 64-column atom at (k / 8) * SBO + (k % 8) * 128,
// atom n / 64 at n / 64 * LBO, element n % 64 at 2 * (n % 64), then the
// 128-byte swizzle on the address bits.
inline int emu_desc_addr_mn(uint64_t desc, int k, int n) {
  const int start = (int)(desc & 0x3FFF) << 4, lbo = (int)((desc >> 16) & 0x3FFF) << 4;
  const int sbo = (int)((desc >> 32) & 0x3FFF) << 4;
  const int addr = start + (n / 64) * lbo + (k / 8) * sbo + (k % 8) * 128 + 2 * (n % 64);
  return (desc >> 62) == 1 ? emu_swizzle(addr, CU_TENSOR_MAP_SWIZZLE_128B) : addr;
}

// keep: the accumulators are added to (scale-d set), else overwritten;
// tnsp: B is MN-major (the transpose flag)
struct emu_wgmma { int n; float* d; int* di; const uint32_t* a; uint64_t da, db; int keep, tnsp; };
inline thread_local std::vector<emu_wgmma> emu_wg_open;
inline thread_local std::deque<std::vector<emu_wgmma>> emu_wg_groups;

template <int kAcc>
inline void wgmma_rs(float (&d)[kAcc], const uint32_t (&a)[4], uint64_t db, int scale_d = 1) {
  emu_wg_open.push_back({2 * kAcc, d, nullptr, a, 0, db, scale_d != 0, 0});
}
template <int kAcc> inline void wgmma_rs_tb(float (&d)[kAcc], const uint32_t (&a)[4], uint64_t db) {
  emu_wg_open.push_back({2 * kAcc, d, nullptr, a, 0, db, 1, 1});
}
template <int kAcc> inline void wgmma_ss(float (&d)[kAcc], uint64_t da, uint64_t db) {
  emu_wg_open.push_back({2 * kAcc, d, nullptr, nullptr, da, db, 1, 0});
}
inline void wgmma_s8(int (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  emu_wg_open.push_back({64, nullptr, d, a, (uint64_t)(scale_d != 0), db, 1, 0});
}
// MUFU.EX2 in f32 (the card's approximation differs in the last bits)
inline float ex2_approx(float x) { return std::exp2(x); }
inline void wgmma_fence() {}
inline void wgmma_commit() {
  emu_wg_groups.push_back(std::move(emu_wg_open));
  emu_wg_open.clear();
}

inline float emu_bf16_at(const unsigned char* p) {
  uint16_t h;
  std::memcpy(&h, p, 2);
  return emu_half(h, 0);
}

// One m64nNk16 of the thread's warpgroup, run by all its 128 threads: each
// publishes its A fragment (when A comes from registers) and computes its
// own accumulators, d[4j + e] at row 16w + g (+8 for e >= 2), column 8j + 2t
// + e%2. A's element (row, k) sits in the register of lane 4*(row%8) +
// (k%8)/2 of warp row/16, word (row%16)/8 + 2*(k/8), half k%2 (the m16n8k16
// A fragment).
inline void emu_wgmma_run(const emu_wgmma& op) {
  emu_block* b = emu_blk;
  const int wg = emu_tid >> 7, lt = emu_tid & 127;
  if (op.a) std::memcpy(b->wg_regs[wg][lt], op.a, 16);
  b->wg_bar[wg]->arrive_and_wait();
  const unsigned char* sm = emu_smem();
  if (op.di) {
    // s8 at k32: the exact int32 sums of A (the 8-bit fragment) times B's
    // bytes, added to the accumulators where scale-d (da here) is set, else
    // in place of their earlier values
    for (int i = 0; i < op.n / 2; ++i) {
      int row, col, th, reg, byte;
      emu_acc_at(lt, i, row, col);
      int s = op.da ? op.di[i] : 0;
      for (int k = 0; k < 32; ++k) {
        emu_s8_a_slot(row, k, th, reg, byte);
        s += emu_s8(b->wg_regs[wg][th][reg], byte)
             * (int)(int8_t)sm[emu_desc_addr(op.db, col, k)];
      }
      op.di[i] = s;
    }
    b->wg_bar[wg]->arrive_and_wait();
    return;
  }
  const int w = lt >> 5, g = (lt & 31) >> 2, t = lt & 3;
  for (int j = 0; j < op.n / 8; ++j)
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * w + g + 8 * (e >> 1), col = 8 * j + 2 * t + (e & 1);
      float s = op.keep ? op.d[4 * j + e] : 0.f;
      for (int k = 0; k < 16; ++k) {
        const float av = op.a
            ? emu_half(b->wg_regs[wg][(row / 16) * 32 + (row % 8) * 4 + (k % 8) / 2]
                                 [(row % 16) / 8 + 2 * (k / 8)], k % 2)
            : emu_bf16_at(sm + emu_desc_addr(op.da, row, 2 * k));
        const int bo = op.tnsp ? emu_desc_addr_mn(op.db, k, col) : emu_desc_addr(op.db, col, 2 * k);
        s += av * emu_bf16_at(sm + bo);
      }
      op.d[4 * j + e] = s;
    }
  b->wg_bar[wg]->arrive_and_wait();
}

template <int kN> inline void wgmma_wait() {
  while ((int)emu_wg_groups.size() > kN) {
    for (const emu_wgmma& op : emu_wg_groups.front()) emu_wgmma_run(op);
    emu_wg_groups.pop_front();
  }
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
        blk.smem_buf.assign(smem + 1024, 0xff);
        blk.smem = reinterpret_cast<unsigned char*>(
            (reinterpret_cast<uintptr_t>(blk.smem_buf.data()) + 1023) & ~uintptr_t(1023));
        for (int g = 0; g < threads / 128; ++g)
          blk.wg_bar.push_back(std::make_unique<std::barrier<>>(128));
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
