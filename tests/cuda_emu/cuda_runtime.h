// A CPU stand-in for the part of the CUDA runtime the port's matmul kernels
// use, so that g++ can compile csrc/quant_matmul.cu and the tests can run it
// on the CPU (tests/test_torch_cuda_emulated.py). Each warp of a launch runs
// as 32 threads; __shfl_xor_sync meets its partners at a barrier. It checks
// the kernels' index arithmetic and rounding, not what nvcc makes of them.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__

using std::max;
using std::min;

struct uint4 { unsigned x, y, z, w; };
struct int4 { int x, y, z, w; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct emu_index { unsigned x, y, z; };
inline thread_local emu_index threadIdx, blockIdx, gridDim;

typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorNotSupported = 801 };
inline int cudaGetLastError() { return 0; }

template <class T> inline T __ldg(const T* p) { return *p; }
// volatile keeps each product and sum rounded to f32 on its own
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }

struct emu_warp { float vals[32]; std::barrier<>* bar; };
inline thread_local int emu_lane;
inline thread_local emu_warp* emu_this_warp;

inline float __shfl_xor_sync(unsigned, float v, int off) {
  emu_this_warp->vals[emu_lane] = v;
  emu_this_warp->bar->arrive_and_wait();
  const float r = emu_this_warp->vals[emu_lane ^ off];
  emu_this_warp->bar->arrive_and_wait();
  return r;
}

// kernel<<<grid, block, smem, stream>>>(args) is rewritten to
// emu_launch(grid, block, smem, stream, [&] { kernel(args); }).
template <class F>
void emu_launch(dim3 grid, int block, int, cudaStream_t, F f) {
  for (unsigned gy = 0; gy < grid.y; ++gy)
    for (unsigned gx = 0; gx < grid.x; ++gx)
      for (int w = 0; w < block / 32; ++w) {
        emu_warp warp;
        std::barrier<> bar(32);
        warp.bar = &bar;
        std::vector<std::thread> lanes;
        for (int l = 0; l < 32; ++l)
          lanes.emplace_back([&, l] {
            threadIdx = {(unsigned)(w * 32 + l), 0, 0};
            blockIdx = {gx, gy, 0};
            gridDim = {grid.x, grid.y, grid.z};
            emu_lane = l;
            emu_this_warp = &warp;
            f();
          });
        for (auto& t : lanes) t.join();
      }
}
