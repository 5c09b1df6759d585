// How one side (scale or min) of a weight is stored, and its value at one
// sub-block: shared by every matmul kernel of csrc/ (quant_matmul.cu, and
// through tc_common.cuh the tensor-core ones).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Side : int { kNone = 0, kFlat = 1, kHierU8 = 2, kHierI8 = 3 };

// Value of sub-block k on one side: a flat side's f32 array at k; a
// hierarchical side's f32 array at kb = k mod (its width) times the 8-bit
// sub-block factor sub[k].
template <int kSide>
__device__ __forceinline__ float side_at(const float* base, const uint8_t* sub, int k, int kb) {
  const float b = __ldg(base + (kSide == kFlat ? k : kb));
  if constexpr (kSide == kHierU8) return __fmul_rn(b, (float)__ldg(sub + k));
  if constexpr (kSide == kHierI8) return __fmul_rn(b, (float)(int8_t)__ldg(sub + k));
  return b;
}

}  // namespace
