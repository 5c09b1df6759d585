// The code -> value maps of the 4-bit codes (ops/linear.py code_values),
// shared by the decode kernels (quant_matmul.cu) and the tensor-core 2/4-bit
// kernel (quant_matmul_lowbit_tc.cu).
#pragma once

#include <cuda_runtime.h>

namespace {

enum Map : int { kIdentity = 0, kIq2 = 1, kIq3 = 2 };

// The sign|magnitude alphabets of the 4-bit IQ2/IQ3 codes, shifts and adds
// only, as the JAX package computes them.
template <int kMap>
__device__ __forceinline__ int code_value(int q) {
  if constexpr (kMap == kIq2) {
    const int e = q & 14;
    return ((e << 4) + e) - ((q & 1) << 1) - 118;
  } else if constexpr (kMap == kIq3) {
    const int c = q & 7;
    const int m = (c << 3) + 4 + ((((c + 1) >> 3) & 1) << 1);
    const int neg = -(q >> 3);
    return (m ^ neg) - neg;
  } else {
    return q;
  }
}

}  // namespace
