// The element rules of the 2/4-bit kernels: how a code and its sub-block's
// scale and min become one bf16 weight, for each TPU body. One definition,
// shared by the decode kernel (quant_matmul.cu) and the tensor-core kernel
// (quant_matmul_lowbit_tc.cu).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "code_value.cuh"
#include "side.cuh"

namespace {

// The element rule of a 2/4-bit instance: which TPU body it follows.
enum Var : int { kFsplit = 0, kXsum = 1, kSplit = 2, kBase = 3, kBaseF32 = 4 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The per-sub-block factors (s, m) of the element rule of kVar from the
// scale side's value sv and the min side's mv (read where kM != kNone).
template <int kVar, int kM>
__device__ __forceinline__ void rule_factors(float sv, float mv, int bias, float& s, float& m) {
  if constexpr (kVar == kFsplit) {
    s = sv;
  } else if constexpr (kVar == kXsum || kVar == kSplit) {
    s = bf16_round(sv);
  } else if constexpr (kVar == kBase) {
    // m' = m + bias*s in f32, then both rounded to bf16 (:171, :194-195)
    float mp = __fmul_rn((float)bias, sv);
    if constexpr (kM != kNone) mp = __fadd_rn(mv, mp);
    s = bf16_round(sv);
    m = bf16_round(mp);
  } else {
    s = sv;
    if constexpr (kM != kNone) m = mv;
  }
}

// The same, reading both sides of sub-block k (kd = k mod nd) in the row.
template <int kVar, int kS, int kM>
__device__ __forceinline__ void sub_factors(const float* drow, const uint8_t* scrow,
                                            const float* dminrow, const uint8_t* mnrow,
                                            int bias, int k, int kd, float& s, float& m) {
  const float sv = side_at<kS>(drow, scrow, k, kd);
  float mv = 0.f;
  if constexpr ((kVar == kBase || kVar == kBaseF32) && kM != kNone)
    mv = side_at<kM>(dminrow, mnrow, k, kd);
  rule_factors<kVar, kM>(sv, mv, bias, s, m);
}

template <int kVar, int kM, int kMap>
__device__ __forceinline__ float element(int c, float s, float m, int bias) {
  if constexpr (kVar == kFsplit) {
    return bf16_round(__fmul_rn((float)code_value<kMap>(c), s));
  } else if constexpr (kVar == kXsum || kVar == kSplit) {
    return bf16_round(__fmul_rn((float)c, s));
  } else if constexpr (kVar == kBase) {
    return bf16_round(__fsub_rn(bf16_round(__fmul_rn((float)c, s)), m));
  } else {
    const float w = __fmul_rn((float)(code_value<kMap>(c) - bias), s);
    if constexpr (kM != kNone) return bf16_round(__fsub_rn(w, m));
    return bf16_round(w);
  }
}

}  // namespace
