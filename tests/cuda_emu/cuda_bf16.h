// CPU stand-in for cuda_bf16.h (see cuda_runtime.h): bf16 as its 16 bits,
// round to nearest even.
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 { uint16_t v; };

inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return __nv_bfloat16{(uint16_t)((u + 0x7fff + ((u >> 16) & 1)) >> 16)};
}

inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = (uint32_t)b.v << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
