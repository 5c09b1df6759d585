// CPU stand-in for the part of cuda.h (CUDA's low-level API) that the Hopper
// kernel's host code uses: the tensor map types and cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint as on the card. The map keeps what
// tc_emu.h's TMA stand-in needs to copy a tile: the array, its dimensions
// and row stride, the box and the swizzle.
#pragma once
#include <cstdint>

typedef uint64_t cuuint64_t;
typedef uint32_t cuuint32_t;
typedef int CUresult;
enum { CUDA_SUCCESS = 0 };

enum CUtensorMapDataType {
  CU_TENSOR_MAP_DATA_TYPE_UINT8 = 0,
  CU_TENSOR_MAP_DATA_TYPE_FLOAT32 = 7,
  CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9
};
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum CUtensorMapSwizzle {
  CU_TENSOR_MAP_SWIZZLE_NONE = 0,
  CU_TENSOR_MAP_SWIZZLE_32B,
  CU_TENSOR_MAP_SWIZZLE_64B,
  CU_TENSOR_MAP_SWIZZLE_128B
};
enum CUtensorMapL2promotion {
  CU_TENSOR_MAP_L2_PROMOTION_NONE = 0,
  CU_TENSOR_MAP_L2_PROMOTION_L2_64B,
  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
  CU_TENSOR_MAP_L2_PROMOTION_L2_256B
};
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };

struct CUtensorMap {
  const unsigned char* base;
  uint64_t esize, stride, dims[2];
  uint32_t box[2];
  int swizzle;
};

inline CUresult emu_encode_tiled(CUtensorMap* m, CUtensorMapDataType type, cuuint32_t rank,
                                 void* base, const cuuint64_t* dims, const cuuint64_t* strides,
                                 const cuuint32_t* box, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle swizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill) {
  if (rank != 2 || box[0] > 256 || box[1] > 256) return 1;
  const uint64_t esize = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32    ? 4
                         : type == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 ? 2 : 1;
  // the hardware's limits: 16-byte aligned base and row stride, a swizzled
  // box row no wider than its swizzle span
  if (reinterpret_cast<uintptr_t>(base) % 16 || strides[0] % 16) return 1;
  if (swizzle == CU_TENSOR_MAP_SWIZZLE_128B && box[0] * esize > 128) return 1;
  if (swizzle == CU_TENSOR_MAP_SWIZZLE_64B && box[0] * esize > 64) return 1;
  *m = CUtensorMap{static_cast<const unsigned char*>(base), esize, strides[0], {dims[0], dims[1]},
                   {box[0], box[1]}, (int)swizzle};
  return CUDA_SUCCESS;
}

enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess = 0 };
enum { cudaEnableDefault = 0 };
inline int cudaGetDriverEntryPoint(const char*, void** fn, unsigned long long,
                                   cudaDriverEntryPointQueryResult* got) {
  *fn = reinterpret_cast<void*>(&emu_encode_tiled);
  *got = cudaDriverEntryPointSuccess;
  return 0;
}
