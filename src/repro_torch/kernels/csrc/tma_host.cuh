// Host side of the TMA loads of the bf16 attention kernels: the tensor maps
// of (B, S, heads, hd) bf16 tensors, cut into 64 x 64 boxes that land in the
// 128-byte-swizzled tiles of sm90.cuh.  Both flash_attention.cu and
// flash_attention_bwd_sm90.cu build their maps here.
#pragma once

#include <cuda.h>  // CUtensorMap; the driver function itself is found at run time
#include <cuda_runtime.h>

namespace repro_torch {
namespace tma {

constexpr int kBoxRows = 64;  // rows (sequence positions) of one box

// cuTensorMapEncodeTiled, looked up in the driver at run time, so that the
// library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The (hd, S, heads, B) view of a (B,S,heads,hd) bf16 tensor with element
// strides ss, sh, sb, cut into 64 x 64 boxes with the 128-byte swizzle.
// Rows past S and columns past hd read as zeros.
inline bool make_map(CUtensorMap* map, const void* ptr, int hd, int S, int heads, int B,
                     long long ss, long long sh, long long sb) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(S), cuuint64_t(heads), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(ss) * 2, cuuint64_t(sh) * 2, cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {64, kBoxRows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tma
}  // namespace repro_torch
