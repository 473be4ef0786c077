// Helpers shared by the attention kernels: element loads in float and
// 16-byte tile copies from device memory into padded shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr float kNegInf = -1e30f;  // the oracles' mask value (not -inf)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Shared-memory rows are padded by 16 bytes: row starts stay 16-byte aligned
// (vector stores, WMMA's 32-byte fragment alignment at 16-row multiples) and
// eight consecutive rows fall in eight different 16-byte bank groups, so
// 16-byte reads of one column by neighbouring rows are free of conflicts.
template <typename T, int HD>
struct Tile {
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int kLd = HD + kPad;            // leading dim in elements
  static constexpr int kVec = 16 / sizeof(T);      // elements per 16 B
  static constexpr int kVecPerRow = HD / kVec;
};

// Copy `rows` rows of HD elements into dst (row stride Tile::kLd).  Row r
// comes from src + r * row_stride when r < valid, else it is zero-filled, so
// that no masked position can carry a NaN from uninitialised memory.
template <typename T, int HD, int NT>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long row_stride,
                                          int rows, int valid) {
  using TL = Tile<T, HD>;
  for (int i = threadIdx.x; i < rows * TL::kVecPerRow; i += NT) {
    int r = i / TL::kVecPerRow;
    int c = (i % TL::kVecPerRow) * TL::kVec;
    int4 val = make_int4(0, 0, 0, 0);
    if (r < valid) val = *reinterpret_cast<const int4*>(src + r * row_stride + c);
    *reinterpret_cast<int4*>(dst + r * TL::kLd + c) = val;
  }
}

}  // namespace repro_torch
