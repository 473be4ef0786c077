// Building blocks of the f32 attention kernels (csrc/flash_attention.cu and
// csrc/flash_attention_bwd.cu), which run their products on the CUDA cores
// in full f32: 16- and 4-byte cp.async copies into shared memory, and a
// copy of a tile of rows of f32 head vectors.
//
// Layout.  An f32 tile of head vectors is [row][d] with rows of HD + 4
// floats: the 16-byte pad puts rows r and r + 1 four banks apart, so eight
// threads that read one 16-byte column chunk of eight consecutive rows hit
// all 32 banks once.  Every product below reads its operands that way or
// as a broadcast.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace fma {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
struct Rows {
  static constexpr int kLd = HD + 4;       // floats a row in shared memory
  static constexpr int kChunks = HD / 4;   // 16-byte chunks a row
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes into shared memory, bypassing L1; with valid false the bytes are
// zero-filled and src is not read (src-size 0).
__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes (an lse or D entry, whose rows need not start on 16 bytes).
__device__ __forceinline__ void cp4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ROWS rows of HD floats into dst (row stride Rows<HD>::kLd), issued by NT
// threads, not committed.  row(r) gives the source of row r, or null for a
// row past the tensor's end, which is zero-filled (`any` is a readable
// address for the copies that read nothing).
template <int HD, int ROWS, int NT, typename RowFn>
__device__ __forceinline__ void cp_rows(float* dst, RowFn row, const float* any) {
  constexpr int CH = Rows<HD>::kChunks;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH;
    const int c = (i - r * CH) * 4;
    const float* src = row(r);
    cp16(dst + r * Rows<HD>::kLd + c, src ? src + c : any, src != nullptr);
  }
}

// Columns of an HD-wide row that thread column group g of G owns, so that
// the loads and stores of one row by G neighbouring threads are contiguous:
//  - G = 16: 4g..4g+3, then at hd 128 64+4g..64+4g+3, at hd 80 64+g;
//  - G = 8 (hd 64 and 80): 4g..4g+3 and 32+4g..32+4g+3, then at hd 80
//    64+2g and 64+2g+1.
template <int HD, int G = 16>
struct Cols {
  static_assert(HD == 64 || HD == 80 || HD == 128, "head dims 64, 80, 128");
  static_assert(G == 16 || (G == 8 && HD != 128), "16 column groups, or 8 below hd 128");
  static constexpr int N = HD / G;
  // this thread's N values of a row
  __device__ __forceinline__ static void load(const float* row, int g, float (&x)[N]) {
    const float4 a = *reinterpret_cast<const float4*>(row + 4 * g);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    if constexpr (G == 8) {
      const float4 b = *reinterpret_cast<const float4*>(row + 32 + 4 * g);
      x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
      if constexpr (HD == 80) {
        const float2 c = *reinterpret_cast<const float2*>(row + 64 + 2 * g);
        x[8] = c.x, x[9] = c.y;
      }
    } else if constexpr (HD == 128) {
      const float4 b = *reinterpret_cast<const float4*>(row + 64 + 4 * g);
      x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
    } else if constexpr (HD == 80) {
      x[4] = row[64 + g];
    }
  }
  // write x * mul to a row
  __device__ __forceinline__ static void store(float* row, int g, const float (&x)[N],
                                               float mul) {
    *reinterpret_cast<float4*>(row + 4 * g) =
        make_float4(x[0] * mul, x[1] * mul, x[2] * mul, x[3] * mul);
    if constexpr (G == 8) {
      *reinterpret_cast<float4*>(row + 32 + 4 * g) =
          make_float4(x[4] * mul, x[5] * mul, x[6] * mul, x[7] * mul);
      if constexpr (HD == 80)
        *reinterpret_cast<float2*>(row + 64 + 2 * g) = make_float2(x[8] * mul, x[9] * mul);
    } else if constexpr (HD == 128) {
      *reinterpret_cast<float4*>(row + 64 + 4 * g) =
          make_float4(x[4] * mul, x[5] * mul, x[6] * mul, x[7] * mul);
    } else if constexpr (HD == 80) {
      row[64 + g] = x[4] * mul;
    }
  }
};

// acc[r][c] += sum over rows i in [i0, i0 + n) of X[i][8x + r] * Y[i][Cols
// column c of group y]: X a tile of ldx-float rows (8 of its columns, two
// 16-byte chunks, a thread), Y a tile of HD-float head vectors.  The
// products O += P V (X = P^T), dV += P^T dO, dK += dS^T Q (X = P, dS) and
// dQ += dS K (X = dS^T), 16 FMAs a 16-byte load at 8 x 8.
template <int HD, int G>
__device__ __forceinline__ void acc_xt_y(const float* X, int ldx, const float* Y,
                                         float (&acc)[8][Cols<HD, G>::N], int x, int y,
                                         int i0, int n) {
  using C = Cols<HD, G>;
  constexpr int LD = Rows<HD>::kLd;
#pragma unroll 4
  for (int i = i0; i < i0 + n; ++i) {
    const float4 a = *reinterpret_cast<const float4*>(X + i * ldx + 8 * x);
    const float4 b = *reinterpret_cast<const float4*>(X + i * ldx + 8 * x + 4);
    const float xv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    float yv[C::N];
    C::load(Y + i * LD, y, yv);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < C::N; ++c) acc[r][c] = fmaf(xv[r], yv[c], acc[r][c]);
  }
}

}  // namespace fma
}  // namespace repro_torch
