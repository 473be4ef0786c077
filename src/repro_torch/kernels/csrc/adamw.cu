// AdamW for Hopper (sm_90a): the gradients' global norm and the update of
// every leaf of a model, as three launches over a work list of chunks.
//
// Replaces no TPU kernel: the reference's AdamW (repro/optim/adamw.py) is
// plain JAX, which XLA fuses.  The port's plain version
// (optim/adamw.py::AdamW.plain_update) runs it leaf by leaf in ~22 eager
// f32 ops a leaf, each writing a temporary; this kernel computes the same
// arithmetic, op for op, in f32.
//
// Bound: bytes.  The norm reads g once; the update reads g, m, v and p and
// writes m, v and p once: 2 + 22 bytes an element with p and g in bf16 and
// the moments in f32.  At qwen3-1.7b's 1,720,574,976 parameters that is
// 41.29 GB, 12.33 ms at 3.35 TB/s; its ~20 operations an element are
// nothing beside that.
//
// Design.  The host lists every leaf once (kernels/adamw.py::work_list): a
// table row of the p, m and v pointers, the element count and the decay
// flag, and chunks of kChunk elements, each inside one leaf, one block a
// chunk.  Only the gradients' pointers change from step to step; the host
// uploads them into `gptr` asynchronously.  Leaves are grouped by their
// (p, g) dtype pair, one launch of each pass a group.
//   1. grad_sq: each block writes its chunk's sum of g^2 to `partials`.
//   2. finish: one block sums every partial, then writes the norm, the
//      clip's scale and the two bias corrections to `out`.
//   3. apply: each block reads its chunk's g, m, v and p once and writes m,
//      v and p once, with scale, c1, c2 and lr read from device memory.
// A thread takes 8 elements at a time: one 16-byte load of each bf16
// array and two of each f32 one where every pointer of the leaf lies on 16
// bytes, the same elements one by one otherwise and at a leaf's ragged end.
// Each sum is taken in a fixed order (a thread's elements in turn, then
// shuffle trees of fixed shape), the same on both load paths, and there
// are no atomics, so two calls give the same bits.
//
// The arithmetic is the plain version's, one IEEE f32 operation for each
// of its ops, in its order; __fmul_rn / __fadd_rn / __fsub_rn are exactly
// the rounded product, sum and difference, spelled so that the compiler
// fuses none of them into an FMA (which would round once where the plain
// version rounds twice).  Division and sqrtf are IEEE (no fast-math flag);
// the new p is rounded once to its dtype, to nearest even.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                  // threads per block of grad_sq and apply
constexpr int VEC = 8;                   // elements a thread takes at a time
constexpr long long kChunk = 32768;      // elements per block: kernels/adamw.py's CHUNK
constexpr int FIN_NT = 1024;             // threads of the one finish block
constexpr int kCols = 5;                 // table row: p, m, v, numel, decay
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(x);
}

// Elements i .. i+7 of src (i a multiple of 8) into x: whole vectors when
// `vec` and all 8 lie below n, else one by one, zeros from n on.
template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ src, long long i, long long n,
                                      bool vec, float (&x)[VEC]) {
  if (vec && i + VEC <= n) {
    if constexpr (sizeof(T) == 2) {
      const int4 r = *reinterpret_cast<const int4*>(src + i);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
      for (int k = 0; k < VEC; ++k) x[k] = to_f32(h[k]);
    } else {
      const float4 a = *reinterpret_cast<const float4*>(src + i);
      const float4 b = *reinterpret_cast<const float4*>(src + i + 4);
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) x[k] = i + k < n ? to_f32(src[i + k]) : 0.f;
  }
}

// x into elements i .. i+7 of dst below n, as load8 reads them.
template <typename T>
__device__ __forceinline__ void store8(T* __restrict__ dst, long long i, long long n, bool vec,
                                       const float (&x)[VEC]) {
  if (vec && i + VEC <= n) {
    if constexpr (sizeof(T) == 2) {
      int4 r;
      __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&r);
#pragma unroll
      for (int k = 0; k < VEC; ++k) from_f32(x[k], h + k);
      *reinterpret_cast<int4*>(dst + i) = r;
    } else {
      *reinterpret_cast<float4*>(dst + i) = make_float4(x[0], x[1], x[2], x[3]);
      *reinterpret_cast<float4*>(dst + i + 4) = make_float4(x[4], x[5], x[6], x[7]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (i + k < n) from_f32(x[k], dst + i + k);
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The block's sum of v, in a fixed order: a shuffle tree in each warp,
// then one over the warps' sums.  Thread 0 holds the result.
template <int THREADS>
__device__ __forceinline__ float block_sum(float v) {
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "a block of whole warps");
  __shared__ float warp_sums[THREADS / 32];
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) v += __shfl_xor_sync(kFull, v, w);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) v += __shfl_xor_sync(kFull, v, w);
  }
  return v;
}

// Chunk c of the work list: leaf row c.x, elements [c.y kChunk, min((c.y +
// 1) kChunk, numel)).
template <typename GT>
__global__ void __launch_bounds__(NT)
adamw_grad_sq_kernel(const long long* __restrict__ table,
                     const long long* __restrict__ gptr, const int2* __restrict__ chunks,
                     float* __restrict__ partials) {
  const int2 c = chunks[blockIdx.x];
  const GT* g = reinterpret_cast<const GT*>(gptr[c.x]);
  const long long lo = static_cast<long long>(c.y) * kChunk;
  const long long hi = min(lo + kChunk, table[c.x * kCols + 3]);
  const bool vec = aligned16(g);
  float acc = 0.f;
#pragma unroll 2
  for (long long i = lo + static_cast<long long>(threadIdx.x) * VEC; i < hi; i += NT * VEC) {
    float x[VEC];
    load8(g, i, hi, vec, x);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc = fmaf(x[k], x[k], acc);
  }
  acc = block_sum<NT>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

// out = [gnorm, scale, c1, c2], as the plain version computes them:
// gnorm = sqrt(sum g^2); scale = min(reciprocal(gnorm + 1e-9) * clip, 1)
// (Python's `clip / tensor` is the reciprocal times clip), or 1 without a
// clip; c = 1 - b^step.
__global__ void __launch_bounds__(FIN_NT)
adamw_finish_kernel(const float* __restrict__ partials, int n, const int* __restrict__ step,
                    float b1, float b2, float clip, float* __restrict__ out) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += FIN_NT) acc += partials[i];
  acc = block_sum<FIN_NT>(acc);
  if (threadIdx.x == 0) {
    const float gnorm = sqrtf(acc);
    float scale = 1.f;
    if (clip > 0.f) {
      const float s = (1.f / (gnorm + 1e-9f)) * clip;
      scale = s > 1.f ? 1.f : s;           // a NaN stays NaN, as torch.clamp keeps it
    }
    const float t = static_cast<float>(*step);
    out[0] = gnorm;
    out[1] = scale;
    out[2] = 1.f - powf(b1, t);
    out[3] = 1.f - powf(b2, t);
  }
}

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;     // omb = 1 - b, rounded from double as torch does
};

template <typename PT, typename GT>
__global__ void __launch_bounds__(NT)
adamw_apply_kernel(const long long* __restrict__ table, const long long* __restrict__ gptr,
                   const int2* __restrict__ chunks, const float* __restrict__ scal,
                   const float* __restrict__ lr_ptr, Hyper h) {
  const int2 c = chunks[blockIdx.x];
  const long long* row = table + c.x * kCols;
  PT* p = reinterpret_cast<PT*>(row[0]);
  float* m = reinterpret_cast<float*>(row[1]);
  float* v = reinterpret_cast<float*>(row[2]);
  const bool decay = row[4] != 0;
  const GT* g = reinterpret_cast<const GT*>(gptr[c.x]);
  const long long lo = static_cast<long long>(c.y) * kChunk;
  const long long hi = min(lo + kChunk, row[3]);
  const bool vec = aligned16(p) && aligned16(m) && aligned16(v) && aligned16(g);
  const float scale = scal[1], c1 = scal[2], c2 = scal[3], lr = *lr_ptr;
  for (long long i = lo + static_cast<long long>(threadIdx.x) * VEC; i < hi; i += NT * VEC) {
    float gx[VEC], px[VEC], mx[VEC], vx[VEC];
    load8(g, i, hi, vec, gx);
    load8(p, i, hi, vec, px);
    load8(m, i, hi, vec, mx);
    load8(v, i, hi, vec, vx);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float gs = __fmul_rn(gx[k], scale);
      mx[k] = __fadd_rn(__fmul_rn(h.b1, mx[k]), __fmul_rn(h.omb1, gs));
      vx[k] = __fadd_rn(__fmul_rn(h.b2, vx[k]), __fmul_rn(__fmul_rn(h.omb2, gs), gs));
      float delta = (mx[k] / c1) / __fadd_rn(sqrtf(vx[k] / c2), h.eps);
      if (decay) delta = __fadd_rn(delta, __fmul_rn(h.wd, px[k]));
      px[k] = __fsub_rn(px[k], __fmul_rn(lr, delta));
    }
    store8(m, i, hi, vec, mx);
    store8(v, i, hi, vec, vx);
    store8(p, i, hi, vec, px);
  }
}

template <typename GT>
cudaError_t launch_sq(const long long* table, const long long* gptr, const int2* chunks, int n,
                      float* partials, cudaStream_t s) {
  adamw_grad_sq_kernel<GT><<<n, NT, 0, s>>>(table, gptr, chunks, partials);
  return cudaGetLastError();
}

template <typename PT, typename GT>
cudaError_t launch_apply(const long long* table, const long long* gptr, const int2* chunks,
                         int n, const float* scal, const float* lr, const Hyper& h,
                         cudaStream_t s) {
  adamw_apply_kernel<PT, GT><<<n, NT, 0, s>>>(table, gptr, chunks, scal, lr, h);
  return cudaGetLastError();
}

}  // namespace

// Dtype kinds: 0 f32, 1 bf16.  `table` (int64, 5 per leaf row), `gptr`
// (int64, one per row) and `chunks` (int32 pairs: row, chunk of the leaf)
// as kernels/adamw.py builds them, on `device`; `chunks` and `partials`
// point at the group's first chunk.  Each returns the launch's error.
extern "C" int adamw_grad_sq(const void* table, const void* gptr, const void* chunks,
                             void* partials, int device, int nchunks, int gkind, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nchunks < 1 || gkind < 0 || gkind > 1) return cudaErrorInvalidValue;
  const long long* t = static_cast<const long long*>(table);
  const long long* gp = static_cast<const long long*>(gptr);
  const int2* ch = static_cast<const int2*>(chunks);
  float* part = static_cast<float*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return gkind ? launch_sq<__nv_bfloat16>(t, gp, ch, nchunks, part, s)
               : launch_sq<float>(t, gp, ch, nchunks, part, s);
}

// `partials` (f32, n), `step` (int32, the incremented step), `out` (f32,
// 4: gnorm, scale, c1, c2); clip <= 0 means no clip.
extern "C" int adamw_finish(const void* partials, const void* step, void* out, int device,
                            int n, float b1, float b2, float clip, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n < 0) return cudaErrorInvalidValue;
  adamw_finish_kernel<<<1, FIN_NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), n, static_cast<const int*>(step), b1, b2, clip,
      static_cast<float*>(out));
  return cudaGetLastError();
}

// `scal` is adamw_finish's `out`, `lr` a 0-dim f32 tensor; p, m and v are
// written in place.
extern "C" int adamw_apply(const void* table, const void* gptr, const void* chunks,
                           const void* scal, const void* lr, int device, int nchunks, int pkind,
                           int gkind, float b1, float omb1, float b2, float omb2, float eps,
                           float wd, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nchunks < 1 || pkind < 0 || pkind > 1 || gkind < 0 || gkind > 1)
    return cudaErrorInvalidValue;
  const long long* t = static_cast<const long long*>(table);
  const long long* gp = static_cast<const long long*>(gptr);
  const int2* ch = static_cast<const int2*>(chunks);
  const float* sc = static_cast<const float*>(scal);
  const float* l = static_cast<const float*>(lr);
  const Hyper h{b1, omb1, b2, omb2, eps, wd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pkind) {
    return gkind ? launch_apply<__nv_bfloat16, __nv_bfloat16>(t, gp, ch, nchunks, sc, l, h, s)
                 : launch_apply<__nv_bfloat16, float>(t, gp, ch, nchunks, sc, l, h, s);
  }
  return gkind ? launch_apply<float, __nv_bfloat16>(t, gp, ch, nchunks, sc, l, h, s)
               : launch_apply<float, float>(t, gp, ch, nchunks, sc, l, h, s);
}
