// Reverse Mamba2 SSD inter-chunk state recurrence for Hopper (sm_90a): the
// gradient of ssd_scan.cu's forward.
//
// The reference has no Pallas backward.  It differentiates
// repro/kernels/ref.py::ssd_state_scan_ref (whose Pallas _scan_kernel,
// repro/kernels/ssd_scan.py::ssd_state_scan, the forward replaces) with
// XLA's autodiff.  This kernel computes what kernels/ref.py::
// ssd_state_scan_bwd_ref computes, the closed form of that gradient: with G
// the gradient of the state entering chunk c+1 (g_final, or zeros, past the
// last chunk), walking c from C-1 down to 0,
//   d_states[c] = G
//   d_decays[c] = sum over (p, n) of G * prefix[c]
//   G           = g_prefix[c] + a[c] * G
// and d_init = G after chunk 0.  prefix is the forward's saved output, so
// nothing is recomputed.  All f32.
//
// Bound: bytes.  g_prefix and prefix are read once and d_states written
// once (3 B C H P N 4 bytes), plus g_final read and d_init written where
// present (B H P N 4 each), plus the decays and d_decays (B C H 4 each); ~4
// FLOP per element is nothing beside that.  At a zamba2-2.7b Mamba2 block
// of 4 x 1024 training tokens (B=4, C=4, H=64, P=80, N=64) as the model
// calls it (no g_final, no init): 62,922,752 bytes, 18.78 us at 3.35 TB/s;
// with g_final and d_init 73,408,512 bytes, 21.91 us.
//
// Design: every (p, n) element has its own recurrence, but d_decays[c] sums
// over all P*N elements of a (b, h) pair.  Blocks run in no order, and
// without atomics (the training path's bit-equal repeat and resume rest on
// there being none) a sum across blocks needs a second pass.  So one block
// owns one (b, h) pair: grid (H, B).  Its threads walk the pair's P*N
// elements in passes of NT*EPT (two passes at zamba2's 5120), each thread
// keeping EPT elements of G in registers for the whole reverse walk over c,
// strided by the block size so that each load and store of a warp covers
// 128 contiguous bytes.  At each chunk a thread sums its EPT products in
// order, the warp sums by a shuffle tree, and thread 0 adds the warps'
// sums in warp order (a double-buffered shared array: one barrier a chunk)
// and the passes' sums in pass order into d_decays.  Every sum has one
// fixed order, so two calls give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;               // threads per block
constexpr int EPT = 10;               // state elements per thread per pass
constexpr int PASS = NT * EPT;        // elements of a (b, h) pair per pass
constexpr int WARPS = NT / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) v += __shfl_xor_sync(kFull, v, w);
  return v;
}

__global__ void __launch_bounds__(NT)
ssd_scan_bwd_kernel(const float* __restrict__ g_prefix, const float* __restrict__ g_final,
                    const float* __restrict__ prefix, const float* __restrict__ decays,
                    float* __restrict__ d_states, float* __restrict__ d_decays,
                    float* __restrict__ d_init, int C, int H, int PN) {
  __shared__ float red[2][WARPS];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const long long bh = static_cast<long long>(b) * H + h;     // (b, h) of (B, H)
  const long long step = static_cast<long long>(H) * PN;      // one chunk of (B,C,H,PN)
  const long long base = (static_cast<long long>(b) * C * H + h) * PN;  // (b, 0, h)
  int buf = 0;
  for (int p0 = 0; p0 < PN; p0 += PASS) {
    float G[EPT];
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int e = p0 + threadIdx.x + i * NT;
      G[i] = g_final != nullptr && e < PN ? g_final[bh * PN + e] : 0.f;
    }
    for (int c = C - 1; c >= 0; --c) {
      const long long off = base + c * step;
      const long long bch = (static_cast<long long>(b) * C + c) * H + h;
      const float a = decays[bch];
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        const int e = p0 + threadIdx.x + i * NT;
        if (e < PN) {
          const float gp = g_prefix[off + e];
          const float pf = prefix[off + e];
          d_states[off + e] = G[i];
          part = fmaf(G[i], pf, part);
          G[i] = fmaf(a, G[i], gp);
        }
      }
      part = warp_sum(part);
      if (lane == 0) red[buf][warp] = part;
      __syncthreads();
      if (threadIdx.x == 0) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += red[buf][w];
        d_decays[bch] = p0 == 0 ? s : d_decays[bch] + s;
      }
      buf ^= 1;   // the next chunk writes the other half while thread 0 reads this one
    }
    if (d_init != nullptr) {
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        const int e = p0 + threadIdx.x + i * NT;
        if (e < PN) d_init[bh * PN + e] = G[i];
      }
    }
  }
}

}  // namespace

// g_prefix, prefix and d_states (B,C,H,P,N), decays and d_decays (B,C,H),
// g_final and d_init (B,H,P,N), each nullable (none: zeros in, nothing
// out): all f32 and contiguous.  Returns cudaGetLastError() after the
// launch.
extern "C" int ssd_scan_bwd(const void* g_prefix, const void* g_final, const void* prefix,
                            const void* decays, void* d_states, void* d_decays, void* d_init,
                            int device, int B, int C, int H, int P, int N, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 1 || C < 1 || H < 1 || P < 1 || N < 1 || B > 65535) return cudaErrorInvalidValue;
  dim3 grid(H, B);
  ssd_scan_bwd_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g_prefix), static_cast<const float*>(g_final),
      static_cast<const float*>(prefix), static_cast<const float*>(decays),
      static_cast<float*>(d_states), static_cast<float*>(d_decays),
      static_cast<float*>(d_init), C, H, P * N);
  return cudaGetLastError();
}
