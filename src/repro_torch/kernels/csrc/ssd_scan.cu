// Mamba2 SSD inter-chunk state recurrence for Hopper (sm_90a).
//
// Replaces repro/kernels/ssd_scan.py::ssd_state_scan, the Pallas TPU kernel
// _scan_kernel.  It computes what repro/kernels/ref.py::ssd_state_scan_ref
// computes: for each (b, h), walking the chunks c in order,
// prefix[b,c,h] = S; S = a[b,c,h] * S + X[b,c,h], with S a (P,N) state that
// starts from init (or zeros); final[b,h] = S after the last chunk.  All f32.
//
// Bound: bytes.  X is read once and prefix written once
// (2*B*C*H*P*N*4 bytes), plus final and init; 2 FLOP per element of X is
// nothing beside that.  For zamba2 prefill (B=4, C=3, H=64, P=80, N=64) that
// is 31.5 MB plus 5.2 MB, about 11 us at 3.35 TB/s.
//
// Design: the Pallas grid walks c in order and carries S in VMEM scratch
// from one grid step to the next.  Blocks on Hopper run in no order, so the
// loop over c moves inside the block: every (p, n) element has its own
// independent recurrence, so the grid is over (tiles of P*N, H, B) and each
// thread keeps EPT elements of S in registers for the whole walk.  Its
// elements are strided by the block size, so each load and store of a warp
// covers 128 contiguous bytes.  The decays a[b, :, h] are staged into shared
// memory a tile of chunks at a time, so each is read from device memory once
// per block.  prefix[c] is written before the update and final after the
// last chunk; every byte of X and prefix passes through once.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;   // threads per block
constexpr int EPT = 4;    // state elements per thread
constexpr int TILE = NT;  // chunk decays staged per pass

__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ decays,
                const float* __restrict__ init, float* __restrict__ prefix,
                float* __restrict__ final_state, int C, int H, int PN) {
  __shared__ float a_s[TILE];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int e0 = blockIdx.x * NT * EPT + threadIdx.x;
  const long long bh = static_cast<long long>(b) * H + h;     // (b, h) of (B, H)
  const long long step = static_cast<long long>(H) * PN;      // one chunk of (B,C,H,PN)
  const long long base = (static_cast<long long>(b) * C * H + h) * PN;  // (b, 0, h)

  float s[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = e0 + i * NT;
    s[i] = init != nullptr && e < PN ? init[bh * PN + e] : 0.f;
  }
  for (int c0 = 0; c0 < C; c0 += TILE) {
    const int n = min(TILE, C - c0);
    __syncthreads();  // the last tile's decays have been used
    if (threadIdx.x < n)
      a_s[threadIdx.x] = decays[(static_cast<long long>(b) * C + c0 + threadIdx.x) * H + h];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float a = a_s[j];
      const long long off = base + (c0 + j) * step;
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        const int e = e0 + i * NT;
        if (e < PN) {
          prefix[off + e] = s[i];
          s[i] = fmaf(a, s[i], x[off + e]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = e0 + i * NT;
    if (e < PN) final_state[bh * PN + e] = s[i];
  }
}

}  // namespace

// states and prefix (B,C,H,P,N), decays (B,C,H), init (nullable) and final
// (B,H,P,N): all f32 and contiguous.  Returns cudaGetLastError() after the
// launch.
extern "C" int ssd_scan_fwd(const void* states, const void* decays, const void* init,
                            void* prefix, void* final_state, int device, int B, int C,
                            int H, int P, int N, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 1 || C < 1 || H < 1 || P < 1 || N < 1) return cudaErrorInvalidValue;
  const int PN = P * N;
  dim3 grid((PN + NT * EPT - 1) / (NT * EPT), H, B);
  ssd_scan_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(states), static_cast<const float*>(decays),
      static_cast<const float*>(init), static_cast<float*>(prefix),
      static_cast<float*>(final_state), C, H, PN);
  return cudaGetLastError();
}
