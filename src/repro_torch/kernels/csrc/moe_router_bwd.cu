// MoE router backward for Hopper (sm_90a): the gradient of moe_router_fwd's
// weights and probabilities with respect to its f32 logits.
//
// The reference has no Pallas backward.  It differentiates the router chain
// of repro/models/moe.py:106-112 (logits = x.astype(f32) @ router, then
// repro/kernels/moe_gating.py::moe_gating, whose Pallas _gating_kernel the
// forward replaces, then the softmax of the load-balance statistics) with
// XLA's autodiff.  This kernel computes what kernels/ref.py::
// moe_router_bwd_ref computes, the closed form of that gradient: with p the
// forward's probabilities, s_j = p[ids_j], S = sum_j s_j and w_j = s_j / S,
//   ds_j    = (gw_j - sum_i gw_i w_i) / S
//   g       = gprobs + ds scattered to ids          (gprobs may be absent)
//   dlogits = p (g - sum_e p_e g_e).
// The router's two products (dx = dlogits @ router^T, drouter = x^T @
// dlogits) stay f32 matrix products in the wrapper, as the reference leaves
// them to XLA outside any Pallas kernel.
//
// Bound: bytes.  p and gprobs read, dlogits written (3 T E 4 bytes) and gw,
// w, ids read (3 T k 4): 6.68 MB at phase 10's T = 4096, E = 128, k = 8,
// 2.0 us at 3.35 TB/s; its ~7 T E operations are nothing.
//
// Design: one warp per token row, eight rows per block, so T = 4096 is 512
// blocks, one resident wave, and the time is one row's chain of latencies
// plus the launch.  The chain is one memory round trip: every load of a row
// (lane l takes columns l, l+32, ... of p and gprobs, and lane j < k ids_j,
// gw_j and w_j) is issued at once, and nothing after it reads memory.
// s_j = p[ids_j] already sits in the warp's registers and comes by shuffle
// from the lane that holds column ids_j; ds is scattered to the winners'
// columns by shuffles too, and every sum is a shuffle tree of fixed order
// over one warp.  There are no atomics, so two calls give the same bits.
// The work has no product for wgmma, and each row is read once: a TMA ring
// would add an mbarrier round trip and a trip through shared memory to
// bytes that go straight to registers in one wave.  16-byte loads of p and
// gprobs were tried and bought nothing measurable (each warp's 4-byte loads
// already cover whole 128-byte lines), so the kernel keeps the one path.
// CUDA and not Triton, though the work is a per-row reduction Triton could
// serve: the kernel shares the forward's warp-per-row layout and top-k lane
// convention (moe_gating.cu), and keeping it beside the forward keeps one
// convention.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;                  // threads per block
constexpr int ROWS = NT / 32;            // token rows (warps) per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) v += __shfl_xor_sync(kFull, v, w);
  return v;
}

// NV values of a row per lane: value i of lane l is column l + 32 i.
template <int NV>
__global__ void __launch_bounds__(NT)
moe_router_bwd_kernel(const float* __restrict__ gw, const float* __restrict__ gprobs,
                      const float* __restrict__ w, const int* __restrict__ ids,
                      const float* __restrict__ probs, float* __restrict__ dlogits, int T,
                      int E, int k) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * ROWS + threadIdx.x / 32;
  if (row >= T) return;                  // the whole warp leaves together
  const bool has_gp = gprobs != nullptr;

  // every load of the row at once
  float p[NV], g[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = lane + 32 * i;
    p[i] = col < E ? probs[row * E + col] : 0.f;
    g[i] = has_gp && col < E ? gprobs[row * E + col] : 0.f;
  }
  int id = 0;                            // lane j < k: the j-th winner, gw_j, w_j
  float gw_j = 0.f, w_j = 0.f;
  if (lane < k) {
    id = ids[row * k + lane];
    gw_j = gw[row * k + lane];
    w_j = w[row * k + lane];
  }

  // s_j = p[id] from the lane and value that hold column id
  const int src = id % 32;
  float s_j = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float v = __shfl_sync(kFull, p[i], src);
    if (i == id / 32 && lane < k) s_j = v;
  }
  const float S = warp_sum(s_j);
  const float ds = (gw_j - warp_sum(gw_j * w_j)) / S;

  // scatter ds to the winners' columns: the ids of a row are distinct, so
  // each column takes at most one term
  for (int j = 0; j < k; ++j) {
    const int col = __shfl_sync(kFull, id, j);
    const float d = __shfl_sync(kFull, ds, j);
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (lane + 32 * i == col) g[i] += d;
  }

  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) dot += p[i] * g[i];
  dot = warp_sum(dot);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = lane + 32 * i;
    if (col < E) dlogits[row * E + col] = p[i] * (g[i] - dot);
  }
}

template <int NV>
cudaError_t launch(const float* gw, const float* gprobs, const float* w, const int* ids,
                   const float* probs, float* dlogits, int T, int E, int k, cudaStream_t s) {
  const int blocks = (T + ROWS - 1) / ROWS;
  moe_router_bwd_kernel<NV><<<blocks, NT, 0, s>>>(gw, gprobs, w, ids, probs, dlogits, T, E, k);
  return cudaGetLastError();
}

}  // namespace

// gw (T,k) f32, gprobs (T,E) f32 or null, w (T,k) f32, ids (T,k) int32 and
// probs (T,E) f32 from moe_router_fwd, dlogits (T,E) f32 out, all
// contiguous; 1 <= E <= 256, 1 <= k <= min(E, 32).  Returns the launch's
// error.
extern "C" int moe_router_bwd(const void* gw, const void* gprobs, const void* w,
                              const void* ids, const void* probs, void* dlogits, int device,
                              int T, int E, int k, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (T < 1 || E < 1 || E > 256 || k < 1 || k > E || k > 32) return cudaErrorInvalidValue;
  const float* g = static_cast<const float*>(gw);
  const float* gp = static_cast<const float*>(gprobs);
  const float* wt = static_cast<const float*>(w);
  const int* id = static_cast<const int*>(ids);
  const float* p = static_cast<const float*>(probs);
  float* dl = static_cast<float*>(dlogits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((E + 31) / 32) {
    case 1: return launch<1>(g, gp, wt, id, p, dl, T, E, k, s);
    case 2: return launch<2>(g, gp, wt, id, p, dl, T, E, k, s);
    case 3: return launch<3>(g, gp, wt, id, p, dl, T, E, k, s);
    case 4: return launch<4>(g, gp, wt, id, p, dl, T, E, k, s);
    case 5: return launch<5>(g, gp, wt, id, p, dl, T, E, k, s);
    case 6: return launch<6>(g, gp, wt, id, p, dl, T, E, k, s);
    case 7: return launch<7>(g, gp, wt, id, p, dl, T, E, k, s);
    default: return launch<8>(g, gp, wt, id, p, dl, T, E, k, s);
  }
}
