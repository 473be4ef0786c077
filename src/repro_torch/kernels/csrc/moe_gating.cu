// MoE router for Hopper (sm_90a): row softmax, top-k, renormalise.
//
// Replaces repro/kernels/moe_gating.py::moe_gating, the Pallas TPU kernel
// _gating_kernel.  It computes what repro/kernels/ref.py::moe_gating_ref
// computes: logits (T,E) f32 -> probabilities by a row softmax in f32, then
// k rounds of (max, argmax, mask the winner to -1), then the k weights
// divided by their sum.  Ties go to the lowest expert index, as lax.top_k
// breaks them.  Unlike the Pallas kernel, which asserts T % block_t == 0, it
// takes any T (the ragged tail of rows is masked).
//
// Bound: bytes, T*E*4 read plus T*k*8 written, over 3.35 TB/s on an H100
// SXM: 0.62 MB at qwen3-moe prefill (T=1200, E=128, k=8), under 0.2 us, and
// a few hundred bytes at decode.  The kernel's time is launch latency, so
// the design only keeps it to one launch and one pass over the logits.
//
// Design: one warp per token row, eight rows per block of 256 threads.  Lane
// l holds the row's columns l, l+32, ... (NV = ceil(E/32) values, E <= 256)
// in registers; the loads of a warp are coalesced.  The max and the sum of
// the softmax are warp shuffles.  Each top-k round is a warp argmax over
// (value, column) pairs that keeps the lower column on a tie; every lane
// learns the winner, the owning lane masks it to -1, and lane j keeps the
// j-th winner for the store.  Columns past E hold -inf and never win.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;                  // threads per block
constexpr int ROWS = NT / 32;            // token rows per block
constexpr unsigned kFull = 0xffffffffu;

template <int NV>
__global__ void __launch_bounds__(NT)
moe_gating_kernel(const float* __restrict__ logits, float* __restrict__ weights,
                  int* __restrict__ ids, int T, int E, int k) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS + threadIdx.x / 32;
  if (row >= T) return;  // the whole warp leaves together
  const float* x = logits + static_cast<long long>(row) * E;

  float p[NV];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = lane + 32 * i;
    p[i] = col < E ? x[col] : -INFINITY;
    mx = fmaxf(mx, p[i]);
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, w));
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    p[i] = lane + 32 * i < E ? expf(p[i] - mx) : 0.f;
    sum += p[i];
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(kFull, sum, w);
#pragma unroll
  for (int i = 0; i < NV; ++i) p[i] = lane + 32 * i < E ? p[i] / sum : -INFINITY;

  float mine_w = 0.f, total = 0.f;
  int mine_id = 0;
  for (int j = 0; j < k; ++j) {
    // this lane's best: ascending columns, so a strict > keeps the lowest
    float best = p[0];
    int best_col = lane;
#pragma unroll
    for (int i = 1; i < NV; ++i)
      if (p[i] > best) {
        best = p[i];
        best_col = lane + 32 * i;
      }
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) {
      const float ov = __shfl_xor_sync(kFull, best, w);
      const int oc = __shfl_xor_sync(kFull, best_col, w);
      if (ov > best || (ov == best && oc < best_col)) {
        best = ov;
        best_col = oc;
      }
    }
    total += best;
    if (lane == j) {
      mine_w = best;
      mine_id = best_col;
    }
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (lane + 32 * i == best_col) p[i] = -1.f;
  }
  if (lane < k) {
    weights[static_cast<long long>(row) * k + lane] = mine_w / total;
    ids[static_cast<long long>(row) * k + lane] = mine_id;
  }
}

template <int NV>
cudaError_t launch(const float* logits, float* weights, int* ids, int T, int E, int k,
                   cudaStream_t stream) {
  moe_gating_kernel<NV><<<(T + ROWS - 1) / ROWS, NT, 0, stream>>>(logits, weights, ids, T,
                                                                    E, k);
  return cudaGetLastError();
}

}  // namespace

// logits (T,E) f32, weights (T,k) f32 and ids (T,k) int32, all contiguous;
// 1 <= k <= min(E, 32), 1 <= E <= 256.  Returns cudaGetLastError() after the
// launch.
extern "C" int moe_gating_fwd(const void* logits, void* weights, void* ids, int device,
                              int T, int E, int k, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (T < 1 || E < 1 || E > 256 || k < 1 || k > E || k > 32) return cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(logits);
  float* w = static_cast<float*>(weights);
  int* id = static_cast<int*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((E + 31) / 32) {
    case 1: return launch<1>(x, w, id, T, E, k, s);
    case 2: return launch<2>(x, w, id, T, E, k, s);
    case 3: return launch<3>(x, w, id, T, E, k, s);
    case 4: return launch<4>(x, w, id, T, E, k, s);
    case 5: return launch<5>(x, w, id, T, E, k, s);
    case 6: return launch<6>(x, w, id, T, E, k, s);
    case 7: return launch<7>(x, w, id, T, E, k, s);
    default: return launch<8>(x, w, id, T, E, k, s);
  }
}
