// MoE router for Hopper (sm_90a): two entries around one warp-per-row
// softmax / top-k.
//
// moe_gating_fwd replaces repro/kernels/moe_gating.py::moe_gating, the Pallas
// TPU kernel _gating_kernel.  It computes what repro/kernels/ref.py::
// moe_gating_ref computes: logits (T,E) f32 -> probabilities by a row softmax
// in f32, then k rounds of (max, argmax, mask the winner to -1), then the k
// weights divided by their sum.  Ties go to the lowest expert index, as
// lax.top_k breaks them.  Unlike the Pallas kernel, which asserts
// T % block_t == 0, it takes any T (the ragged tail of rows is masked).
// Bound: bytes, T*E*4 read plus T*k*8 written, over 3.35 TB/s on an H100
// SXM: 0.62 MB at qwen3-moe prefill (T=1200, E=128, k=8), under 0.2 us, and
// a few hundred bytes at decode.  Its time is the fixed cost of a launch.
//
// moe_router_fwd replaces the same kernel together with the product in
// front of it, repro/models/moe.py:106 (logits = x.astype(f32) @ router),
// and the softmax the load-balance statistics take (:111): x (T,D) bf16 or
// f32 and the router (D,E) f32 in; weights, ids and the (T,E) probabilities
// out, in one launch, with the logits never in device memory.  The logits
// are f32 sums of f32 products (x converted to f32, FMA on the CUDA cores),
// as the reference computes them: no TF32 and no bf16 product, which would
// move router ids.  Two bounds, over 3.35 TB/s and 67 TFLOP/s:
//   decode, T=4 (qwen3-moe, D=2048, E=128, k=8): the 1 MiB router plus 16 KB
//     of x, 0.32 us of bytes; the FLOPs are nothing;
//   prefill, T=1200: 2*T*D*E = 629 MFLOP, 9.39 us of f32 operations (the
//     6.65 MB come to 1.99 us).
// One SM cannot pull 1 MiB in 0.3 us, and T=1200 is 15 tiles of 80 rows,
// too few blocks for 132 SMs.  So both kernels split D across a thread-block
// cluster (grid x): block r of a cluster takes the r-th contiguous run of
// the router's rows and x's columns and forms partial (rows, E) logits in
// shared memory.  After a cluster barrier, block r reduces the token rows i
// with i % cluster == r over the cluster's blocks in rank order
// (distributed shared memory), so the sum is the same on every run, and a
// warp runs the softmax / top-k on each reduced row and writes weights, ids
// and probabilities.  The decode kernel (T <= 8; one cluster of up to 16
// blocks, 64 KB of router each at qwen3-moe) keeps every router load of a
// thread in flight at once, straight into registers, and splits the rows of
// D over its warps; what it costs is latency: the loads', the cluster
// barriers', the softmax / top-k's.  The tile kernel (more tokens; BM token
// rows per cluster, 15 clusters of 8 at qwen3-moe prefill) streams the
// router through a ring of shared-memory stages, one TMA bulk copy per
// KC-row chunk, holds its x slab in f32 in shared memory, and gives warp w
// BM/8 token rows and lane l the columns l, l+32, ..., so every router read
// is 32 consecutive floats and every x read a broadcast, with (BM/8) x
// (E/32) f32 accumulators per thread: its cost is the f32 FMA rate.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "sm90.cuh"

namespace cg = cooperative_groups;
using namespace repro_torch::sm90;

namespace {

constexpr int NT = 256;                  // threads per block
constexpr int ROWS = NT / 32;            // warps per block
constexpr unsigned kFull = 0xffffffffu;

// Softmax over one row and its top k, held by one warp: p[i] is the logit of
// column lane + 32 i, -inf past E.  Writes the k renormalised weights and
// ids, and the probabilities where `probs` is not null.  The warp's max and
// argmax are single redux.sync instructions on unsigned keys that order as
// the floats do.
template <int NV>
__device__ __forceinline__ void route_row(float (&p)[NV], int lane, int E, int k,
                                          float* __restrict__ weights, int* __restrict__ ids,
                                          float* __restrict__ probs) {
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < NV; ++i) mx = fmaxf(mx, p[i]);
  {  // a float's bits, sign bit flipped (all bits, for negatives), order as the float
    const unsigned u = __float_as_uint(mx);
    const unsigned top = __reduce_max_sync(kFull, u & 0x80000000u ? ~u : u | 0x80000000u);
    mx = __uint_as_float(top & 0x80000000u ? top & 0x7fffffffu : ~top);
  }
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    p[i] = lane + 32 * i < E ? expf(p[i] - mx) : 0.f;
    sum += p[i];
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(kFull, sum, w);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = lane + 32 * i;
    p[i] = col < E ? p[i] / sum : -INFINITY;
    if (probs != nullptr && col < E) probs[col] = p[i];
  }

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
    // the warp's: a probability's bits + 1 order as the probability, and the
    // masked (-1) and past-E (-inf) entries, key 0, below all; among equal
    // keys the lowest column
    const unsigned key = best >= 0.f ? __float_as_uint(best) + 1u : 0u;
    const unsigned top = __reduce_max_sync(kFull, key);
    best_col = static_cast<int>(
        __reduce_min_sync(kFull, key == top ? static_cast<unsigned>(best_col) : 0xffffffffu));
    best = __uint_as_float(top - 1u);   // k <= E, so some probability is left
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
    weights[lane] = mine_w / total;
    ids[lane] = mine_id;
  }
}

// ---------------------------------------------------------------------------
// moe_gating: logits in.  One warp per token row, eight rows per block; the
// loads of a warp are coalesced.
// ---------------------------------------------------------------------------

template <int NV>
__global__ void __launch_bounds__(NT)
moe_gating_kernel(const float* __restrict__ logits, float* __restrict__ weights,
                  int* __restrict__ ids, int T, int E, int k) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS + threadIdx.x / 32;
  if (row >= T) return;  // the whole warp leaves together
  const float* x = logits + static_cast<long long>(row) * E;
  float p[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = lane + 32 * i;
    p[i] = col < E ? x[col] : -INFINITY;
  }
  route_row<NV>(p, lane, E, k, weights + static_cast<long long>(row) * k,
                ids + static_cast<long long>(row) * k, nullptr);
}

// ---------------------------------------------------------------------------
// moe_router: x and the router in, the product fused in front.
// ---------------------------------------------------------------------------

constexpr int KC = 32;             // router rows (of D) per ring stage
constexpr int MAX_STAGES = 8;
constexpr int MAX_CLUSTER = 16;
constexpr int kBarBytes = 128;     // the stages' mbarriers, ahead of the ring
constexpr int kSmemBytes = 227 * 1024;
constexpr int DECODE_ROWS = 8;     // token rows of the decode kernel (T <= 8)
constexpr int DECODE_LOADS = 64;   // router values a thread of it has in flight

// Row i of the cluster's partial logits (each block's at P, row stride
// 32*NV) summed over the blocks in rank order, then routed.
template <int NV>
__device__ __forceinline__ void reduce_and_route(const cg::cluster_group& cluster,
                                                 const float* P, int i, int cs, int lane,
                                                 int E, int k, float* __restrict__ weights,
                                                 int* __restrict__ ids,
                                                 float* __restrict__ probs) {
  float p[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) p[j] = 0.f;
  for (int q0 = 0; q0 < cs; q0 += 4) {   // four ranks' loads in flight, summed in order
    float v[4][NV];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* src = cluster.map_shared_rank(P, min(q0 + q, cs - 1)) + i * 32 * NV + lane;
#pragma unroll
      for (int j = 0; j < NV; ++j) v[q][j] = q0 + q < cs ? src[32 * j] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < NV; ++j) p[j] += v[q][j];
  }
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (lane + 32 * j >= E) p[j] = -INFINITY;
  route_row<NV>(p, lane, E, k, weights + static_cast<long long>(i) * k,
                ids + static_cast<long long>(i) * k, probs + static_cast<long long>(i) * E);
}

// 16 bytes of x, as loaded, stored as f32: four floats or eight bf16 values
__device__ __forceinline__ void store_f32(float* dst, uint4 a, const float*) {
  *reinterpret_cast<uint4*>(dst) = a;
}
__device__ __forceinline__ void store_f32(float* dst, uint4 a, const __nv_bfloat16*) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(a.x << 16), __uint_as_float(a.x & 0xffff0000u),
                  __uint_as_float(a.y << 16), __uint_as_float(a.y & 0xffff0000u));
  *reinterpret_cast<float4*>(dst + 4) =
      make_float4(__uint_as_float(a.z << 16), __uint_as_float(a.z & 0xffff0000u),
                  __uint_as_float(a.w << 16), __uint_as_float(a.w & 0xffff0000u));
}

// x[r][d0 + c] in f32 into dst[r * ld + c] for r < R, c < C (C a multiple of
// 16 / sizeof(XT)); zeros where r >= rows or d0 + c >= D.  D and d0 are
// multiples of 8, so a 16-byte load is all inside D or all past it.  Eight
// loads of a thread are in flight before the first is stored.
template <typename XT>
__device__ __forceinline__ void load_x(float* dst, int ld, const XT* __restrict__ x, int D,
                                       int d0, int R, int C, int rows) {
  constexpr int V = 16 / sizeof(XT);
  constexpr int B = 8;
  const int per_row = C / V;
  const int n = R * per_row;
  for (int base = threadIdx.x; base < n; base += B * NT) {
    uint4 v[B];
#pragma unroll
    for (int q = 0; q < B; ++q) {
      const int i = base + q * NT;
      const int r = i / per_row, c = i % per_row * V;
      v[q] = i < n && r < rows && d0 + c < D
                 ? __ldg(reinterpret_cast<const uint4*>(x + static_cast<long long>(r) * D + d0 + c))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int q = 0; q < B; ++q) {
      const int i = base + q * NT;
      if (i < n) store_f32(dst + i / per_row * ld + i % per_row * V, v[q], x);
    }
  }
}

// Decode: grid (cluster), T <= 8.  Block r takes the router rows
// [r*Dc, (r+1)*Dc), Dc a multiple of 8; warp w takes the rows w, w+8, ...
// of them, U at a time (all U*NV loads of a thread issued before the first
// is used), and x's slice is filled, in f32 in shared memory, while the
// first loads are in flight.  The warps' partials meet in shared memory, in
// warp order.
template <int NV, typename XT>
__global__ void __launch_bounds__(NT)
moe_router_decode_kernel(const XT* __restrict__ x, const float* __restrict__ router,
                         float* __restrict__ weights, int* __restrict__ ids,
                         float* __restrict__ probs, int T, int D, int E, int k, int Dc) {
  constexpr int LDP = 32 * NV;
  constexpr int U = DECODE_LOADS / NV;
  extern __shared__ __align__(16) float fsmem[];
  float* wp = fsmem;                           // [warp][token row][LDP]
  float* P = wp + ROWS * DECODE_ROWS * LDP;    // [token row][LDP], the block's partial
  float* xs = P + DECODE_ROWS * LDP;           // [token row][Dc]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cs = static_cast<int>(cluster.num_blocks());
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d0 = rank * Dc;
  const int dn = max(0, min(Dc, D - d0));
  const float* rcol = router + static_cast<long long>(d0) * E + lane;

  float acc[DECODE_ROWS][NV];
#pragma unroll
  for (int t = 0; t < DECODE_ROWS; ++t)
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[t][j] = 0.f;
  for (int b = 0; b < Dc; b += ROWS * U) {
    float rv[U][NV];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int d = b + warp + ROWS * u;
        rv[u][j] = d < dn && lane + 32 * j < E
                       ? __ldg(rcol + static_cast<long long>(d) * E + 32 * j) : 0.f;
      }
    if (b == 0) {   // x's slice while the first router rows are in flight
      load_x(xs, Dc, x, D, d0, DECODE_ROWS, Dc, T);
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int d = min(b + warp + ROWS * u, Dc - 1);   // rv is 0 past dn
#pragma unroll
      for (int t = 0; t < DECODE_ROWS; ++t) {
        const float xv = xs[t * Dc + d];
#pragma unroll
        for (int j = 0; j < NV; ++j) acc[t][j] = fmaf(xv, rv[u][j], acc[t][j]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < DECODE_ROWS; ++t)
#pragma unroll
    for (int j = 0; j < NV; ++j) wp[(warp * DECODE_ROWS + t) * LDP + lane + 32 * j] = acc[t][j];
  __syncthreads();
  for (int e = threadIdx.x; e < T * LDP; e += NT) {
    float sum = wp[e];
    for (int w = 1; w < ROWS; ++w) sum += wp[w * DECODE_ROWS * LDP + e];
    P[e] = sum;
  }
  cluster.sync();
  for (int i = rank + warp * cs; i < T; i += ROWS * cs)
    reduce_and_route<NV>(cluster, P, i, cs, lane, E, k, weights, ids, probs);
  cluster.sync();   // no block leaves while another reads its shared memory
}

// Tile: grid (cluster, ceil(T/BM)).  Shared memory: the mbarriers, then
// `stages` router stages of KC*E + 32*NV floats (the tail pads the reads of
// lanes past E), then the x slab, (BM, per_block*KC) f32.  Block r takes
// chunks [c0, c0 + nc) of the ceil(D/KC); after the main loop the ring holds
// its (BM, 32*NV) partial logits.
template <int BM, int NV, typename XT>
__global__ void __launch_bounds__(NT)
moe_router_kernel(const XT* __restrict__ x, const float* __restrict__ router,
                  float* __restrict__ weights, int* __restrict__ ids, float* __restrict__ probs,
                  int T, int D, int E, int k, int chunks_per_block, int stages) {
  constexpr int RPW = BM / ROWS;   // token rows per warp
  constexpr int LDP = 32 * NV;     // row stride of the partial logits
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cs = static_cast<int>(cluster.num_blocks());
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * BM;
  const int rows = min(BM, T - row0);   // token rows of this tile
  const int c0 = rank * chunks_per_block;
  const int nc = max(0, min(chunks_per_block, (D + KC - 1) / KC - c0));
  const int xld = chunks_per_block * KC;   // the x slab's row stride

  const int r_stage = KC * E + LDP;     // floats
  float* rs = reinterpret_cast<float*>(smem + kBarBytes);
  float* xsl = rs + stages * r_stage;
  const uint32_t bar0 = smem_addr(smem);

  // chunk i of this block into stage i % stages, by lane 0 of warp 0
  auto issue = [&](int i) {
    const int s = i % stages;
    const int d0 = (c0 + i) * KC;
    const uint32_t bytes = min(KC, D - d0) * E * 4;
    mbar_expect(bar0 + 8 * s, bytes);
    bulk_load(smem_addr(rs + s * r_stage), router + static_cast<long long>(d0) * E, bytes,
              bar0 + 8 * s);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bar0 + 8 * s, 1);
    mbar_fence_init();
    for (int i = 0; i < min(stages, nc); ++i) issue(i);
  }
  // the x slab while the first chunks are in flight
  load_x(xsl, xld, x + static_cast<long long>(row0) * D, D, c0 * KC, BM, xld, rows);
  __syncthreads();

  float acc[RPW][NV];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[r][j] = 0.f;

  for (int i = 0; i < nc; ++i) {
    const int s = i % stages;
    mbar_wait_or_trap(bar0 + 8 * s, (i / stages) & 1);
    const int kv = min(KC, D - (c0 + i) * KC);   // a multiple of 8
    const float* R = rs + s * r_stage + lane;
    const float* X = xsl + warp * RPW * xld + i * KC;
#pragma unroll 2
    for (int kk = 0; kk < kv; kk += 4) {
      float4 xv[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) xv[r] = *reinterpret_cast<const float4*>(X + r * xld + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float rv[NV];
#pragma unroll
        for (int j = 0; j < NV; ++j) rv[j] = R[(kk + u) * E + 32 * j];
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const float xr = u == 0 ? xv[r].x : u == 1 ? xv[r].y : u == 2 ? xv[r].z : xv[r].w;
#pragma unroll
          for (int j = 0; j < NV; ++j) acc[r][j] = fmaf(xr, rv[j], acc[r][j]);
        }
      }
    }
    __syncthreads();   // every warp is done with stage s
    if (threadIdx.x == 0 && i + stages < nc) issue(i + stages);
  }

  // the partial logits, over the ring (every copy has landed and been read)
  float* P = rs;
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int j = 0; j < NV; ++j) P[(warp * RPW + r) * LDP + lane + 32 * j] = acc[r][j];
  cluster.sync();
  for (int i = rank + warp * cs; i < rows; i += ROWS * cs)
    reduce_and_route<NV>(cluster, P, i, cs, lane, E, k, weights + row0 * k, ids + row0 * k,
                         probs + static_cast<long long>(row0) * E);
  cluster.sync();   // no block leaves while another reads its shared memory
}

template <int NV>
cudaError_t launch_gating(const float* logits, float* weights, int* ids, int T, int E, int k,
                          cudaStream_t stream) {
  moe_gating_kernel<NV><<<(T + ROWS - 1) / ROWS, NT, 0, stream>>>(logits, weights, ids, T,
                                                                    E, k);
  return cudaGetLastError();
}

template <int BM, int NV, typename XT>
cudaError_t launch_router(const void* x, const float* router, float* weights, int* ids,
                          float* probs, int T, int D, int E, int k, int max_cluster,
                          cudaStream_t stream) {
  const int chunks = (D + KC - 1) / KC;
  const int blocks = std::min(max_cluster, chunks);
  const int per_block = (chunks + blocks - 1) / blocks;
  const int cs = (chunks + per_block - 1) / per_block;   // no block without a chunk
  // decode tiles keep every chunk in flight; prefill tiles leave room for a
  // second block on the SM
  const size_t ring = BM <= 16 ? 160 * 1024 : 96 * 1024;
  const size_t stage_bytes =
      (static_cast<size_t>(KC) * E + 32 * NV) * 4 + static_cast<size_t>(BM) * KC * sizeof(XT);
  const int stages =
      std::max(1, std::min({per_block, MAX_STAGES, static_cast<int>(ring / stage_bytes)}));
  const size_t partial = static_cast<size_t>(BM) * 32 * NV * 4;
  const size_t smem = kBarBytes + std::max(stages * stage_bytes, partial);
  auto kernel = moe_router_kernel<BM, NV, XT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (cs > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = cs;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, (T + BM - 1) / BM);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const XT*>(x), router, weights, ids,
                            probs, T, D, E, k, per_block, stages);
}

template <int BM, typename XT>
cudaError_t launch_router_nv(const void* x, const float* router, float* weights, int* ids,
                             float* probs, int T, int D, int E, int k, int max_cluster,
                             cudaStream_t s) {
  if (E <= 32)
    return launch_router<BM, 1, XT>(x, router, weights, ids, probs, T, D, E, k, max_cluster, s);
  if (E <= 64)
    return launch_router<BM, 2, XT>(x, router, weights, ids, probs, T, D, E, k, max_cluster, s);
  if (E <= 128)
    return launch_router<BM, 4, XT>(x, router, weights, ids, probs, T, D, E, k, max_cluster, s);
  return launch_router<BM, 8, XT>(x, router, weights, ids, probs, T, D, E, k, max_cluster, s);
}

cudaLaunchConfig_t cluster_launch(dim3 grid, int cluster_size, size_t smem,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster_size;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem, int cluster_size) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess && cluster_size > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

template <int NV, typename XT>
cudaError_t launch_decode(const void* x, const float* router, float* weights, int* ids,
                          float* probs, int T, int D, int E, int k, int cluster_size,
                          cudaStream_t stream) {
  const int Dc = ((D + cluster_size - 1) / cluster_size + 7) / 8 * 8;
  const size_t smem =
      (static_cast<size_t>(ROWS + 1) * DECODE_ROWS * 32 * NV + DECODE_ROWS * Dc) * 4;
  if (smem > kSmemBytes) return cudaErrorInvalidValue;
  auto kernel = moe_router_decode_kernel<NV, XT>;
  cudaError_t err = prepare(kernel, smem, cluster_size);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_launch(dim3(cluster_size), cluster_size, smem, stream,
                                                &attr);
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const XT*>(x), router, weights, ids,
                            probs, T, D, E, k, Dc);
}

template <int BM, int NV, typename XT>
cudaError_t launch_tile(const void* x, const float* router, float* weights, int* ids,
                        float* probs, int T, int D, int E, int k, int max_cluster,
                        cudaStream_t stream) {
  const int chunks = (D + KC - 1) / KC;
  const int blocks = std::min(max_cluster, chunks);
  const int per_block = (chunks + blocks - 1) / blocks;
  const int cs = (chunks + per_block - 1) / per_block;   // no block without a chunk
  const size_t slab = static_cast<size_t>(BM) * per_block * KC * 4;
  const size_t stage_bytes = (static_cast<size_t>(KC) * E + 32 * NV) * 4;
  const size_t room = kSmemBytes - kBarBytes - std::min<size_t>(slab, kSmemBytes - kBarBytes);
  const int stages = std::min({per_block, MAX_STAGES, static_cast<int>(room / stage_bytes)});
  const size_t partial = static_cast<size_t>(BM) * 32 * NV * 4;
  // the partial logits take the ring's (and maybe the slab's) place at the end
  const size_t smem = kBarBytes + std::max(stages * stage_bytes + slab, partial);
  if (stages < 1 || smem > kSmemBytes) return cudaErrorInvalidValue;
  auto kernel = moe_router_kernel<BM, NV, XT>;
  cudaError_t err = prepare(kernel, smem, cs);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_launch(dim3(cs, (T + BM - 1) / BM), cs, smem, stream,
                                                &attr);
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const XT*>(x), router, weights, ids,
                            probs, T, D, E, k, per_block, stages);
}

// rows 0: the decode kernel on one cluster of `cluster` blocks; else the
// tile kernel, `rows` token rows per cluster of at most `cluster` blocks
template <int NV, typename XT>
cudaError_t launch_router(const void* x, const float* router, float* weights, int* ids,
                          float* probs, int T, int D, int E, int k, int rows, int cluster,
                          cudaStream_t s) {
  switch (rows) {
    case 0:
      return launch_decode<NV, XT>(x, router, weights, ids, probs, T, D, E, k, cluster, s);
    case 16:
      return launch_tile<16, NV, XT>(x, router, weights, ids, probs, T, D, E, k, cluster, s);
    case 80:
      return launch_tile<80, NV, XT>(x, router, weights, ids, probs, T, D, E, k, cluster, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename XT>
cudaError_t launch_router_nv(const void* x, const float* router, float* weights, int* ids,
                             float* probs, int T, int D, int E, int k, int rows, int cluster,
                             cudaStream_t s) {
  if (E <= 32)
    return launch_router<1, XT>(x, router, weights, ids, probs, T, D, E, k, rows, cluster, s);
  if (E <= 64)
    return launch_router<2, XT>(x, router, weights, ids, probs, T, D, E, k, rows, cluster, s);
  if (E <= 128)
    return launch_router<4, XT>(x, router, weights, ids, probs, T, D, E, k, rows, cluster, s);
  return launch_router<8, XT>(x, router, weights, ids, probs, T, D, E, k, rows, cluster, s);
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
    case 1: return launch_gating<1>(x, w, id, T, E, k, s);
    case 2: return launch_gating<2>(x, w, id, T, E, k, s);
    case 3: return launch_gating<3>(x, w, id, T, E, k, s);
    case 4: return launch_gating<4>(x, w, id, T, E, k, s);
    case 5: return launch_gating<5>(x, w, id, T, E, k, s);
    case 6: return launch_gating<6>(x, w, id, T, E, k, s);
    case 7: return launch_gating<7>(x, w, id, T, E, k, s);
    default: return launch_gating<8>(x, w, id, T, E, k, s);
  }
}

// x (T,D) bf16 (x_is_bf16) or f32, router (D,E) f32, weights (T,k) f32, ids
// (T,k) int32 and probs (T,E) f32, all contiguous, x and the router 16-byte
// aligned; D % 8 == 0, 1 <= E <= 256, 1 <= k <= min(E, 32).  rows 0 (T <= 8):
// the decode kernel on one cluster of `cluster` (<= 16) blocks; rows 16 or
// 80: the tile kernel, clusters of at most `cluster` blocks.  Returns the
// launch's error (cudaErrorInvalidValue where a plan does not fit).
extern "C" int moe_router_fwd(const void* x, int x_is_bf16, const void* router, void* weights,
                              void* ids, void* probs, int device, int T, int D, int E, int k,
                              int rows, int cluster, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (T < 1 || D < 8 || D % 8 || E < 1 || E > 256 || k < 1 || k > E || k > 32 ||
      cluster < 1 || cluster > MAX_CLUSTER || (rows == 0 && T > DECODE_ROWS))
    return cudaErrorInvalidValue;
  const float* r = static_cast<const float*>(router);
  float* w = static_cast<float*>(weights);
  int* id = static_cast<int*>(ids);
  float* p = static_cast<float*>(probs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch_router_nv<__nv_bfloat16>(x, r, w, id, p, T, D, E, k, rows, cluster, s);
  return launch_router_nv<float>(x, r, w, id, p, T, D, E, k, rows, cluster, s);
}
