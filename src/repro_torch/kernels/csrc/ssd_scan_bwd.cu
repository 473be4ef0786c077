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
// Design.  Every (p, n) element has its own recurrence, and its loads do
// not depend on the walk: the kernel is a stream, and what it has to do is
// keep enough bytes in flight on every SM.  Two things stand in the way:
// d_decays[c] sums over all P*N elements of a (b, h) pair, and blocks run
// in no order, so a sum across blocks without atomics (the training path's
// bit-equal repeat and resume rest on there being none) needs either one
// block per pair (256 blocks at zamba2's block: two an SM, the walk done in
// two passes, each chunk behind a barrier) or a cluster.
//   - A (b, h) pair is split across a thread-block cluster of CL blocks
//     (grid (CL * H, B), cluster dims (CL, 1, 1)); block r takes the r-th
//     contiguous run of the pair's P*N elements, up to CAP = 1280 elements
//     (eight a consumer thread) per pass.  CL is the least of 1, 2, 4, 8
//     that holds the pair in one pass (4 at zamba2: 1024 blocks of 192
//     threads, 8 an SM, one resident wave on 132 SMs); above 8 * CAP the
//     blocks walk their runs in passes.
//   - Warp 0 is the producer: one thread streams the block's slice of
//     g_prefix[c] and prefix[c] (contiguous for one (b, c, h)) through a
//     ring of STAGES shared-memory stages, two TMA bulk copies a stage,
//     counted on a "full" mbarrier; the five consumer warps arrive on the
//     stage's "empty" mbarrier when they have read it, and the producer
//     refills it with the chunk STAGES steps later.  The consumers keep G in
//     registers, store d_states as 16-byte vectors, and never wait on each
//     other inside the walk.
//   - Each consumer warp writes its chunk sum to its own shared slot
//     part[c][warp].  At the end of a tile of up to TILE chunks (one tile
//     at zamba2's C = 4), one block barrier: the block sums its warps in
//     warp order; one cluster barrier: block r sums the block sums of the
//     tile's chunks j with j % CL == r over the cluster's ranks in rank
//     order (distributed shared memory) and writes d_decays.  Every sum has
//     one fixed order, so two calls give the same bits; d_decays is read
//     back only from the second pass on, by the thread that wrote it.
//   - The bulk copy needs 16-byte aligned addresses and a multiple of 16
//     bytes.  Where P*N % 4 != 0 (or a pointer is not 16-byte aligned) the
//     same kernel entry takes a path of its own: the consumers load their
//     elements with 4-byte loads, the next chunk's into a second set of
//     registers while this chunk's are used.
// The decays are loaded one step ahead by every consumer (a broadcast).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;
using namespace repro_torch::sm90;

namespace {

constexpr int CW = 5;                  // consumer warps
constexpr int NTC = 32 * CW;           // consumer threads
constexpr int NT = NTC + 32;           // and the producer warp, warp 0
constexpr int EPT = 8;                 // elements a consumer thread holds per pass
constexpr int CAP = NTC * EPT;         // elements of a (b, h) pair a block holds per pass
constexpr int STAGES = 2;
constexpr int TILE = 32;               // chunks reduced together
constexpr int MAX_CLUSTER = 8;
constexpr int kHeadBytes = 1024;       // mbarriers, part and blk, ahead of the ring
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) v += __shfl_xor_sync(kFull, v, w);
  return v;
}

// step n of the walk (n = pass * C + i) is chunk C - 1 - i: the walk runs
// backwards
__device__ __forceinline__ int chunk_of(int n, int C) { return C - 1 - n % C; }

// the gradient of the state entering a chunk from the one leaving it
__device__ __forceinline__ float carry(float a, float G, float gp) { return fmaf(a, G, gp); }

// Shared memory: the STAGES "full" and STAGES "empty" mbarriers; part
// [TILE][CW] at 128; blk [2][TILE] (the block's sums, double-buffered by
// tile) at 768; from kHeadBytes (TMA path only) the ring, STAGES stages of
// g_prefix then prefix, pl floats each.
template <bool kTma>
__global__ void __launch_bounds__(NT, kTma ? 8 : 4)
ssd_scan_bwd_kernel(const float* __restrict__ g_prefix, const float* __restrict__ g_final,
                    const float* __restrict__ prefix, const float* __restrict__ decays,
                    float* __restrict__ d_states, float* __restrict__ d_decays,
                    float* __restrict__ d_init, int C, int H, int PN, int per, int passes) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cs = static_cast<int>(cluster.num_blocks());
  const int h = blockIdx.x / cs;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t = threadIdx.x - 32;           // consumer thread (warp 0: negative)
  const int pl = min(per, CAP);             // elements of a pass: a stage's length
  const int lo = rank * per;                // this block's run [lo, hi) of P*N
  const int hi = min(PN, lo + per);
  const int steps = passes * C;
  const long long bh = static_cast<long long>(b) * H + h;
  const bool has_gf = g_final != nullptr;

  const uint32_t full0 = smem_addr(smem);
  const uint32_t empty0 = full0 + 8 * STAGES;
  float* part = reinterpret_cast<float*>(smem + 128);
  float* blk = part + TILE * CW;
  float* ring = reinterpret_cast<float*>(smem + kHeadBytes);

  // step n's first element e0 (of P*N) and its element count in this block
  auto span = [&](int n, int& e0) {
    e0 = lo + (n / C) * pl;
    return max(0, min(pl, hi - e0));
  };
  // offset of (b, c, h, 0) in (B, C, H, P*N), and of a[b, c, h]
  auto at = [&](int c) { return ((static_cast<long long>(b) * C + c) * H + h) * PN; };
  auto decay_at = [&](int n) {
    return n < steps ? decays[(static_cast<long long>(b) * C + chunk_of(n, C)) * H + h] : 0.f;
  };

  // step n's slices of g_prefix and prefix into stage n % STAGES (producer)
  auto issue = [&](int n) {
    const uint32_t full = full0 + 8 * (n % STAGES);
    int e0;
    const uint32_t bytes = 4u * span(n, e0);
    mbar_expect(full, 2 * bytes);
    if (bytes > 0) {
      const long long src = at(chunk_of(n, C)) + e0;
      float* st = ring + (n % STAGES) * 2 * pl;
      bulk_load(smem_addr(st), g_prefix + src, bytes, full);
      bulk_load(smem_addr(st + pl), prefix + src, bytes, full);
    }
  };

  if (kTma && threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CW);
    }
    mbar_fence_init();
    for (int n = 0; n < min(STAGES, steps); ++n) issue(n);
  }
  __syncthreads();

  // consumer thread t holds elements idx(k), k < EPT, of each pass: two
  // 16-byte vectors t and t + NTC on the TMA path, else t + k * NTC
  auto idx = [&](int k) { return kTma ? 4 * (t + (k / 4) * NTC) + k % 4 : t + k * NTC; };
  float G[EPT], cur_gp[EPT], cur_pf[EPT];   // the last two: the register path's
  auto load_regs = [&](int n, float* gp, float* pf) {
    int e0;
    const int cnt = span(n, e0);
    const long long off = at(chunk_of(n, C)) + e0;
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      const bool in = n < steps && idx(k) < cnt;
      gp[k] = in ? g_prefix[off + idx(k)] : 0.f;
      pf[k] = in ? prefix[off + idx(k)] : 0.f;
    }
  };
  float a = 0.f;
  if (warp > 0) {
    a = decay_at(0);
    if constexpr (!kTma) load_regs(0, cur_gp, cur_pf);
  }

  int par = 0;
  for (int p = 0; p < passes; ++p) {
    int e0;
    const int cnt = span(p * C, e0);
    if (warp > 0) {                         // G from g_final (zeros without it)
#pragma unroll
      for (int k = 0; k < EPT; k += 4) {
        if constexpr (kTma) {
          float4 g4 = make_float4(0.f, 0.f, 0.f, 0.f);
          if (has_gf && idx(k) < cnt)
            g4 = *reinterpret_cast<const float4*>(g_final + bh * PN + e0 + idx(k));
          G[k] = g4.x, G[k + 1] = g4.y, G[k + 2] = g4.z, G[k + 3] = g4.w;
        } else {
#pragma unroll
          for (int u = k; u < k + 4; ++u)
            G[u] = has_gf && idx(u) < cnt ? g_final[bh * PN + e0 + idx(u)] : 0.f;
        }
      }
    }
    for (int i0 = 0; i0 < C; i0 += TILE) {
      const int i1 = min(C, i0 + TILE);
      if (warp > 0) {
        for (int i = i0; i < i1; ++i) {
          const int n = p * C + i;
          const float a_next = decay_at(n + 1);
          const long long off = at(chunk_of(n, C)) + e0;
          float sum = 0.f;
          if constexpr (kTma) {
            const int s = n % STAGES;
            mbar_wait_or_trap(full0 + 8 * s, (n / STAGES) & 1);
            const float4* sg = reinterpret_cast<const float4*>(ring + s * 2 * pl);
            const float4* sp = reinterpret_cast<const float4*>(ring + s * 2 * pl + pl);
#pragma unroll
            for (int k = 0; k < EPT; k += 4) {
              if (idx(k) < cnt) {
                const float4 gp = sg[idx(k) / 4], pf = sp[idx(k) / 4];
                *reinterpret_cast<float4*>(d_states + off + idx(k)) =
                    make_float4(G[k], G[k + 1], G[k + 2], G[k + 3]);
                sum = fmaf(G[k], pf.x, sum);
                sum = fmaf(G[k + 1], pf.y, sum);
                sum = fmaf(G[k + 2], pf.z, sum);
                sum = fmaf(G[k + 3], pf.w, sum);
                G[k] = carry(a, G[k], gp.x);
                G[k + 1] = carry(a, G[k + 1], gp.y);
                G[k + 2] = carry(a, G[k + 2], gp.z);
                G[k + 3] = carry(a, G[k + 3], gp.w);
              }
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(empty0 + 8 * s);
          } else {
            float nx_gp[EPT], nx_pf[EPT];
            load_regs(n + 1, nx_gp, nx_pf);   // the next step's, in flight meanwhile
#pragma unroll
            for (int k = 0; k < EPT; ++k) {
              if (idx(k) < cnt) {
                d_states[off + idx(k)] = G[k];
                sum = fmaf(G[k], cur_pf[k], sum);
                G[k] = carry(a, G[k], cur_gp[k]);
              }
              cur_gp[k] = nx_gp[k];
              cur_pf[k] = nx_pf[k];
            }
          }
          sum = warp_sum(sum);
          if (lane == 0) part[(i - i0) * CW + warp - 1] = sum;
          a = a_next;
        }
      } else if (kTma && lane == 0) {       // refill each stage once it is read
        for (int n = p * C + i0; n < p * C + i1; ++n) {
          mbar_wait_or_trap(empty0 + 8 * (n % STAGES), (n / STAGES) & 1);
          if (n + STAGES < steps) issue(n + STAGES);
        }
      }

      // the tile's d_decays: warps in order, then ranks in order
      __syncthreads();
      const int tl = i1 - i0;
      if (threadIdx.x < tl) {
        float s = 0.f;
        for (int w = 0; w < CW; ++w) s += part[threadIdx.x * CW + w];
        blk[par * TILE + threadIdx.x] = s;
      }
      cluster.sync();
      for (int j = rank + cs * threadIdx.x; j < tl; j += cs * NT) {
        float s = 0.f;
        for (int q = 0; q < cs; ++q) s += cluster.map_shared_rank(blk + par * TILE, q)[j];
        const long long bch = (static_cast<long long>(b) * C + chunk_of(i0 + j, C)) * H + h;
        d_decays[bch] = p == 0 ? s : d_decays[bch] + s;
      }
      par ^= 1;   // the next tile writes the other half while this one is read
    }
    if (warp > 0 && d_init != nullptr) {
#pragma unroll
      for (int k = 0; k < EPT; k += 4) {
        if constexpr (kTma) {
          if (idx(k) < cnt)
            *reinterpret_cast<float4*>(d_init + bh * PN + e0 + idx(k)) =
                make_float4(G[k], G[k + 1], G[k + 2], G[k + 3]);
        } else {
#pragma unroll
          for (int u = k; u < k + 4; ++u)
            if (idx(u) < cnt) d_init[bh * PN + e0 + idx(u)] = G[u];
        }
      }
    }
  }
  cluster.sync();   // no block leaves while another reads its shared memory
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <bool kTma>
cudaError_t launch(const float* g_prefix, const float* g_final, const float* prefix,
                   const float* decays, float* d_states, float* d_decays, float* d_init,
                   int B, int C, int H, int PN, cudaStream_t stream) {
  int cs = 1;
  while (cs < MAX_CLUSTER && (PN + cs - 1) / cs > CAP) cs *= 2;
  int per = (PN + cs - 1) / cs;
  if (kTma) per = (per + 3) / 4 * 4;       // every run starts on 16 bytes
  const int pl = per < CAP ? per : CAP;
  const int passes = (per + pl - 1) / pl;
  if (static_cast<long long>(cs) * H > 0x7fffffff) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs * H, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = kHeadBytes + (kTma ? sizeof(float) * STAGES * 2 * pl : 0);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, ssd_scan_bwd_kernel<kTma>, g_prefix, g_final, prefix, decays,
                            d_states, d_decays, d_init, C, H, PN, per, passes);
}

}  // namespace

// g_prefix, prefix and d_states (B,C,H,P,N), decays and d_decays (B,C,H),
// g_final and d_init (B,H,P,N), each nullable (none: zeros in, nothing
// out): all f32 and contiguous.  Returns the launch's error.
extern "C" int ssd_scan_bwd(const void* g_prefix, const void* g_final, const void* prefix,
                            const void* decays, void* d_states, void* d_decays, void* d_init,
                            int device, int B, int C, int H, int P, int N, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 1 || C < 1 || H < 1 || P < 1 || N < 1 || B > 65535) return cudaErrorInvalidValue;
  const int PN = P * N;
  const bool tma = PN % 4 == 0 && aligned16(g_prefix) && aligned16(prefix) &&
                   aligned16(d_states) && aligned16(g_final) && aligned16(d_init);
  auto go = tma ? launch<true> : launch<false>;
  err = go(static_cast<const float*>(g_prefix), static_cast<const float*>(g_final),
           static_cast<const float*>(prefix), static_cast<const float*>(decays),
           static_cast<float*>(d_states), static_cast<float*>(d_decays),
           static_cast<float*>(d_init), B, C, H, PN, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}
