// Flash attention backward, bf16 path, for Hopper (sm_90a).
//
// What it computes is set out in flash_attention_bwd.cu, which holds the
// C entry, D = rowsum(dO * O) and the f32 path, and launches the two
// kernels below for bf16 inputs: from q, k, v, dO and the forward's
// natural-log LSE,
//   P = exp(scale * Q K^T - lse)  (0 where the forward masked),
//   dV = P^T dO,  dS = P * (dO V^T - D),  dK = scale * dS^T Q,
//   dQ = scale * dS K,
// summed over the query heads of each KV head's group, sums in f32, outputs
// bf16; hd 64, 80 and 128, any group, ragged tails, strided views.
//
// Bound on an H100 SXM: five products over the causal (query, key) pairs,
// 10*B*H*hd*pairs FLOP at 989 TFLOP/s; one qwen3-1.7b training layer (B=4,
// S=1024, H=16, K=8, hd 128) is bound by operations: 43 GFLOP, 43.5 us.
// The two passes below run seven products (S and dP in both), 60 GFLOP.
//
// Design: right and simple first, in the forward's pattern
// (flash_attention.cu): one warpgroup of 128 threads per 64-row tile, every
// product a wgmma with f32 accumulators in registers, tiles brought by TMA
// (thread 0 issues) into 128-byte-swizzled shared memory (sm90.cuh) and
// counted on mbarriers.
//  1. bwd_dkdv_sm90_kernel: one block per (64-key tile, KV head, batch), the
//     longest tiles first.  K and V land once.  The block walks every
//     (query head of the group, query tile that sees its keys) pair; each
//     pair's Q and dO tiles stream through a two-stage ring, the next pair's
//     in flight during this pair's products.  With keys as the M rows,
//     S^T = K Q^T and dP^T = V dO^T are K-major x K-major (mma_ss), and the
//     f32 accumulator layout of P^T and dS^T is the bf16 A-operand layout of
//     dV += P^T dO and dK += dS^T Q, whose B (dO, Q: [query][d]) is read
//     MN-major through the transpose bit, as the forward reads V.  dK and dV
//     stay in registers over the whole loop and are written once: the
//     group's sum stays inside the block, no atomics, bit-repeatable.
//  2. bwd_dq_sm90_kernel: one block per (64-row query tile, head, batch).  Q
//     and dO land once; K and V stream through a two-stage ring over the key
//     tiles the rows see.  S = Q K^T and dP = dO V^T (mma_ss), dS in
//     registers, dQ += dS K (K read MN-major); dQ is written once.
// TMA's zero fill is not a mask: rows past Sq and keys past Sk come in as
// zeros, so P is set to 0 in registers for query >= Sq, key >= Sk and, when
// causal, key > query + Sk - Sq, on the tile pairs that reach an edge.  The
// LSE and D rows are read with plain loads (their rows start at any float).
// Not done yet: a producer warp with setmaxnreg, overlapping one pair's
// score products with the last pair's accumulating ones, two consumer
// warpgroups sharing K/V tiles.

#include "sm90.cuh"
#include "tma_host.cuh"

namespace {

namespace sm90 = repro_torch::sm90;
using bf16 = __nv_bfloat16;
using repro_torch::tma::make_map;

constexpr int BT = 64;   // rows of a query tile and of a key tile
constexpr int NT = 128;  // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;
static_assert(BT == repro_torch::tma::kBoxRows, "a tile is one box of the tensor map");

// Shared memory of both kernels: two resident tiles (K and V, or Q and dO),
// a two-stage ring of two tiles a stage (Q and dO, or K and V), each tile
// swizzled (sm90.cuh) with 64 rows; then the LSE (times log2 e) and D of
// each stage's query rows (dK/dV pass), and the mbarriers: resident tiles,
// stage 0, stage 1.  HD 80 rows take two column blocks, the second holding
// columns 64-79 (TMA zero-fills the rest).
template <int HD>
struct Smem {
  static constexpr int kBlocks = (HD + 63) / 64;  // 64-wide column blocks
  static constexpr int kTile = kBlocks * BT * 128;
  static constexpr int fixed = 0;
  static constexpr int ring = fixed + 2 * kTile;
  static constexpr int rows = ring + 4 * kTile;  // lse2[2][BT], then D[2][BT], f32
  static constexpr int bars = rows + 4 * BT * 4;
  static constexpr int bytes = bars + 24 + 1024;  // + slack to align to 1024
};

// TMA: the 64-row box of (sequence position s0, head, batch b) of a tensor
// map, every column block, into the swizzled tile at dst; counted on bar.
template <int HD>
__device__ __forceinline__ void load_tile(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                          int s0, int head, int b) {
#pragma unroll
  for (int cb = 0; cb < Smem<HD>::kBlocks; ++cb)
    sm90::tma_load_4d(dst + cb * BT * 128, map, bar, cb * 64, s0, head, b);
}

// K-major descriptor of k16 slice kk (columns 16kk..16kk+15) of a 64-row
// swizzled tile: column block kk/4, 32 bytes per slice inside the block.
__device__ __forceinline__ uint64_t kmajor_slice(uint32_t tile, int kk) {
  return sm90::desc_sw128(tile + (kk >> 2) * (BT * 128) + (kk & 3) * 32, 16, 1024);
}

// MN-major descriptor of rows 16kk..16kk+15 of a 64-row swizzled tile, read
// as the B operand [k = row][n = column]; column blocks BT * 128 bytes apart.
__device__ __forceinline__ uint64_t mnmajor_rows(uint32_t tile, int kk) {
  return sm90::desc_sw128(tile + kk * 16 * 128, BT * 128, 1024);
}

// d (64 x 64) = A B^T over the HD/16 k16 slices of two 64-row tiles, both
// K-major; issued, not committed.
template <int HD>
__device__ __forceinline__ void issue_scores(float* d, uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    sm90::mma_ss_n64(d, kmajor_slice(a, kk), kmajor_slice(b, kk), kk > 0);
}

// acc (64 x HD) += A (64 x 64, four k16 slices of bf16 pairs in registers)
// times the 64-row tile b read MN-major; issued, not committed.
template <int HD>
__device__ __forceinline__ void issue_acc(float* acc, const uint32_t (&a)[4][4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    if constexpr (HD == 128)
      sm90::mma_rs_n128(acc, a[kk], mnmajor_rows(b, kk));
    else if constexpr (HD == 80)
      sm90::mma_rs_n80(acc, a[kk], mnmajor_rows(b, kk));
    else
      sm90::mma_rs_n64(acc, a[kk], mnmajor_rows(b, kk));
  }
}

// A 64 x 64 f32 accumulator (sm90.cuh's layout) as the bf16 A operand of
// four k16 slices.
__device__ __forceinline__ void to_operand(const float* x, uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(x[4 * j + 2 * half],
                                                        x[4 * j + 2 * half + 1]);
      a[j / 2][(j & 1) * 2 + half] = *reinterpret_cast<const uint32_t*>(&pair);
    }
}

// Whether query row qi (of Sq) sees key kj (of Sk): what the forward masked.
__device__ __forceinline__ bool visible(int qi, int kj, int Sq, int Sk, int off, int causal) {
  return qi < Sq && kj < Sk && !(causal && kj > qi + off);
}

// dS = P * (dP - D).
__device__ __forceinline__ float dscore(float p, float dp, float d) { return p * (dp - d); }

// tq, tk, tv, tdo: (hd, S, heads, B) tensor maps of q, k, v and dO
// (tma_host.cuh).  lse, D: (B, H, Sq) f32.
template <int HD>
__global__ void __launch_bounds__(NT)
bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                     const float* __restrict__ D, bf16* __restrict__ dk, bf16* __restrict__ dv,
                     int Sq, int Sk, int H, int group, long long dksb, long long dkss,
                     long long dksh, long long dvsb, long long dvss, long long dvsh,
                     float scale_log2, float scale, int causal) {
  using SM = Smem<HD>;
  constexpr int NO = HD / 2;  // accumulators per thread, each of dK and dV
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  float* rows = reinterpret_cast<float*>(smem_raw + (base - raw) + SM::rows);

  // blockIdx.y runs over key tiles from the first, which most query rows
  // see; blockIdx.x over KV heads, then batches
  const int n_kv = H / group;
  const int kh = blockIdx.x % n_kv;
  const int b = blockIdx.x / n_kv;
  const int k0 = blockIdx.y * BT;
  const int off = Sk - Sq;  // query row i sits at key position i + off
  const int lane = threadIdx.x % 32;
  const int row = (threadIdx.x / 32) * 16 + lane / 4;  // this thread's keys: row, row + 8
  const int col = (lane % 4) * 2;                      // and queries col + 8j, +1
  // query rows i with i + off >= k0 are the only ones that see a key here
  const int first = causal ? max(0, k0 - off) / BT : 0;
  const int n_qtiles = (Sq + BT - 1) / BT;
  const int nq = n_qtiles - first;
  const int n_pairs = group * nq;  // (query head, query tile) pairs, head-major

  const uint32_t sK = base + SM::fixed;
  const uint32_t sV = sK + SM::kTile;
  const uint32_t bar_kv = base + SM::bars;
  auto bar = [&](int s) { return bar_kv + 8 + 8 * s; };
  auto q_stage = [&](int s) { return base + SM::ring + s * 2 * SM::kTile; };
  auto do_stage = [&](int s) { return q_stage(s) + SM::kTile; };
  // pair p: query head kh * group + p / nq, query tile first + p % nq, in
  // stage p % 2 of the ring
  auto load_pair = [&](int p) {
    const int s = p & 1;
    const int h = kh * group + p / nq;
    const int q0 = (first + p % nq) * BT;
    sm90::mbar_expect(bar(s), 2 * SM::kTile);
    load_tile<HD>(&tq, q_stage(s), bar(s), q0, h, b);
    load_tile<HD>(&tdo, do_stage(s), bar(s), q0, h, b);
  };
  // every thread: one LSE (times log2 e) or D value of pair p's query rows
  auto load_rows = [&](int p) {
    const int s = p & 1;
    const int h = kh * group + p / nq;
    const int i = threadIdx.x % BT;
    const int qi = (first + p % nq) * BT + i;
    const bool is_d = threadIdx.x >= BT;
    float x = 0.f;
    if (qi < Sq) {
      const long long at = (static_cast<long long>(b) * H + h) * Sq + qi;
      x = is_d ? D[at] : lse[at] * kLog2e;
    }
    rows[(is_d ? 2 * BT : 0) + s * BT + i] = x;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) sm90::mbar_init(bar_kv + 8 * i, 1);
    sm90::mbar_fence_init();
    sm90::mbar_expect(bar_kv, 2 * SM::kTile);
    load_tile<HD>(&tk, sK, bar_kv, k0, kh, b);
    load_tile<HD>(&tv, sV, bar_kv, k0, kh, b);
    load_pair(0);
    if (n_pairs > 1) load_pair(1);
  }
  load_rows(0);
  __syncthreads();

  float acc_dk[NO], acc_dv[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  sm90::mbar_wait(bar_kv, 0);

  for (int p = 0; p < n_pairs; ++p) {
    const int s = p & 1;
    const int q0 = (first + p % nq) * BT;
    if (p + 1 < n_pairs) load_rows(p + 1);

    // S^T = K Q^T and dP^T = V dO^T, keys as rows
    float st[32], dpt[32];
    sm90::mbar_wait(bar(s), (p >> 1) & 1);
    sm90::wgmma_fence();
    issue_scores<HD>(st, sK, q_stage(s));
    issue_scores<HD>(dpt, sV, do_stage(s));
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs<32>(st);
    sm90::fence_regs<32>(dpt);

    // P^T and dS^T in place; the mask only on pairs that reach an edge
    const bool edge = q0 + BT > Sq || k0 + BT > Sk || (causal && k0 + BT - 1 > q0 + off);
    const float* lse2 = rows + s * BT;
    const float* d_row = rows + 2 * BT + s * BT;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qc = 8 * j + col;
      const float2 l2 = *reinterpret_cast<const float2*>(lse2 + qc);
      const float2 dd = *reinterpret_cast<const float2*>(d_row + qc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        float pr = sm90::ex2(fmaf(st[i], scale_log2, -((e & 1) ? l2.y : l2.x)));
        if (edge && !visible(q0 + qc + (e & 1), k0 + row + 8 * (e >> 1), Sq, Sk, off, causal))
          pr = 0.f;
        st[i] = pr;
        dpt[i] = dscore(pr, dpt[i], (e & 1) ? dd.y : dd.x);
      }
    }

    // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major
    uint32_t pa[4][4], dsa[4][4];
    to_operand(st, pa);
    to_operand(dpt, dsa);
    sm90::wgmma_fence();
    issue_acc<HD>(acc_dv, pa, do_stage(s));
    issue_acc<HD>(acc_dk, dsa, q_stage(s));
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs<NO>(acc_dv);
    sm90::fence_regs<NO>(acc_dk);

    // every thread is done with stage s (tiles, LSE and D), and pair p + 1's
    // rows are written: stage s takes pair p + 2
    __syncthreads();
    if (threadIdx.x == 0 && p + 2 < n_pairs) load_pair(p + 2);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = k0 + row + 8 * half;
    if (r >= Sk) continue;
    bf16* krow = dk + b * dksb + r * dkss + kh * dksh;
    bf16* vrow = dv + b * dvsb + r * dvss + kh * dvsh;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(krow + 8 * j + col) = __floats2bfloat162_rn(
          acc_dk[4 * j + 2 * half] * scale, acc_dk[4 * j + 2 * half + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * j + col) = __floats2bfloat162_rn(
          acc_dv[4 * j + 2 * half], acc_dv[4 * j + 2 * half + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(NT)
bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                   const float* __restrict__ D, bf16* __restrict__ dq, int Sq, int Sk, int H,
                   int group, long long dqsb, long long dqss, long long dqsh, float scale_log2,
                   float scale, int causal) {
  using SM = Smem<HD>;
  constexpr int NO = HD / 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (sm90::smem_addr(smem_raw) + 1023) & ~1023u;

  // blockIdx.y counts down the query tiles, so the tiles with the most keys
  // start first; blockIdx.x runs over heads, neighbours share a KV head
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BT;
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int kh = h / group;
  const int off = Sk - Sq;
  const int lane = threadIdx.x % 32;
  const int row = (threadIdx.x / 32) * 16 + lane / 4;  // this thread's queries: row, row + 8
  const int col = (lane % 4) * 2;                      // and keys col + 8j, +1
  // keys [0, n_keys) are the only ones any row of this tile sees
  const int n_keys = causal ? min(Sk, min(q0 + BT, Sq) + off) : Sk;
  const int n_tiles = (n_keys + BT - 1) / BT;

  const uint32_t sQ = base + SM::fixed;
  const uint32_t sdO = sQ + SM::kTile;
  const uint32_t bar_qd = base + SM::bars;
  auto bar = [&](int s) { return bar_qd + 8 + 8 * s; };
  auto k_stage = [&](int s) { return base + SM::ring + s * 2 * SM::kTile; };
  auto v_stage = [&](int s) { return k_stage(s) + SM::kTile; };
  // key tile t in stage t % 2 of the ring
  auto load_kv = [&](int t) {
    const int s = t & 1;
    sm90::mbar_expect(bar(s), 2 * SM::kTile);
    load_tile<HD>(&tk, k_stage(s), bar(s), t * BT, kh, b);
    load_tile<HD>(&tv, v_stage(s), bar(s), t * BT, kh, b);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) sm90::mbar_init(bar_qd + 8 * i, 1);
    sm90::mbar_fence_init();
    sm90::mbar_expect(bar_qd, 2 * SM::kTile);
    load_tile<HD>(&tq, sQ, bar_qd, q0, h, b);
    load_tile<HD>(&tdo, sdO, bar_qd, q0, h, b);
    load_kv(0);
    if (n_tiles > 1) load_kv(1);
  }
  // the LSE (times log2 e) and D of this thread's two query rows
  float lse2[2], d_row[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + row + 8 * half;
    const long long at = (static_cast<long long>(b) * H + h) * Sq + qi;
    lse2[half] = qi < Sq ? lse[at] * kLog2e : 0.f;
    d_row[half] = qi < Sq ? D[at] : 0.f;
  }
  __syncthreads();

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  sm90::mbar_wait(bar_qd, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1;
    const int k0 = t * BT;

    // S = Q K^T and dP = dO V^T
    float sc[32], dp[32];
    sm90::mbar_wait(bar(s), (t >> 1) & 1);
    sm90::wgmma_fence();
    issue_scores<HD>(sc, sQ, k_stage(s));
    issue_scores<HD>(dp, sdO, v_stage(s));
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs<32>(sc);
    sm90::fence_regs<32>(dp);

    // dS in place of dP; the mask only on tiles that reach an edge
    const bool edge = q0 + BT > Sq || k0 + BT > Sk || (causal && k0 + BT - 1 > q0 + off);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int half = (i >> 1) & 1;
      float pr = sm90::ex2(fmaf(sc[i], scale_log2, -lse2[half]));
      if (edge && !visible(q0 + row + 8 * half, k0 + 8 * (i / 4) + col + (i & 1), Sq, Sk, off,
                           causal))
        pr = 0.f;
      dp[i] = dscore(pr, dp[i], d_row[half]);
    }

    // dQ += dS K, K read MN-major
    uint32_t dsa[4][4];
    to_operand(dp, dsa);
    sm90::wgmma_fence();
    issue_acc<HD>(acc, dsa, k_stage(s));
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs<NO>(acc);

    // every thread is done with stage s: it takes key tile t + 2
    __syncthreads();
    if (threadIdx.x == 0 && t + 2 < n_tiles) load_kv(t + 2);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = q0 + row + 8 * half;
    if (r >= Sq) continue;
    bf16* qrow = dq + b * dqsb + r * dqss + h * dqsh;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(qrow + 8 * j + col) = __floats2bfloat162_rn(
          acc[4 * j + 2 * half] * scale, acc[4 * j + 2 * half + 1] * scale);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* D, void* dq, void* dk, void* dv, int B,
                   int Sq, int Sk, int H, int K, const long long* st, float scale, int causal,
                   cudaStream_t stream) {
  using SM = Smem<HD>;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, HD, Sq, H, B, st[1], st[2], st[0]) ||
      !make_map(&tk, k, HD, Sk, K, B, st[4], st[5], st[3]) ||
      !make_map(&tv, v, HD, Sk, K, B, st[7], st[8], st[6]) ||
      !make_map(&tdo, dout, HD, Sq, H, B, st[13], st[14], st[12]))
    return cudaErrorInvalidValue;
  const float scale_log2 = scale * kLog2e;
  auto dkdv = bwd_dkdv_sm90_kernel<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, SM::bytes);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3(K * B, (Sk + BT - 1) / BT), NT, SM::bytes, stream>>>(
      tq, tk, tv, tdo, lse, D, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk, H,
      H / K, st[18], st[19], st[20], st[21], st[22], st[23], scale_log2, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = bwd_dq_sm90_kernel<HD>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, SM::bytes);
  if (err != cudaSuccess) return err;
  dqk<<<dim3(H * B, (Sq + BT - 1) / BT), NT, SM::bytes, stream>>>(
      tq, tk, tv, tdo, lse, D, static_cast<bf16*>(dq), Sq, Sk, H, H / K, st[15], st[16],
      st[17], scale_log2, scale, causal);
  return cudaGetLastError();
}

}  // namespace

namespace repro_torch {

// The dK/dV and dQ kernels of the bf16 path, after D; arguments as
// flash_attention_bwd (flash_attention_bwd.cu).
cudaError_t attention_bwd_sm90(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* D, void* dq, void* dk, void* dv,
                               int B, int Sq, int Sk, int H, int K, int hd,
                               const long long* strides, float scale, int causal,
                               cudaStream_t stream) {
  if (hd == 128)
    return launch<128>(q, k, v, dout, lse, D, dq, dk, dv, B, Sq, Sk, H, K, strides, scale,
                       causal, stream);
  if (hd == 80)
    return launch<80>(q, k, v, dout, lse, D, dq, dk, dv, B, Sq, Sk, H, K, strides, scale,
                      causal, stream);
  if (hd == 64)
    return launch<64>(q, k, v, dout, lse, D, dq, dk, dv, B, Sq, Sk, H, K, strides, scale,
                      causal, stream);
  return cudaErrorInvalidValue;
}

}  // namespace repro_torch
