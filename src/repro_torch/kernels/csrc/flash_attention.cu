// Flash attention forward (causal or not, grouped-query) for Hopper, sm_90a.
//
// Replaces repro/kernels/flash_attention.py::flash_attention, the Pallas TPU
// kernel _attn_kernel.  It computes what repro/kernels/ref.py::attention_ref
// computes: q (B,Sq,H,hd), k/v (B,Sk,K,hd), query head h reads KV head
// h / (H/K), queries are the last Sq of the Sk key positions (causal offset
// Sk-Sq), softmax in f32, output in the dtype of q.  Inputs are read in
// place through their strides; ragged tails of Sq and Sk are masked, not
// asserted.  Masked scores take the oracle's -1e30; key rows past Sk take
// -inf, so they never count.  Head dims 64, 80 and 128.
//
// Bound on an H100 SXM: 4*B*H*hd*pairs FLOP (two products over the causal
// (query, key) pairs) at 989 TFLOP/s bf16, against 2*(2*|q| + |k| + |v|)
// bytes at 3.35 TB/s.  One qwen3-1.7b layer at S=1024 (H=16, K=8, hd 128)
// is bound by operations: 4.3 GFLOP, 4.35 us, against 12.6 MB, 3.8 us.
// zamba2's shared block (B=4, S=700, H=K=32, hd 80) is bound by bytes: 57 MB,
// 17.1 us, against 10 GFLOP, 10.2 us; one K/V head per query head leaves
// only ~10 FLOP per byte.
//
// bf16 design (the served path).  One warpgroup (128 threads) per 64 query
// rows of one (batch, head); a loop over 64-key tiles stops at the last tile
// the causal mask lets the block's rows see, and the query tiles with the
// most keys are launched first.
//  - Loads: TMA.  Thread 0 issues each 64 x 64 box of Q, K and V from a 4-D
//    tensor map (hd, S, heads, B) built on the host with the tensors' own
//    strides; the boxes land in 128-byte-swizzled shared memory (sm90.cuh)
//    and complete on mbarriers.  Out-of-range rows and columns come in as
//    zeros, so the ragged tails and HD 80's second column block need no
//    code.  K has a two-stage ring, loaded two tiles ahead of its product;
//    V two stages (one at HD 80), loaded one tile ahead.  The consumer
//    threads spend no instructions on addresses or copies.
//  - Q K^T: wgmma m64n64k16, Q and K both K-major in shared memory; the
//    64x64 scores stay in registers.  The next tile's Q K^T is issued
//    before this tile's softmax and runs on the tensor cores beside it.
//  - The online softmax runs in registers: a row lives on the four lanes of
//    a quad (two shuffles per reduction), ex2.approx of scores pre-scaled by
//    scale*log2(e), the row sums kept per thread until the end, and the
//    output rescaled only when a row max of the warp moved.
//  - P V: wgmma m64nNk16 with A = P from registers (the f32 score layout is
//    the bf16 A-operand layout, slice by slice) and B = V from shared memory,
//    stored [key][d], i.e. MN-major, read through the transpose bit.  N is
//    the head dim: 64, 80 (one product over both column blocks) or 128.
//  - The f32 output accumulator stays in registers for the whole key loop
//    and is written once, divided by the row sum.
// Not done yet: a producer warp with setmaxnreg, two consumer warpgroups
// sharing K/V tiles (GQA groups or 128-row tiles), overlapping P V with
// the next softmax, an output store through shared memory and TMA.

// Log-sum-exp.  With a non-null `lse` pointer both paths also write, for
// every query row, lse = log(sum_j exp(scale * s_j)) over the keys the row
// sees (natural log, of the scaled scores: the domain P = exp(scale * s - lse)
// is recomputed in by the backward, csrc/flash_attention_bwd.cu), f32,
// (B, H, Sq) contiguous.  Training passes it; serving passes null and runs
// exactly as before.

// f32 path (phase-2 checks only, not served): the products run on the CUDA
// cores in full f32, since TF32 would miss the f32 tolerance; one block of 4
// warps per 64 query rows keeps the softmax state and the accumulator in
// shared memory.

#include "common.cuh"
#include "sm90.cuh"
#include "tma_host.cuh"

using repro_torch::from_f32;
using repro_torch::kNegInf;
using repro_torch::Tile;
using repro_torch::tma::make_map;

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 128;  // threads per block: four warps

template <typename T, int HD>
struct AttnSmem {
  using TL = Tile<T, HD>;
  static constexpr int kLdS = BK + 4;        // scores, f32
  static constexpr int kLdP = BK + TL::kPad;  // probabilities, T
  static constexpr int kLdO = HD + 4;        // accumulator, f32
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(T) * BQ * TL::kLd;
  static constexpr size_t v = k + sizeof(T) * BK * TL::kLd;
  static constexpr size_t s = v + sizeof(T) * BK * TL::kLd;
  static constexpr size_t p = s + sizeof(float) * BQ * kLdS;
  static constexpr size_t o = p + sizeof(T) * BQ * kLdP;
  static constexpr size_t m = o + sizeof(float) * BQ * kLdO;
  static constexpr size_t l = m + sizeof(float) * BQ;
  static constexpr size_t corr = l + sizeof(float) * BQ;
  static constexpr size_t bytes = corr + sizeof(float) * BQ;
};

// S[rows of warp] = Q K^T, f32 path: lane computes key columns lane and
// lane+32 for the warp's 16 rows; Q reads are broadcasts.
template <int HD>
__device__ __forceinline__ void tile_scores(const float* Qs, const float* Ks, float* Ss,
                                            int warp, int lane) {
  using TL = Tile<float, HD>;
  using SM = AttnSmem<float, HD>;
  float acc[16][2];
#pragma unroll
  for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = 0.f;
  for (int d = 0; d < HD; d += 4) {
    const float4 k0 = *reinterpret_cast<const float4*>(Ks + lane * TL::kLd + d);
    const float4 k1 = *reinterpret_cast<const float4*>(Ks + (lane + 32) * TL::kLd + d);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float4 qv = *reinterpret_cast<const float4*>(Qs + (warp * 16 + r) * TL::kLd + d);
      acc[r][0] = fmaf(qv.x, k0.x, fmaf(qv.y, k0.y, fmaf(qv.z, k0.z, fmaf(qv.w, k0.w, acc[r][0]))));
      acc[r][1] = fmaf(qv.x, k1.x, fmaf(qv.y, k1.y, fmaf(qv.z, k1.z, fmaf(qv.w, k1.w, acc[r][1]))));
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    Ss[(warp * 16 + r) * SM::kLdS + lane] = acc[r][0];
    Ss[(warp * 16 + r) * SM::kLdS + lane + 32] = acc[r][1];
  }
}

// O[rows of warp] = O * corr + P V, f32 path: lane owns columns lane + 32i.
template <int HD>
__device__ __forceinline__ void tile_pv(const float* Ps, const float* Vs, float* Os,
                                        const float* Cs, int warp, int lane) {
  using TL = Tile<float, HD>;
  using SM = AttnSmem<float, HD>;
  constexpr int ND = (HD + 31) / 32;   // HD 80: the third column set is half used
  // column lane + 32i, clamped for the lanes past HD (their sums are dropped)
  int col[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) col[i] = min(lane + 32 * i, HD - 1);
  float acc[16][ND];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float c = Cs[warp * 16 + r];
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[r][i] = Os[(warp * 16 + r) * SM::kLdO + col[i]] * c;
  }
  for (int j = 0; j < BK; ++j) {
    float vv[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) vv[i] = Vs[j * TL::kLd + col[i]];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float p = Ps[(warp * 16 + r) * SM::kLdP + j];
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[r][i] = fmaf(p, vv[i], acc[r][i]);
    }
  }
  __syncwarp();  // every lane has read the clamped columns it shares
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int i = 0; i < ND; ++i)
      if (lane + 32 * i < HD) Os[(warp * 16 + r) * SM::kLdO + col[i]] = acc[r][i];
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                       int Sq, int Sk, int group,
                       long long qsb, long long qss, long long qsh, long long ksb,
                       long long kss, long long ksh, long long vsb, long long vss,
                       long long vsh, long long osb, long long oss, long long osh,
                       float scale, int causal) {
  using SM = AttnSmem<T, HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + SM::q);
  T* Ks = reinterpret_cast<T*>(smem + SM::k);
  T* Vs = reinterpret_cast<T*>(smem + SM::v);
  float* Ss = reinterpret_cast<float*>(smem + SM::s);
  T* Ps = reinterpret_cast<T*>(smem + SM::p);
  float* Os = reinterpret_cast<float*>(smem + SM::o);
  float* Ms = reinterpret_cast<float*>(smem + SM::m);
  float* Ls = reinterpret_cast<float*>(smem + SM::l);
  float* Cs = reinterpret_cast<float*>(smem + SM::corr);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int off = Sk - Sq;  // query row i sits at key position i + off

  repro_torch::load_rows<T, HD, NT>(Qs, q + b * qsb + q0 * qss + h * qsh, qss, BQ,
                                    min(BQ, Sq - q0));
  for (int i = threadIdx.x; i < BQ * SM::kLdO; i += NT) Os[i] = 0.f;
  if (threadIdx.x < BQ) {
    Ms[threadIdx.x] = kNegInf;
    Ls[threadIdx.x] = 0.f;
  }
  // keys [0, n_keys) are the only ones any row of this block can see
  const int n_keys = causal ? min(Sk, min(q0 + BQ, Sq) + off) : Sk;
  const int n_tiles = (n_keys + BK - 1) / BK;
  __syncthreads();

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    repro_torch::load_rows<T, HD, NT>(Ks, k + b * ksb + k0 * kss + kh * ksh, kss, BK,
                                      min(BK, Sk - k0));
    repro_torch::load_rows<T, HD, NT>(Vs, v + b * vsb + k0 * vss + kh * vsh, vss, BK,
                                      min(BK, Sk - k0));
    __syncthreads();
    tile_scores<HD>(Qs, Ks, Ss, warp, lane);
    __syncwarp();
    {
      // online softmax: two lanes per row, 32 columns each
      const int r = warp * 16 + lane / 2;
      const int c0 = (lane & 1) * 32;
      const int qpos = q0 + r + off;
      float sv[32];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int kpos = k0 + c0 + j;
        float x = Ss[r * SM::kLdS + c0 + j] * scale;
        if (causal && kpos > qpos) x = kNegInf;
        if (kpos >= Sk) x = -INFINITY;
        sv[j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float p = expf(sv[j] - m_new);
        Ps[r * SM::kLdP + c0 + j] = from_f32<T>(p);
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      __syncwarp();  // both lanes of a row have read Ms[r]
      if ((lane & 1) == 0) {
        const float corr = expf(m_old - m_new);
        Ms[r] = m_new;
        Ls[r] = Ls[r] * corr + sum;
        Cs[r] = corr;
      }
    }
    __syncwarp();
    tile_pv<HD>(Ps, Vs, Os, Cs, warp, lane);
    __syncthreads();  // K/V tiles are overwritten next
  }

  for (int i = threadIdx.x; i < BQ * HD; i += NT) {
    const int r = i / HD;
    const int d = i % HD;
    if (q0 + r < Sq)
      o[b * osb + (q0 + r) * oss + h * osh + d] = from_f32<T>(Os[r * SM::kLdO + d] / Ls[r]);
  }
  // Ms holds the max of the scaled scores, Ls the sum of exp(x - Ms)
  if (lse && threadIdx.x < BQ && q0 + threadIdx.x < Sq)
    lse[(static_cast<long long>(b) * gridDim.y + h) * Sq + q0 + threadIdx.x] =
        Ms[threadIdx.x] + logf(Ls[threadIdx.x]);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Sq, int Sk, int H, int K, const long long* st, float scale, int causal,
                   cudaStream_t stream) {
  using SM = AttnSmem<T, HD>;
  auto kernel = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SM::bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, SM::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Sq, Sk, H / K, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 path: one warpgroup per 64 query rows, wgmma for both products, the
// scores, probabilities and output accumulator in registers, K/V tiles
// brought by TMA into rings of shared memory ahead of their use.
// ---------------------------------------------------------------------------

namespace sm90 = repro_torch::sm90;
using bf16 = __nv_bfloat16;

// Shared memory of the bf16 kernel: Q, a ring of K tiles, a ring of V tiles,
// each a swizzled tile (sm90.cuh) of 64 rows, then the mbarriers.  HD 80 rows
// take two column blocks, the second holding columns 64-79 in its first 32
// bytes (TMA zero-fills the rest).
template <int HD>
struct Bf16Smem {
  static constexpr int kBlocks = (HD + 63) / 64;  // 64-wide column blocks
  static constexpr int kTile = kBlocks * BK * 128;
  // one V stage at HD 80 keeps a block at 65 KB, so three share an SM
  static constexpr int kVStages = HD == 80 ? 1 : 2;
  static_assert(BQ == BK, "Q and K/V tiles share one swizzled layout");
  static_assert(BK == repro_torch::tma::kBoxRows, "a tile is one box of the tensor map");
  static constexpr int q = 0;
  static constexpr int k = q + kTile;
  static constexpr int v = k + 2 * kTile;
  static constexpr int bars = v + kVStages * kTile;  // q, k[2], v[kVStages]
  static constexpr int bytes = bars + 64 + 1024;     // + slack to align to 1024
};

// K-major descriptor of k16 slice kk (columns 16kk..16kk+15) of a 64-row
// swizzled tile: column block kk/4, 32 bytes per slice inside the block.
__device__ __forceinline__ uint64_t kmajor_slice(uint32_t tile, int kk) {
  return sm90::desc_sw128(tile + (kk >> 2) * (BK * 128) + (kk & 3) * 32, 16, 1024);
}

// tq, tk, tv: (hd, S, heads, B) tensor maps of q, k, v (tma_host.cuh).
template <int HD>
__global__ void __launch_bounds__(NT)
attention_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                      float* __restrict__ lse, int Sq, int Sk, int H, int group,
                      long long osb, long long oss, long long osh,
                      float scale_log2, int causal) {
  using SM = Bf16Smem<HD>;
  constexpr int NO = HD / 2;  // output accumulators per thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (sm90::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base + SM::q;

  // blockIdx.y counts down the query tiles, so the tiles with the most keys
  // start first; blockIdx.x runs over heads, neighbours share a KV head.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int kh = h / group;
  const int off = Sk - Sq;  // query row i sits at key position i + off
  const int lane = threadIdx.x % 32;
  const int row = (threadIdx.x / 32) * 16 + lane / 4;  // this thread's rows: row, row + 8
  const int col = (lane % 4) * 2;                      // and columns col + 8j, +1
  // keys [0, n_keys) are the only ones any row of this block can see
  const int n_keys = causal ? min(Sk, min(q0 + BQ, Sq) + off) : Sk;
  const int n_tiles = (n_keys + BK - 1) / BK;

  // K tile t lives in stage t % 2 of its ring, V tile t in t % kVStages;
  // each stage has its mbarrier, whose phase flips once per tile it holds
  const uint32_t bar_q = base + SM::bars;
  auto bar_k = [&](int t) { return bar_q + 8 + (t & 1) * 8; };
  auto bar_v = [&](int t) { return bar_q + 24 + (t % SM::kVStages) * 8; };
  auto k_stage = [&](int t) { return base + SM::k + (t & 1) * SM::kTile; };
  auto v_stage = [&](int t) { return base + SM::v + (t % SM::kVStages) * SM::kTile; };
  auto load = [&](const CUtensorMap* map, uint32_t dst, uint32_t bar, int s0, int head) {
    sm90::mbar_expect(bar, SM::kTile);
#pragma unroll
    for (int cb = 0; cb < SM::kBlocks; ++cb)
      sm90::tma_load_4d(dst + cb * BK * 128, map, bar, cb * 64, s0, head, b);
  };
  // S = Q K^T for the K tile at sK, 64 x 64 over HD/16 slices of the head
  // dim; issued, not waited for
  auto issue_scores = [&](float* s, uint32_t sK) {
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      sm90::mma_ss_n64(s, kmajor_slice(sQ, kk), kmajor_slice(sK, kk), kk > 0);
    sm90::wgmma_commit();
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3 + SM::kVStages; ++i) sm90::mbar_init(bar_q + 8 * i, 1);
    sm90::mbar_fence_init();
    load(&tq, sQ, bar_q, q0, h);
    load(&tk, k_stage(0), bar_k(0), 0, kh);
    load(&tv, v_stage(0), bar_v(0), 0, kh);
    if (n_tiles > 1) load(&tk, k_stage(1), bar_k(1), BK, kh);
  }
  __syncthreads();
  float s[32];  // the scores of tile t
  sm90::mbar_wait(bar_q, 0);
  sm90::mbar_wait(bar_k(0), 0);
  issue_scores(s, k_stage(0));
  sm90::wgmma_wait_all();
  sm90::fence_regs<32>(s);

  float m[2] = {kNegInf, kNegInf};  // running max of each row, raw scores
  float l[2] = {0.f, 0.f};          // this thread's part of each row's sum
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    // every thread is done with K(t) and V(t-1): their stages take K(t+2)
    // and V(t + kVStages - 1)
    __syncthreads();
    if (threadIdx.x == 0) {
      if (t + 2 < n_tiles) load(&tk, k_stage(t + 2), bar_k(t + 2), k0 + 2 * BK, kh);
      const int vt = t + SM::kVStages - 1;  // V(t) itself with one stage
      if (vt > 0 && vt < n_tiles) load(&tv, v_stage(vt), bar_v(vt), vt * BK, kh);
    }

    // the next tile's scores run on the tensor cores during this softmax
    float s_next[32];
    if (t + 1 < n_tiles) {
      sm90::mbar_wait(bar_k(t + 1), ((t + 1) >> 1) & 1);
      issue_scores(s_next, k_stage(t + 1));
    }

    // masks, only on the tiles that reach past the diagonal or past Sk
    if ((causal && k0 + BK - 1 > q0 + off) || k0 + BK > Sk) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kpos = k0 + 8 * (i / 4) + col + (i & 1);
        const int qpos = q0 + row + 8 * ((i / 2) & 1) + off;
        if (causal && kpos > qpos) s[i] = kNegInf;
        if (kpos >= Sk) s[i] = -INFINITY;
      }
    }

    // online softmax: a row lives on the four lanes of a quad
    uint32_t p[4][4];  // P as bf16 pairs, the A operand of four k16 slices
    float corr[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = m[half];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * half], s[4 * j + 2 * half + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[half] = sm90::ex2((m[half] - mx) * scale_log2);
      const float mb = mx * scale_log2;
      m[half] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = sm90::ex2(fmaf(s[4 * j + 2 * half], scale_log2, -mb));
        const float p1 = sm90::ex2(fmaf(s[4 * j + 2 * half + 1], scale_log2, -mb));
        sum += p0 + p1;
        const __nv_bfloat162 pair = __floats2bfloat162_rn(p0, p1);
        p[j / 2][(j & 1) * 2 + half] = *reinterpret_cast<const uint32_t*>(&pair);
      }
      l[half] = l[half] * corr[half] + sum;
    }
    // rescale O unless no row max of the warp moved
    if (!__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) {
#pragma unroll
      for (int j = 0; j < NO / 4; ++j) {
        acc[4 * j] *= corr[0];
        acc[4 * j + 1] *= corr[0];
        acc[4 * j + 2] *= corr[1];
        acc[4 * j + 3] *= corr[1];
      }
    }

    // O += P V: V is [key][d], MN-major for this product; its column blocks
    // are BK * 128 bytes apart
    sm90::mbar_wait(bar_v(t), (t / SM::kVStages) & 1);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = sm90::desc_sw128(v_stage(t) + kk * 16 * 128, BK * 128, 1024);
      if constexpr (HD == 128)
        sm90::mma_rs_n128(acc, p[kk], dv);
      else if constexpr (HD == 80)
        sm90::mma_rs_n80(acc, p[kk], dv);
      else
        sm90::mma_rs_n64(acc, p[kk], dv);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs<NO>(acc);
    if (t + 1 < n_tiles) {
      sm90::fence_regs<32>(s_next);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = s_next[i];
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float sum = l[half];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / sum;
    const int r = q0 + row + 8 * half;
    if (r >= Sq) continue;
    // m is the row's max raw score; the sum is of 2^((s - m) * scale_log2)
    if (lse && (lane & 3) == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + r] =
          (m[half] * scale_log2 + log2f(sum)) * 0.6931471805599453f;
    bf16* orow = o + b * osb + r * oss + h * osh;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col) = __floats2bfloat162_rn(
          acc[4 * j + 2 * half] * inv, acc[4 * j + 2 * half + 1] * inv);
  }
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int Sq, int Sk, int H, int K, const long long* st, float scale,
                        int causal, cudaStream_t stream) {
  using SM = Bf16Smem<HD>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, HD, Sq, H, B, st[1], st[2], st[0]) ||
      !make_map(&tk, k, HD, Sk, K, B, st[4], st[5], st[3]) ||
      !make_map(&tv, v, HD, Sk, K, B, st[7], st[8], st[6]))
    return cudaErrorInvalidValue;
  auto kernel = attention_bf16_kernel<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SM::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(H * B, (Sq + BQ - 1) / BQ);
  kernel<<<grid, NT, SM::bytes, stream>>>(tq, tk, tv, static_cast<bf16*>(o), lse, Sq, Sk, H,
                                          H / K, st[9], st[10], st[11],
                                          scale * 1.4426950408889634f, causal);
  return cudaGetLastError();
}

}  // namespace

// strides: q (b, s, h), k (b, s, k), v (b, s, k), o (b, s, h), in elements;
// the head dim is contiguous.  lse: null, or (B, H, Sq) f32 to write the
// log-sum-exp into.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse_out, int is_bf16, int device, int B, int Sq,
                                   int Sk, int H, int K, int hd, int causal,
                                   const long long* strides, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  if (is_bf16 && hd == 128)
    return launch_bf16<128>(q, k, v, o, lse, B, Sq, Sk, H, K, strides, scale, causal, s);
  if (is_bf16 && hd == 80)
    return launch_bf16<80>(q, k, v, o, lse, B, Sq, Sk, H, K, strides, scale, causal, s);
  if (is_bf16 && hd == 64)
    return launch_bf16<64>(q, k, v, o, lse, B, Sq, Sk, H, K, strides, scale, causal, s);
  if (!is_bf16 && hd == 128)
    return launch<float, 128>(q, k, v, o, lse, B, Sq, Sk, H, K, strides, scale, causal, s);
  if (!is_bf16 && hd == 80)
    return launch<float, 80>(q, k, v, o, lse, B, Sq, Sk, H, K, strides, scale, causal, s);
  if (!is_bf16 && hd == 64)
    return launch<float, 64>(q, k, v, o, lse, B, Sq, Sk, H, K, strides, scale, causal, s);
  return cudaErrorInvalidValue;
}
