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

// f32 design (the training path of f32 models, e.g. lidc-100m; phase 14):
// the products run on the CUDA cores in exact f32 (TF32, or a 3xTF32 split
// on the tensor cores, would not be the reference's f32 arithmetic), so the
// bound is 4*B*H*hd*pairs FLOP at 67 TFLOP/s: 0.2564 ms for seamless's
// encoder layer (B=4, S=1024, H=K=16, hd 64, no mask), 0.0802 ms for a
// lidc-100m layer (B=4, S=1024, H=10, K=5, hd 64, causal).  A 16-byte
// shared-memory load costs the SM about four of its load cycles while the
// SM issues four warp FMAs a cycle, so a product keeps the FMA pipes busy
// only at ~16 FMAs a 16-byte load: the design is built around that.
//  - One block of 256 threads per 128 query rows: the 64 rows of a query
//    tile of two heads of one GQA group (even groups; each K/V tile is
//    loaded once for both heads), else 128 rows of one head.  The query
//    tiles with the most keys launch first; the key loop stops at the
//    causal diagonal.
//  - Register micro-tiles.  At hd 64 a key tile holds 128 keys: thread
//    (rg, kg) = (tid / 16, tid % 16) scores rows 8rg..8rg+7 against keys
//    kg + 16c, 8 x 8, reading per 4 of hd 8 Q chunks (broadcasts) and 8 K
//    chunks (rows padded 16 bytes: conflict-free); O += P V is split over
//    the tile's two 64-key halves, each half's 128 threads holding 8 rows x
//    8 columns (fma_tiles.cuh acc_xt_y), and the halves' sums are added at
//    the end.  Both products: 16 FMAs a 16-byte load.  At hd 80 and 128
//    (where 128-key tiles do not fit) a tile holds 64 keys: 8 x 4 scores
//    (10.7 FMAs a load), O 8 rows x hd/16 columns (10 at hd 80, 16 at 128).
//    On a causal tile whose upper 64 keys are all past the block's last
//    row, only its lower half is scored and multiplied (exact: the rest is
//    masked).
//  - The online softmax: a row's max over the 16 threads of its half-warp
//    by four xor-shuffles, exp2f of scores scaled by scale*log2(e), each
//    thread's part of the row sum reduced once at the end; each row's
//    rescale goes to the P V threads through shared memory, and O stays in
//    registers for the whole key loop.  P goes through shared memory
//    transposed, [key][row], so a thread's 8 rows of one key are two
//    16-byte loads.
//  - Q, K and V arrive by 16-byte cp.async: Q and K(0) first, then in each
//    key tile V(t) and K(t+1) are in flight while S(t) and its softmax run
//    (K in a two-stage ring, V in one stage).  Rows past Sq or Sk are
//    zero-filled and masked as in the bf16 path.  Two barriers a key tile.
// Registers (__launch_bounds__(256, 1), phase 1 prints them; 0 spill bytes
// is a gate): 253 at hd 64, 168 at 80, 218 at 128.  Shared memory 202.5 KiB
// at hd 64, 138.5 at 80, 198.5 at 128: one block, eight warps, per SM.

#include <type_traits>

#include "common.cuh"
#include "fma_tiles.cuh"
#include "sm90.cuh"
#include "tma_host.cuh"

using repro_torch::kNegInf;
using repro_torch::tma::make_map;

namespace {

constexpr int BQ = 64;   // query rows per block of the bf16 path
constexpr int BK = 64;   // keys per tile
constexpr int NT = 128;  // threads per block of the bf16 path: four warps

namespace f32 {

namespace fma = repro_torch::fma;
constexpr int ROWS = 128;       // query rows per block: one tile of two heads, or of one
constexpr int NT = 256;         // threads per block
constexpr int kLdP = ROWS + 4;  // P^T, [key][row]

// Tiles of one head dim.  At hd 64 a key tile holds 128 keys, so each
// thread's scores are 8 rows x 8 keys, and O += P V is split over the two
// 64-key halves, each half's 128 threads holding 8 rows x 8 columns (the
// halves' sums are added at the end, in that order): both products do 16
// FMAs a 16-byte load.  At hd 80 and 128 (where 128-key tiles do not fit
// shared memory) a key tile holds 64: scores 8 x 4 a thread, O 8 rows x
// hd/16 columns, no split.
template <int HD>
struct Plan {
  static constexpr int BK = HD == 64 ? 128 : 64;   // keys per tile
  static constexpr int NKC = BK / 16;              // keys a thread scores: kg + 16c
  static constexpr bool kSplit = BK == 128;        // P V over two key halves
  static constexpr int G = kSplit ? 8 : 16;        // column groups of P V
  using C = fma::Cols<HD, G>;
  static constexpr int kLd = fma::Rows<HD>::kLd;
  static constexpr size_t q = 0;                                   // [ROWS][kLd]
  static constexpr size_t k = q + sizeof(float) * ROWS * kLd;      // 2 x [BK][kLd]
  static constexpr size_t v = k + sizeof(float) * 2 * BK * kLd;    // [BK][kLd]
  static constexpr size_t p = v + sizeof(float) * BK * kLd;        // [BK][kLdP]
  static constexpr size_t corr = p + sizeof(float) * BK * kLdP;    // [ROWS]
  static constexpr size_t bytes = corr + sizeof(float) * ROWS;
  // the P V micro-tile of thread tid: rows 8x..8x+7, the columns of group
  // y, keys [key0, key0 + kKeys)
  __device__ __forceinline__ static int x(int tid) { return kSplit ? tid % 128 / 8 : tid / 16; }
  __device__ __forceinline__ static int y(int tid) { return tid % G; }
  __device__ __forceinline__ static int key0(int tid) { return kSplit ? 64 * (tid / 128) : 0; }
  static constexpr int kKeys = kSplit ? 64 : BK;
};

// pair: 2 where a block takes a 64-row query tile of two heads, 1 where it
// takes 128 rows of one head.  blockIdx.x = head slot + H/pair * batch,
// blockIdx.y counts the query tiles down.
template <int HD>
__global__ void __launch_bounds__(NT, 1)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int H, int group, int pair,
                     long long qsb, long long qss, long long qsh, long long ksb,
                     long long kss, long long ksh, long long vsb, long long vss,
                     long long vsh, long long osb, long long oss, long long osh,
                     float scale_log2, int causal) {
  using P = Plan<HD>;
  constexpr int LD = P::kLd;
  constexpr int BK = P::BK;
  constexpr int NKC = P::NKC;
  using C = typename P::C;
  constexpr int NO = C::N;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + P::q);
  float* Ks = reinterpret_cast<float*>(smem + P::k);
  float* Vs = reinterpret_cast<float*>(smem + P::v);
  float* Pt = reinterpret_cast<float*>(smem + P::p);
  float* corr_s = reinterpret_cast<float*>(smem + P::corr);

  const int QR = ROWS / pair;            // query positions of the block
  const int slots = H / pair;
  const int h0 = (blockIdx.x % slots) * pair;
  const int b = blockIdx.x / slots;
  const int kh = h0 / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * QR;
  const int off = Sk - Sq;               // query row i sits at key position i + off
  const int tid = threadIdx.x;
  const int rg = tid / 16;               // scores: rows 8rg..8rg+7
  const int kg = tid % 16;               // ... and keys kg + 16c
  const int pos0 = q0 + 8 * rg % QR;     // the position of the first of those rows
  const int px = P::x(tid), py = P::y(tid);   // P V: rows 8px.., columns of group py
  const int prow = 8 * px;
  // keys [0, n_keys) are the only ones any row of this block can see
  const int n_keys = causal ? min(Sk, min(q0 + QR, Sq) + off) : Sk;
  const int n_tiles = (n_keys + BK - 1) / BK;

  auto load_kv = [&](float* dst, const float* src, long long sb, long long ss, long long sh,
                     int k0) {
    fma::cp_rows<HD, BK, NT>(dst, [&](int r) -> const float* {
      return k0 + r < Sk ? src + b * sb + (k0 + r) * ss + kh * sh : nullptr;
    }, src);
  };
  fma::cp_rows<HD, ROWS, NT>(Qs, [&](int r) -> const float* {
    const int p = q0 + r % QR;
    return p < Sq ? q + b * qsb + p * qss + (h0 + r / QR) * qsh : nullptr;
  }, q);
  load_kv(Ks, k, ksb, kss, ksh, 0);
  fma::commit();

  float acc[8][NO];
  float m[8], l[8];  // running max (scaled by scale*log2 e) and this thread's part of the sum
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NO; ++c) acc[r][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    const float* Kt = Ks + (t & 1) * BK * LD;
    fma::wait<0>();   // K(t), and at t = 0 Q
    __syncthreads();  // ... seen by all; every thread is done with P V(t-1) and S(t-1)
    load_kv(Vs, v, vsb, vss, vsh, k0);
    fma::commit();
    if (t + 1 < n_tiles) load_kv(Ks + ((t + 1) & 1) * BK * LD, k, ksb, kss, ksh, k0 + BK);
    fma::commit();

    // S = Q K^T: 8 rows x keys kg + 16c; where the tile's upper 64 keys are
    // past every key the block sees (all masked), over its lower 64 alone
    float s[8][NKC];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < NKC; ++c) s[r][c] = 0.f;
    auto scores = [&](auto n_c) {
      constexpr int NC = decltype(n_c)::value;
#pragma unroll 2
      for (int d = 0; d < HD; d += 4) {
        float4 kv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          kv[c] = *reinterpret_cast<const float4*>(Kt + (kg + 16 * c) * LD + d);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float4 qv = *reinterpret_cast<const float4*>(Qs + (8 * rg + r) * LD + d);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            s[r][c] = fmaf(qv.x, kv[c].x, s[r][c]);
            s[r][c] = fmaf(qv.y, kv[c].y, s[r][c]);
            s[r][c] = fmaf(qv.z, kv[c].z, s[r][c]);
            s[r][c] = fmaf(qv.w, kv[c].w, s[r][c]);
          }
        }
      }
    };
    const bool upper = !P::kSplit || k0 + 64 < n_keys;
    if (upper)
      scores(std::integral_constant<int, NKC>{});
    else
      scores(std::integral_constant<int, NKC / 2>{});

    // online softmax; masks only on the tiles that reach past the
    // diagonal or past Sk
    const bool edge = (causal && k0 + BK - 1 > q0 + off) || k0 + BK > Sk;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int qpos = pos0 + r + off;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < NKC; ++c) {
        float x = s[r][c] * scale_log2;
        if (edge) {
          const int kpos = k0 + kg + 16 * c;
          if (causal && kpos > qpos) x = kNegInf;
          if (kpos >= Sk) x = -INFINITY;
        }
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[r], mx);
      const float corr = exp2f(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < NKC; ++c) {
        s[r][c] = exp2f(s[r][c] - m_new);
        sum += s[r][c];
      }
      l[r] = l[r] * corr + sum;
      if (kg == 0) corr_s[8 * rg + r] = corr;
    }
#pragma unroll
    for (int c = 0; c < NKC; ++c) {
      float* row = Pt + (kg + 16 * c) * kLdP + 8 * rg;
      *reinterpret_cast<float4*>(row) = make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
      *reinterpret_cast<float4*>(row + 4) = make_float4(s[4][c], s[5][c], s[6][c], s[7][c]);
    }
    fma::wait<1>();   // V(t); K(t+1) may still be in flight
    __syncthreads();  // P, the rows' rescales and V(t) seen by all

    // O = O * corr + P V over this thread's keys
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float c = corr_s[prow + r];
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[r][i] *= c;
    }
    if (upper || P::key0(tid) == 0)   // the upper half's P is all zeros otherwise
      fma::acc_xt_y<HD, P::G>(Pt, kLdP, Vs, acc, px, py, P::key0(tid), P::kKeys);
  }

  // row sums; the log-sum-exp; 1 / sum for the P V threads (in corr_s)
  float* inv_s = corr_s;
  fma::wait<0>();
  __syncthreads();  // every thread is done with the last tile's corr_s, K, V and P
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float sum = l[r];
#pragma unroll
    for (int w = 1; w < 16; w <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
    if (kg != 0) continue;
    inv_s[8 * rg + r] = 1.f / sum;
    // m is the row's max scaled score in log2 units; the sum is of 2^(x - m)
    const int pos = pos0 + r;
    if (lse && pos < Sq)
      lse[(static_cast<long long>(b) * H + h0 + 8 * rg / QR) * Sq + pos] =
          (m[r] + log2f(sum)) * fma::kLn2;
  }
  if constexpr (P::kSplit) {  // the second key half's sums, added to the first's
    float* Os = Ks;           // [ROWS][kLd]
    if (tid >= 128)
#pragma unroll
      for (int r = 0; r < 8; ++r) C::store(Os + (prow + r) * LD, py, acc[r], 1.f);
    __syncthreads();
    if (tid >= 128) return;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float other[NO];
      C::load(Os + (prow + r) * LD, py, other);
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[r][i] += other[i];
    }
  } else {
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int pos = q0 + (prow + r) % QR;
    if (pos < Sq)
      C::store(o + b * osb + pos * oss + (h0 + (prow + r) / QR) * osh, py, acc[r],
               inv_s[prow + r]);
  }
}

cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Sq, int Sk, int H, int K, int hd, const long long* st, float scale,
                   int causal, cudaStream_t stream) {
  auto go = [&](auto kernel, size_t bytes) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    const int group = H / K;
    const int pair = group % 2 == 0 ? 2 : 1;
    dim3 grid(H / pair * B, (Sq + ROWS / pair - 1) / (ROWS / pair));
    kernel<<<grid, NT, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Sk, H, group, pair,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
        scale * fma::kLog2e, causal);
    return cudaGetLastError();
  };
  if (hd == 128) return go(attention_f32_kernel<128>, Plan<128>::bytes);
  if (hd == 80) return go(attention_f32_kernel<80>, Plan<80>::bytes);
  if (hd == 64) return go(attention_f32_kernel<64>, Plan<64>::bytes);
  return cudaErrorInvalidValue;
}

}  // namespace f32

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
  if (!is_bf16)
    return f32::launch(q, k, v, o, lse, B, Sq, Sk, H, K, hd, strides, scale, causal, s);
  return cudaErrorInvalidValue;
}
