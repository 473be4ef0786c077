// Flash attention backward (causal or not, grouped-query) for Hopper, sm_90a.
//
// The Pallas TPU kernel (repro/kernels/flash_attention.py::flash_attention)
// has no backward of its own: the JAX package trains by differentiating its
// jnp oracle (repro/kernels/ops.py routes to repro/kernels/ref.py::
// attention_ref).  This is the gradient of the port's forward kernel
// (csrc/flash_attention.cu), from the log-sum-exp that the forward saved:
// for q (B,Sq,H,hd), k/v (B,Sk,K,hd), o and dO (B,Sq,H,hd), lse (B,H,Sq),
//   P  = exp(scale * Q K^T - lse)        (0 where the forward masked)
//   D  = rowsum(dO * O)
//   dV = P^T dO,  dS = P * (dO V^T - D),  dK = scale * dS^T Q,
//   dQ = scale * dS K,
// summed over the query heads of each KV head's group.  The same strides,
// head dims (64, 80, 128), ragged tails and causal offset Sk - Sq as the
// forward; a key the forward masked (kNegInf for the causal mask, -inf past
// Sk) has P = 0 here.  All sums in f32; dq, dk, dv in the inputs' dtype.
//
// Bound on an H100 SXM: five products over the causal (query, key) pairs,
// 10*B*H*hd*pairs FLOP (2.5x the forward), at 989 TFLOP/s bf16 or 67 TFLOP/s
// f32, against the bytes of q, k, v, o, dO read once and dq, dk, dv written
// once.  One qwen3-1.7b layer of the training step (B=4, S=1024, H=16, K=8,
// hd 128) is bound by operations: 43 GFLOP, 43.5 us in bf16.
//
// Three launches, in both paths:
//  1. bwd_dot_kernel: D = rowsum(dO * O) in f32, one warp per row.
//  2. dK/dV per (64-key tile, KV head, batch): the block walks every query
//     head of the group and every query tile that can see its keys,
//     recomputes P and dS for the tile pair and accumulates dV and dK in
//     registers.  The group's sum stays inside the block: no atomics, so a
//     step is bit-repeatable.
//  3. dQ per query tile (bf16: 64 rows of one head; f32: below), over the
//     key tiles its rows see (the forward's loop).
// bf16 (the training path): passes 2 and 3 are the wgmma kernels of
// flash_attention_bwd_sm90.cu (TMA rings, accumulators in registers).
// f32 (the training path of f32 models, e.g. lidc-100m; phase 14): passes 2
// and 3 below, the products on the CUDA cores in exact f32 (no TF32), so
// the bound is the five products' FLOP at 67 TFLOP/s: 0.6411 ms for
// seamless's encoder layer (B=4, S=1024, H=K=16, hd 64, no mask), 0.2005 ms
// for a lidc-100m layer (H=10, K=5, causal).  The two passes recompute S
// and dP (seven products where the gradient needs five): that is the price
// of summing dK, dV and dQ without atomics, in a fixed order, so that a
// step is bit-repeatable (the resume gates rely on it).  As in the forward
// (csrc/flash_attention.cu), a product keeps the FMA pipes busy only at
// ~16 FMAs a 16-byte shared-memory load, so the micro-tiles are as large
// as registers and shared memory allow.  QS = 128 query rows at hd 64 and
// 80, 64 at hd 128:
//  - Both passes: S and dP in one fused register-tiled pass over hd
//    (two_scores), 4 x 8 or 8 x 4 of each a thread, 10.7 FMAs a load (8 at
//    hd 128); P = exp2(S*scale*log2 e - lse*log2 e) and dS = P (dP - D) go
//    to shared memory once, transposed so that each product reads 16-byte
//    rows; the products run 8 x 8 micro-tiles a thread (fma_tiles.cuh
//    acc_xt_y, 16 FMAs a load).
//  - dK/dV (pass 2), one block per (64-key tile, KV head, batch), QS query
//    rows a step: S^T and dP^T for keys 4ti.., queries tj + 16c; then four
//    groups of 64 threads accumulate dV = P^T dO and dK = dS^T Q, each over
//    one half of the step's queries (two groups of 128 over all 64 at hd
//    128), 8 keys x 8 columns a thread in registers; the halves' sums are
//    added at the end.  The block walks the group's heads, then the query
//    rows that see its keys, in that fixed order.  Q, dO, lse and D come by
//    cp.async (16 bytes; 4 for lse and D, whose rows need not start on 16
//    bytes) into one stage, reloaded after each step's products: two
//    stages of 128 rows do not fit beside P and dS.
//  - dQ (pass 3), one block per QS query rows (a 64-row tile of two heads
//    of an even group, else QS rows of one head), over the key tiles they
//    see: S and dP 8 x 4 a thread (rows 8rg.., keys kg + 16c; lse and D in
//    registers), then dQ = dS K split over each tile's two 32-key halves,
//    8 rows x 8 columns a thread, the halves' sums added at the end.  K and
//    V come by cp.async through a two-stage ring.
//  - D = rowsum(dO * O) stays a pass of its own (bwd_dot_kernel, shared with
//    bf16): pass 2 runs before pass 3 and needs D for every query tile of
//    the group, so folding it into pass 3 would come too late, and into
//    pass 2 would recompute it once per key tile.
// Registers (__launch_bounds__(256, 1); phase 1 prints them, 0 spill bytes
// is a gate): pass 2 216 / 232 / 168 and pass 3 230 / 239 / 214 at hd 64 /
// 80 / 128.  Shared memory (pass 2 171 / 195 / 166.5 KiB, pass 3 170 / 202
// / 215.5 KiB) leaves one block, eight warps, per SM.

#include <type_traits>

#include "common.cuh"
#include "fma_tiles.cuh"

namespace repro_torch {
// Passes 2 and 3 of the bf16 path (flash_attention_bwd_sm90.cu).
cudaError_t attention_bwd_sm90(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* D, void* dq, void* dk, void* dv,
                               int B, int Sq, int Sk, int H, int K, int hd,
                               const long long* strides, float scale, int causal,
                               cudaStream_t stream);
}  // namespace repro_torch

namespace {

constexpr int BT = 64;   // rows per query tile and per key tile

struct Str {  // element strides of a (B, S, heads, hd) tensor
  long long b, s, h;
};

Str str3(const long long* st) { return Str{st[0], st[1], st[2]}; }

// Pass 1: D[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d], one warp a row.
template <typename T>
__global__ void __launch_bounds__(256)
bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ D,
               int B, int Sq, int H, int hd, Str so, Str sd) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (row >= static_cast<long long>(B) * H * Sq) return;
  const int lane = threadIdx.x % 32;
  const int i = row % Sq;
  const int h = (row / Sq) % H;
  const int b = row / (static_cast<long long>(Sq) * H);
  const T* orow = o + b * so.b + i * so.s + h * so.h;
  const T* drow = dout + b * sd.b + i * sd.s + h * sd.h;
  float sum = 0.f;
  for (int d = lane; d < hd; d += 32)
    sum = fmaf(repro_torch::to_f32(orow[d]), repro_torch::to_f32(drow[d]), sum);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
  if (lane == 0) D[row] = sum;
}

namespace f32 {

namespace fma = repro_torch::fma;
constexpr int NT = 256;   // threads per block of passes 2 and 3

// QS query rows per step of pass 2 and per block of pass 3: 128 where they
// fit shared memory (hd 64, 80), else 64.
template <int HD>
constexpr int kQS = HD == 128 ? 64 : 128;

// The S and dP of a tile pair, fused over hd: s[r][c] = A[NA ti + r] .
// B[tj + 16c] and t[r][c] = C[NA ti + r] . Dm[tj + 16c], for tiles A, C of
// 16 NA rows and B, Dm of 16 NB rows, hd columns each.  Per 4 of hd a thread
// loads 2 (NA + NB) 16-byte chunks for 8 NA NB FMAs, holding the smaller of
// the two sets in registers while it streams the other.  (A, B, C, Dm) =
// (Q, K, dO, V) in pass 3; (K, Q, V, dO) in pass 2, which so computes S^T
// and dP^T.  The sum over hd runs in the forward's order.
template <int HD, int NA, int NB>
__device__ __forceinline__ void two_scores(const float* A, const float* Bm, const float* C,
                                           const float* Dm, float (&s)[NA][NB],
                                           float (&t)[NA][NB], int ti, int tj) {
  constexpr int LD = fma::Rows<HD>::kLd;
  constexpr bool kHoldA = NA <= NB;
  constexpr int NH = kHoldA ? NA : NB;   // the chunks held
  constexpr int NS = kHoldA ? NB : NA;   // the chunks streamed
#pragma unroll
  for (int r = 0; r < NA; ++r)
#pragma unroll
    for (int c = 0; c < NB; ++c) s[r][c] = t[r][c] = 0.f;
  auto fma4 = [](float& acc, const float4& a, const float4& b) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    acc = fmaf(a.w, b.w, acc);
  };
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 h1[NH], h2[NH];
#pragma unroll
    for (int u = 0; u < NH; ++u) {
      const int row = kHoldA ? NA * ti + u : tj + 16 * u;
      h1[u] = *reinterpret_cast<const float4*>((kHoldA ? A : Bm) + row * LD + d);
      h2[u] = *reinterpret_cast<const float4*>((kHoldA ? C : Dm) + row * LD + d);
    }
#pragma unroll
    for (int w = 0; w < NS; ++w) {
      const int row = kHoldA ? tj + 16 * w : NA * ti + w;
      const float4 s1 = *reinterpret_cast<const float4*>((kHoldA ? Bm : A) + row * LD + d);
      const float4 s2 = *reinterpret_cast<const float4*>((kHoldA ? Dm : C) + row * LD + d);
#pragma unroll
      for (int u = 0; u < NH; ++u) {
        if constexpr (kHoldA) {
          fma4(s[u][w], h1[u], s1);
          fma4(t[u][w], h2[u], s2);
        } else {
          fma4(s[w][u], h1[u], s1);
          fma4(t[w][u], h2[u], s2);
        }
      }
    }
  }
}

// P and dS of one score element: s the raw score, dp = dO . V, lse2 the
// row's log-sum-exp in log2 units, d its D; seen false where the forward
// masked (causal, past Sk) or past Sq: P = dS = 0.
__device__ __forceinline__ void prob_and_dscore(float s, float dp, float lse2, float d,
                                                bool seen, float scale_log2, float& p,
                                                float& ds) {
  p = seen ? exp2f(fmaf(s, scale_log2, -lse2)) : 0.f;
  ds = p * (dp - d);
}

template <int HD>
struct DkdvSmem {
  static constexpr int QS = kQS<HD>;
  static constexpr int kLdT = BT + 4;                          // P, dS: [query][key]
  static constexpr size_t kRow = sizeof(float) * fma::Rows<HD>::kLd;
  static constexpr size_t k = 0;                               // [BT][kLd]
  static constexpr size_t v = k + BT * kRow;
  static constexpr size_t q = v + BT * kRow;                   // [QS][kLd]
  static constexpr size_t dout = q + QS * kRow;
  static constexpr size_t p = dout + QS * kRow;                // [QS][kLdT]
  static constexpr size_t ds = p + sizeof(float) * QS * kLdT;
  static constexpr size_t lse = ds + sizeof(float) * QS * kLdT;
  static constexpr size_t d = lse + sizeof(float) * QS;
  static constexpr size_t bytes = d + sizeof(float) * QS;
};

// Pass 2: dK and dV of one 64-key tile of one KV head, summed over the
// group's query heads and every query row that sees the keys, QS rows a
// step.
template <int HD>
__global__ void __launch_bounds__(NT, 1)
bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ D,
                    float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H,
                    int group, Str sq, Str sk, Str sv, Str sd, Str sdk, Str sdv,
                    float scale_log2, float scale, int causal) {
  using SM = DkdvSmem<HD>;
  constexpr int QS = SM::QS;
  constexpr int LD = fma::Rows<HD>::kLd;
  constexpr int kLdT = SM::kLdT;
  // the products: NR threads groups, dV or dK over one of NR / 2 parts of a
  // step's queries; each thread 8 keys x the columns of its group
  constexpr int NR = QS == 128 ? 4 : 2;
  constexpr int TPR = NT / NR;               // threads a group
  constexpr int G = TPR / 8;                 // column groups (8 groups of 8 keys)
  constexpr int QPART = QS / (NR / 2);       // queries a part: 64
  using C = fma::Cols<HD, G>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem + SM::k);
  float* Vs = reinterpret_cast<float*>(smem + SM::v);
  float* Qs = reinterpret_cast<float*>(smem + SM::q);
  float* dOs = reinterpret_cast<float*>(smem + SM::dout);
  float* Ps = reinterpret_cast<float*>(smem + SM::p);
  float* dSs = reinterpret_cast<float*>(smem + SM::ds);
  float* lse_s = reinterpret_cast<float*>(smem + SM::lse);
  float* D_s = reinterpret_cast<float*>(smem + SM::d);

  const int k0 = blockIdx.x * BT;   // the first tiles see the most queries: they start first
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int off = Sk - Sq;          // query row i sits at key position i + off
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;   // scores: keys 4ti.., queries tj + 16c
  const int role = threadIdx.x / TPR;
  const bool for_dk = role >= NR / 2;
  const int part = role % (NR / 2);
  const int x = threadIdx.x % TPR / G, y = threadIdx.x % G;  // products: keys 8x.., columns of y

  // query rows i with i + off >= k0 are the only ones that see a key here;
  // step p is rows q_first + QS (p % nq) .. of head kh * group + p / nq
  const int q_first = causal ? max(0, k0 - off) / BT * BT : 0;
  const int nq = Sq > q_first ? (Sq - q_first + QS - 1) / QS : 0;
  const int n_steps = group * nq;

  auto rows_of = [&](const float* src, Str st, int s0, int head, int valid) {
    return [=](int r) -> const float* {
      return s0 + r < valid ? src + b * st.b + (s0 + r) * st.s + head * st.h : nullptr;
    };
  };
  auto issue = [&](int p) {
    const int h = kh * group + p / nq;
    const int q0 = q_first + p % nq * QS;
    fma::cp_rows<HD, QS, NT>(Qs, rows_of(q, sq, q0, h, Sq), q);
    fma::cp_rows<HD, QS, NT>(dOs, rows_of(dout, sd, q0, h, Sq), dout);
    if (threadIdx.x < QS) {
      const long long at = (static_cast<long long>(b) * H + h) * Sq + q0 + threadIdx.x;
      const bool ok = q0 + static_cast<int>(threadIdx.x) < Sq;
      fma::cp4(lse_s + threadIdx.x, ok ? lse + at : lse, ok);
      fma::cp4(D_s + threadIdx.x, ok ? D + at : D, ok);
    }
  };

  fma::cp_rows<HD, BT, NT>(Ks, rows_of(k, sk, k0, kh, Sk), k);
  fma::cp_rows<HD, BT, NT>(Vs, rows_of(v, sv, k0, kh, Sk), v);
  if (n_steps > 0) issue(0);
  fma::commit();

  float acc[8][C::N];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < C::N; ++c) acc[r][c] = 0.f;

  for (int p = 0; p < n_steps; ++p) {
    const int q0 = q_first + p % nq * QS;
    fma::wait<0>();   // this step's tiles (and at p = 0 K and V)
    __syncthreads();  // ... seen by all

    // S^T and dP^T: keys 4ti + r, queries tj + 16c
    float s[4][QS / 16], dp[4][QS / 16];
    two_scores<HD, 4, QS / 16>(Ks, Qs, Vs, dOs, s, dp, ti, tj);
#pragma unroll
    for (int c = 0; c < QS / 16; ++c) {
      const int i = tj + 16 * c;
      const int qpos = q0 + i + off;
      const float lse2 = lse_s[i] * fma::kLog2e;
      const float d = D_s[i];
      float pv[4], dsv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kpos = k0 + 4 * ti + r;
        const bool seen = q0 + i < Sq && kpos < Sk && !(causal && kpos > qpos);
        prob_and_dscore(s[r][c], dp[r][c], lse2, d, seen, scale_log2, pv[r], dsv[r]);
      }
      *reinterpret_cast<float4*>(Ps + i * kLdT + 4 * ti) =
          make_float4(pv[0], pv[1], pv[2], pv[3]);
      *reinterpret_cast<float4*>(dSs + i * kLdT + 4 * ti) =
          make_float4(dsv[0], dsv[1], dsv[2], dsv[3]);
    }
    __syncthreads();  // P and dS seen by all

    // dV += P^T dO, dK += dS^T Q, over this thread's part of the queries
    if (for_dk)
      fma::acc_xt_y<HD, G>(dSs, kLdT, Qs, acc, x, y, part * QPART, QPART);
    else
      fma::acc_xt_y<HD, G>(Ps, kLdT, dOs, acc, x, y, part * QPART, QPART);
    __syncthreads();  // every thread is done with the step's tiles
    if (p + 1 < n_steps) issue(p + 1);
    fma::commit();
  }
  fma::wait<0>();     // K and V, where no query sees the keys
  __syncthreads();

  // the parts' sums, added in a fixed order: part 1's through shared memory
  if constexpr (NR == 4) {
    float* sum_s = Qs + (for_dk ? BT * LD : 0);   // [BT][kLd] for dV, the next for dK
    if (part == 1)
#pragma unroll
      for (int r = 0; r < 8; ++r) C::store(sum_s + (8 * x + r) * LD, y, acc[r], 1.f);
    __syncthreads();
    if (part == 1) return;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float other[C::N];
      C::load(sum_s + (8 * x + r) * LD, y, other);
#pragma unroll
      for (int c = 0; c < C::N; ++c) acc[r][c] += other[c];
    }
  }
  const Str so = for_dk ? sdk : sdv;
  float* out = (for_dk ? dk : dv) + b * so.b + kh * so.h;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int key = k0 + 8 * x + r;
    if (key < Sk) C::store(out + key * so.s, y, acc[r], for_dk ? scale : 1.f);
  }
}

template <int HD>
struct DqSmem {
  static constexpr int QS = kQS<HD>;
  static constexpr int kLdS = QS + 4;                          // dS^T: [key][row]
  static constexpr size_t kRow = sizeof(float) * fma::Rows<HD>::kLd;
  static constexpr size_t q = 0;                               // [QS][kLd]
  static constexpr size_t dout = q + QS * kRow;
  static constexpr size_t k = dout + QS * kRow;                // 2 stages of [BT][kLd]
  static constexpr size_t v = k + 2 * BT * kRow;               // 2 stages
  static constexpr size_t ds = v + 2 * BT * kRow;              // [BT][kLdS]
  static constexpr size_t lse = ds + sizeof(float) * BT * kLdS;
  static constexpr size_t d = lse + sizeof(float) * QS;
  static constexpr size_t bytes = d + sizeof(float) * QS;
};

// Pass 3: dQ of QS query rows (a 64-row query tile of two heads of one
// GQA group, or QS rows of one head), over the key tiles they see.
// blockIdx.x = head slot + H/pair * batch, blockIdx.y counts the query
// tiles down (the tiles with the most keys start first).
template <int HD>
__global__ void __launch_bounds__(NT, 1)
bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ D,
                  float* __restrict__ dq, int Sq, int Sk, int H, int group, int pair, Str sq,
                  Str sk, Str sv, Str sd, Str sdq, float scale_log2, float scale, int causal) {
  using SM = DqSmem<HD>;
  constexpr int QS = SM::QS;
  constexpr int RPT = QS / 16;               // score rows a thread
  constexpr int LD = fma::Rows<HD>::kLd;
  constexpr int kLdS = SM::kLdS;
  // dQ += dS K: two key halves of 128 threads, each thread 8 rows x the
  // columns of its group
  constexpr int G = 128 / (QS / 8);
  using C = fma::Cols<HD, G>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + SM::q);
  float* dOs = reinterpret_cast<float*>(smem + SM::dout);
  float* Ks = reinterpret_cast<float*>(smem + SM::k);
  float* Vs = reinterpret_cast<float*>(smem + SM::v);
  float* dSt = reinterpret_cast<float*>(smem + SM::ds);
  float* lse_s = reinterpret_cast<float*>(smem + SM::lse);
  float* D_s = reinterpret_cast<float*>(smem + SM::d);

  const int QR = QS / pair;                  // query positions of the block
  const int slots = H / pair;
  const int h0 = (blockIdx.x % slots) * pair;
  const int b = blockIdx.x / slots;
  const int kh = h0 / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * QR;
  const int off = Sk - Sq;
  const int rg = threadIdx.x / 16, kg = threadIdx.x % 16;   // scores: rows RPT rg.., keys kg + 16c
  const int half = threadIdx.x / 128;                       // dQ: keys 32 half..
  const int x = threadIdx.x % 128 / G, y = threadIdx.x % G;  // ... rows 8x.., columns of y

  auto row_src = [&](const float* src, Str st) {
    return [=](int r) -> const float* {
      const int pos = q0 + r % QR;
      return pos < Sq ? src + b * st.b + pos * st.s + (h0 + r / QR) * st.h : nullptr;
    };
  };
  auto issue_kv = [&](int t) {
    const int k0 = t * BT;
    auto key_src = [&](const float* src, Str st) {
      return [=](int r) -> const float* {
        return k0 + r < Sk ? src + b * st.b + (k0 + r) * st.s + kh * st.h : nullptr;
      };
    };
    fma::cp_rows<HD, BT, NT>(Ks + (t & 1) * BT * LD, key_src(k, sk), k);
    fma::cp_rows<HD, BT, NT>(Vs + (t & 1) * BT * LD, key_src(v, sv), v);
  };
  fma::cp_rows<HD, QS, NT>(Qs, row_src(q, sq), q);
  fma::cp_rows<HD, QS, NT>(dOs, row_src(dout, sd), dout);
  if (threadIdx.x < QS) {
    const int pos = q0 + static_cast<int>(threadIdx.x) % QR;
    const long long at =
        (static_cast<long long>(b) * H + h0 + static_cast<int>(threadIdx.x) / QR) * Sq + pos;
    fma::cp4(lse_s + threadIdx.x, pos < Sq ? lse + at : lse, pos < Sq);
    fma::cp4(D_s + threadIdx.x, pos < Sq ? D + at : D, pos < Sq);
  }
  issue_kv(0);
  fma::commit();

  float acc[8][C::N];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < C::N; ++c) acc[r][c] = 0.f;
  float lse2[RPT] = {}, dr[RPT] = {};   // this thread's score rows', read once Q's group landed

  // keys [0, n_keys) are the only ones any row of this block sees
  const int n_keys = causal ? min(Sk, min(q0 + QR, Sq) + off) : Sk;
  const int n_tiles = (n_keys + BT - 1) / BT;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BT;
    const float* Kt = Ks + (t & 1) * BT * LD;
    const float* Vt = Vs + (t & 1) * BT * LD;
    fma::wait<0>();   // K(t), V(t) (and at t = 0 Q, dO, lse, D)
    __syncthreads();  // ... seen by all; every thread is done with tile t - 1
    if (t + 1 < n_tiles) issue_kv(t + 1);
    fma::commit();
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        lse2[r] = lse_s[RPT * rg + r] * fma::kLog2e;
        dr[r] = D_s[RPT * rg + r];
      }
    }

    // S and dP: rows RPT rg + r, keys kg + 16c
    float s[RPT][4], dp[RPT][4];
    two_scores<HD, RPT, 4>(Qs, Kt, dOs, Vt, s, dp, rg, kg);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kpos = k0 + kg + 16 * c;
      float dsv[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int i = RPT * rg + r;
        const int pos = q0 + i % QR;
        const bool seen = pos < Sq && kpos < Sk && !(causal && kpos > pos + off);
        float pv;
        prob_and_dscore(s[r][c], dp[r][c], lse2[r], dr[r], seen, scale_log2, pv, dsv[r]);
      }
#pragma unroll
      for (int r = 0; r < RPT; r += 4)
        *reinterpret_cast<float4*>(dSt + (kg + 16 * c) * kLdS + RPT * rg + r) =
            make_float4(dsv[r], dsv[r + 1], dsv[r + 2], dsv[r + 3]);
    }
    __syncthreads();  // dS seen by all

    fma::acc_xt_y<HD, G>(dSt, kLdS, Kt, acc, x, y, 32 * half, 32);   // dQ += dS K
  }
  fma::wait<0>();
  __syncthreads();    // every thread is done with the last tile

  // the key halves' sums, added in a fixed order: the second's through
  // shared memory
  float* sum_s = Ks;  // [QS][kLd]
  if (half == 1)
#pragma unroll
    for (int r = 0; r < 8; ++r) C::store(sum_s + (8 * x + r) * LD, y, acc[r], 1.f);
  __syncthreads();
  if (half == 1) return;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = 8 * x + r;
    const int pos = q0 + i % QR;
    if (pos >= Sq) continue;
    float other[C::N];
    C::load(sum_s + i * LD, y, other);
#pragma unroll
    for (int c = 0; c < C::N; ++c) acc[r][c] += other[c];
    C::store(dq + b * sdq.b + pos * sdq.s + (h0 + i / QR) * sdq.h, y, acc[r], scale);
  }
}

// Passes 2 and 3.  st: q, k, v, o, dO, dq, dk, dv strides (b, s, heads), 24
// in all.
template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* D, void* dq, void* dk, void* dv, int B, int Sq,
                   int Sk, int H, int K, const long long* st, float scale, int causal,
                   cudaStream_t stream) {
  const Str sq = str3(st), sk = str3(st + 3), sv = str3(st + 6), sd = str3(st + 12),
            sdq = str3(st + 15), sdk = str3(st + 18), sdv = str3(st + 21);
  const float scale_log2 = scale * fma::kLog2e;
  const int group = H / K;
  auto dkdv = bwd_dkdv_f32_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(DkdvSmem<HD>::bytes));
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((Sk + BT - 1) / BT, K, B), NT, DkdvSmem<HD>::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, D,
      static_cast<float*>(dk), static_cast<float*>(dv), Sq, Sk, H, group, sq, sk, sv, sd, sdk,
      sdv, scale_log2, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = bwd_dq_f32_kernel<HD>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(DqSmem<HD>::bytes));
  if (err != cudaSuccess) return err;
  // QS rows a block: a query tile of two heads of a group where QS is 128
  // and the group even, else QS rows of one head
  const int pair = kQS<HD> == 128 && group % 2 == 0 ? 2 : 1;
  const int rows = kQS<HD> / pair;
  dqk<<<dim3(H / pair * B, (Sq + rows - 1) / rows), NT, DqSmem<HD>::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, D,
      static_cast<float*>(dq), Sq, Sk, H, group, pair, sq, sk, sv, sd, sdq, scale_log2, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace f32

// D, then passes 2 and 3: the FMA kernels for f32, the wgmma kernels for bf16.
template <typename T, int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* D, void* dq, void* dk,
                       void* dv, int B, int Sq, int Sk, int H, int K, const long long* st,
                       float scale, int causal, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * H * Sq;
  bwd_dot_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), D, B, Sq, H, HD, str3(st + 9),
      str3(st + 12));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same<T, float>::value)
    return f32::launch<HD>(q, k, v, dout, lse, D, dq, dk, dv, B, Sq, Sk, H, K, st, scale,
                           causal, stream);
  else
    return repro_torch::attention_bwd_sm90(q, k, v, dout, lse, D, dq, dk, dv, B, Sq, Sk, H, K,
                                           HD, st, scale, causal, stream);
}

}  // namespace

// q (B,Sq,H,hd), k/v (B,Sk,K,hd), o/dout (B,Sq,H,hd), lse (B,H,Sq) f32 from
// the forward; D (B,H,Sq) f32 scratch; dq, dk, dv shaped as q, k, v.
// strides: 24 element strides, (b, s, heads) of q, k, v, o, dout, dq, dk,
// dv; the head dim is contiguous.  Returns cudaGetLastError() after the last
// of the three launches (or the first error).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* D, void* dq,
                                   void* dk, void* dv, int is_bf16, int device, int B, int Sq,
                                   int Sk, int H, int K, int hd, int causal,
                                   const long long* strides, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(D);
#define REPRO_BWD(T, HD)                                                                    \
  return launch_bwd<T, HD>(q, k, v, o, dout, l, d, dq, dk, dv, B, Sq, Sk, H, K, strides, \
                           scale, causal, s)
  if (is_bf16 && hd == 128) REPRO_BWD(__nv_bfloat16, 128);
  if (is_bf16 && hd == 80) REPRO_BWD(__nv_bfloat16, 80);
  if (is_bf16 && hd == 64) REPRO_BWD(__nv_bfloat16, 64);
  if (!is_bf16 && hd == 128) REPRO_BWD(float, 128);
  if (!is_bf16 && hd == 80) REPRO_BWD(float, 80);
  if (!is_bf16 && hd == 64) REPRO_BWD(float, 64);
#undef REPRO_BWD
  return cudaErrorInvalidValue;
}
