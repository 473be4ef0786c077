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
//     head of the group and every 64-row query tile that can see its keys,
//     recomputes P and dS for the tile pair and accumulates dV and dK in
//     registers.  The group's sum stays inside the block: no atomics, so a
//     step is bit-repeatable.
//  3. dQ per (64-row query tile, head, batch), over the key tiles its rows
//     see (the forward's loop).
// bf16 (the training path): passes 2 and 3 are the wgmma kernels of
// flash_attention_bwd_sm90.cu (TMA rings, accumulators in registers).
// f32 (phase-2 checks only): passes 2 and 3 below, one block of 256 threads
// each, the products on the CUDA cores in full f32 (TF32 would miss the f32
// tolerance): 4x4 register tiles for the 64x64 score-shaped products, 4 rows
// x hd/16 columns for the hd-wide ones.  Rows are padded by 16 bytes, so
// 16-byte loads of one column by neighbouring rows hit distinct banks.

#include <type_traits>

#include "common.cuh"

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
constexpr int NT = 256;  // threads per block of passes 2 and 3
constexpr int kLdT = BT + 16;   // 64x64 f32 tiles (P, dS): rows 16 banks apart

struct Str {  // element strides of a (B, S, heads, hd) tensor
  long long b, s, h;
};

template <int HD>
struct Bwd {
  static constexpr int kLd = HD + 4;             // f32 rows of hd, 16-byte padded
  static constexpr int kTile = BT * kLd;         // floats in one hd-wide tile
  static constexpr int ND = HD / 16;             // columns per thread, hd-wide products
};

// 64 rows of HD f32 elements into shared memory (row stride kLd); rows at or
// past `valid` are zeros.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long rs,
                                          int valid) {
  constexpr int PER_ROW = HD / 4;
  for (int i = threadIdx.x; i < BT * PER_ROW; i += NT) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * 4;
    int4 raw = make_int4(0, 0, 0, 0);
    if (r < valid) raw = *reinterpret_cast<const int4*>(src + r * rs + c);
    *reinterpret_cast<int4*>(dst + r * Bwd<HD>::kLd + c) = raw;
  }
}

// S = A B^T and T = C D^T for 64-row tiles A, B, C, D of hd columns: thread
// (ti, tj) = (tid / 16, tid % 16) computes rows ti + 16r and columns
// tj + 16c, r, c < 4.
template <int HD>
__device__ __forceinline__ void two_scores(const float* A, const float* Bm, const float* C,
                                           const float* Dm, float (&s)[4][4],
                                           float (&t)[4][4], int ti, int tj) {
  constexpr int LD = Bwd<HD>::kLd;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = t[r][c] = 0.f;
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], b[4], cc[4], dd[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[r] = *reinterpret_cast<const float4*>(A + (ti + 16 * r) * LD + d);
      cc[r] = *reinterpret_cast<const float4*>(C + (ti + 16 * r) * LD + d);
      b[r] = *reinterpret_cast<const float4*>(Bm + (tj + 16 * r) * LD + d);
      dd[r] = *reinterpret_cast<const float4*>(Dm + (tj + 16 * r) * LD + d);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = fmaf(a[r].x, b[c].x, fmaf(a[r].y, b[c].y,
                  fmaf(a[r].z, b[c].z, fmaf(a[r].w, b[c].w, s[r][c]))));
        t[r][c] = fmaf(cc[r].x, dd[c].x, fmaf(cc[r].y, dd[c].y,
                  fmaf(cc[r].z, dd[c].z, fmaf(cc[r].w, dd[c].w, t[r][c]))));
      }
  }
}

// P and dS of one (query tile, key tile) pair into shared memory, [i][j]
// with row stride kLdT.  s = Q K^T and dp = dO V^T from two_scores; q0, k0
// the tiles' first query row and key; rows past Sq and keys the forward
// masked give 0.
__device__ __forceinline__ void probs_and_dscores(const float (&s)[4][4], const float (&dp)[4][4],
                                                  const float* lse_s, const float* D_s,
                                                  float* Ps, float* dSs, int ti, int tj, int q0,
                                                  int k0, int Sq, int Sk, int off, int causal,
                                                  float scale) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ti + 16 * r;
    const int qpos = q0 + i + off;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tj + 16 * c;
      const int kpos = k0 + j;
      const bool seen = q0 + i < Sq && kpos < Sk && !(causal && kpos > qpos);
      const float p = seen ? expf(fmaf(s[r][c], scale, -lse_s[i])) : 0.f;
      Ps[i * kLdT + j] = p;
      dSs[i * kLdT + j] = p * (dp[r][c] - D_s[i]);
    }
  }
}

// acc[r][c] += sum over the 64 rows i of X[i][row] * Y[i][col] (X^T Y), with
// X a 64x64 tile (stride kLdT), Y a 64-row hd tile; thread (tr, tc) owns
// rows tr + 16r and columns tc + 16c.
template <int HD>
__device__ __forceinline__ void acc_xt_y(const float* X, const float* Y,
                                         float (&acc)[4][Bwd<HD>::ND], int tr, int tc) {
  constexpr int LD = Bwd<HD>::kLd;
  for (int i = 0; i < BT; ++i) {
    float x[4], y[Bwd<HD>::ND];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = X[i * kLdT + tr + 16 * r];
#pragma unroll
    for (int c = 0; c < Bwd<HD>::ND; ++c) y[c] = Y[i * LD + tc + 16 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < Bwd<HD>::ND; ++c) acc[r][c] = fmaf(x[r], y[c], acc[r][c]);
  }
}

// acc[r][c] += sum over the 64 columns j of X[row][j] * Y[j][col] (X Y).
template <int HD>
__device__ __forceinline__ void acc_x_y(const float* X, const float* Y,
                                        float (&acc)[4][Bwd<HD>::ND], int tr, int tc) {
  constexpr int LD = Bwd<HD>::kLd;
  for (int j = 0; j < BT; ++j) {
    float x[4], y[Bwd<HD>::ND];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = X[(tr + 16 * r) * kLdT + j];
#pragma unroll
    for (int c = 0; c < Bwd<HD>::ND; ++c) y[c] = Y[j * LD + tc + 16 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < Bwd<HD>::ND; ++c) acc[r][c] = fmaf(x[r], y[c], acc[r][c]);
  }
}

// 64 rows of an hd-wide f32 accumulator, times `mul`, to out (rows < valid).
template <int HD>
__device__ __forceinline__ void store_rows(float* out, long long rs,
                                           const float (&acc)[4][Bwd<HD>::ND], int tr, int tc,
                                           int valid, float mul) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = tr + 16 * r;
    if (row >= valid) continue;
#pragma unroll
    for (int c = 0; c < Bwd<HD>::ND; ++c)
      out[row * rs + tc + 16 * c] = acc[r][c] * mul;
  }
}

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

template <int HD>
struct DkdvSmem {
  static constexpr size_t k = 0;
  static constexpr size_t v = k + sizeof(float) * Bwd<HD>::kTile;
  static constexpr size_t q = v + sizeof(float) * Bwd<HD>::kTile;
  static constexpr size_t dout = q + sizeof(float) * Bwd<HD>::kTile;
  static constexpr size_t p = dout + sizeof(float) * Bwd<HD>::kTile;
  static constexpr size_t ds = p + sizeof(float) * BT * kLdT;
  static constexpr size_t lse = ds + sizeof(float) * BT * kLdT;
  static constexpr size_t d = lse + sizeof(float) * BT;
  static constexpr size_t bytes = d + sizeof(float) * BT;
};

// Pass 2: dK and dV of one 64-key tile of one KV head, summed over the
// group's query heads and every query tile that sees the keys.
template <int HD>
__global__ void __launch_bounds__(NT, 1)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ D,
                float* __restrict__ dk, float* __restrict__ dv, int Sq,
                int Sk, int H, int group, Str sq, Str sk, Str sv, Str sd, Str sdk, Str sdv,
                float scale, int causal) {
  using SM = DkdvSmem<HD>;
  constexpr int ND = Bwd<HD>::ND;
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
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
  const int kvalid = min(BT, Sk - k0);

  load_tile<HD>(Ks, k + b * sk.b + k0 * sk.s + kh * sk.h, sk.s, kvalid);
  load_tile<HD>(Vs, v + b * sv.b + k0 * sv.s + kh * sv.h, sv.s, kvalid);

  float acc_dk[4][ND], acc_dv[4][ND];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < ND; ++c) acc_dk[r][c] = acc_dv[r][c] = 0.f;

  // query rows i with i + off >= k0 are the only ones that see a key here
  const int first = causal ? max(0, k0 - off) / BT : 0;
  const int n_qtiles = (Sq + BT - 1) / BT;
  for (int g = 0; g < group; ++g) {
    const int h = kh * group + g;
    for (int qt = first; qt < n_qtiles; ++qt) {
      const int q0 = qt * BT;
      const int qvalid = min(BT, Sq - q0);
      __syncthreads();  // the last pair's tiles are read
      load_tile<HD>(Qs, q + b * sq.b + q0 * sq.s + h * sq.h, sq.s, qvalid);
      load_tile<HD>(dOs, dout + b * sd.b + q0 * sd.s + h * sd.h, sd.s, qvalid);
      if (threadIdx.x < BT) {
        const long long at = (static_cast<long long>(b) * H + h) * Sq + q0 + threadIdx.x;
        lse_s[threadIdx.x] = threadIdx.x < qvalid ? lse[at] : 0.f;
        D_s[threadIdx.x] = threadIdx.x < qvalid ? D[at] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      two_scores<HD>(Qs, Ks, dOs, Vs, s, dp, ti, tj);
      probs_and_dscores(s, dp, lse_s, D_s, Ps, dSs, ti, tj, q0, k0, Sq, Sk, off, causal, scale);
      __syncthreads();
      acc_xt_y<HD>(Ps, dOs, acc_dv, ti, tj);
      acc_xt_y<HD>(dSs, Qs, acc_dk, ti, tj);
    }
  }
  store_rows<HD>(dk + b * sdk.b + k0 * sdk.s + kh * sdk.h, sdk.s, acc_dk, ti, tj, kvalid,
                    scale);
  store_rows<HD>(dv + b * sdv.b + k0 * sdv.s + kh * sdv.h, sdv.s, acc_dv, ti, tj, kvalid,
                    1.f);
}

template <int HD>
struct DqSmem {
  static constexpr size_t q = 0;
  static constexpr size_t dout = q + sizeof(float) * Bwd<HD>::kTile;
  static constexpr size_t k = dout + sizeof(float) * Bwd<HD>::kTile;
  static constexpr size_t v = k + sizeof(float) * Bwd<HD>::kTile;
  static constexpr size_t p = v + sizeof(float) * Bwd<HD>::kTile;
  static constexpr size_t ds = p + sizeof(float) * BT * kLdT;
  static constexpr size_t lse = ds + sizeof(float) * BT * kLdT;
  static constexpr size_t d = lse + sizeof(float) * BT;
  static constexpr size_t bytes = d + sizeof(float) * BT;
};

// Pass 3: dQ of one 64-row query tile of one head, over the key tiles its
// rows see.
template <int HD>
__global__ void __launch_bounds__(NT, 1)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ D,
              float* __restrict__ dq, int Sq, int Sk, int H,
              int group, Str sq, Str sk, Str sv, Str sd, Str sdq, float scale, int causal) {
  using SM = DqSmem<HD>;
  constexpr int ND = Bwd<HD>::ND;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + SM::q);
  float* dOs = reinterpret_cast<float*>(smem + SM::dout);
  float* Ks = reinterpret_cast<float*>(smem + SM::k);
  float* Vs = reinterpret_cast<float*>(smem + SM::v);
  float* Ps = reinterpret_cast<float*>(smem + SM::p);
  float* dSs = reinterpret_cast<float*>(smem + SM::ds);
  float* lse_s = reinterpret_cast<float*>(smem + SM::lse);
  float* D_s = reinterpret_cast<float*>(smem + SM::d);

  // the last query tiles see the most keys: they start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / group;
  const int off = Sk - Sq;
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
  const int qvalid = min(BT, Sq - q0);

  load_tile<HD>(Qs, q + b * sq.b + q0 * sq.s + h * sq.h, sq.s, qvalid);
  load_tile<HD>(dOs, dout + b * sd.b + q0 * sd.s + h * sd.h, sd.s, qvalid);
  if (threadIdx.x < BT) {
    const long long at = (static_cast<long long>(b) * H + h) * Sq + q0 + threadIdx.x;
    lse_s[threadIdx.x] = threadIdx.x < qvalid ? lse[at] : 0.f;
    D_s[threadIdx.x] = threadIdx.x < qvalid ? D[at] : 0.f;
  }
  float acc[4][ND];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < ND; ++c) acc[r][c] = 0.f;

  // keys [0, n_keys) are the only ones any row of this tile sees
  const int n_keys = causal ? min(Sk, q0 + qvalid + off) : Sk;
  for (int k0 = 0; k0 < n_keys; k0 += BT) {
    const int kvalid = min(BT, Sk - k0);
    __syncthreads();  // the last tile's K and dS are read
    load_tile<HD>(Ks, k + b * sk.b + k0 * sk.s + kh * sk.h, sk.s, kvalid);
    load_tile<HD>(Vs, v + b * sv.b + k0 * sv.s + kh * sv.h, sv.s, kvalid);
    __syncthreads();
    float s[4][4], dp[4][4];
    two_scores<HD>(Qs, Ks, dOs, Vs, s, dp, ti, tj);
    probs_and_dscores(s, dp, lse_s, D_s, Ps, dSs, ti, tj, q0, k0, Sq, Sk, off, causal, scale);
    __syncthreads();
    acc_x_y<HD>(dSs, Ks, acc, ti, tj);
  }
  store_rows<HD>(dq + b * sdq.b + q0 * sdq.s + h * sdq.h, sdq.s, acc, ti, tj, qvalid, scale);
}

Str str3(const long long* st) { return Str{st[0], st[1], st[2]}; }

// Passes 2 and 3 of the f32 path.  st: q, k, v, o, dO, dq, dk, dv strides
// (b, s, heads), 24 in all.
template <int HD>
cudaError_t launch_fma(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* D, void* dq, void* dk, void* dv, int B,
                       int Sq, int Sk, int H, int K, const long long* st, float scale,
                       int causal, cudaStream_t stream) {
  const Str sq = str3(st), sk = str3(st + 3), sv = str3(st + 6), sd = str3(st + 12),
            sdq = str3(st + 15), sdk = str3(st + 18), sdv = str3(st + 21);
  auto dkdv = bwd_dkdv_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(DkdvSmem<HD>::bytes));
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((Sk + BT - 1) / BT, K, B), NT, DkdvSmem<HD>::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, D,
      static_cast<float*>(dk), static_cast<float*>(dv), Sq, Sk, H, H / K, sq, sk, sv, sd, sdk,
      sdv, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = bwd_dq_kernel<HD>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(DqSmem<HD>::bytes));
  if (err != cudaSuccess) return err;
  dqk<<<dim3((Sq + BT - 1) / BT, H, B), NT, DqSmem<HD>::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, D,
      static_cast<float*>(dq), Sq, Sk, H, H / K, sq, sk, sv, sd, sdq, scale, causal);
  return cudaGetLastError();
}

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
    return launch_fma<HD>(q, k, v, dout, lse, D, dq, dk, dv, B, Sq, Sk, H, K, st, scale,
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
