// Flash attention forward (causal or not, grouped-query) for Hopper, sm_90a.
//
// Replaces repro/kernels/flash_attention.py::flash_attention, the Pallas TPU
// kernel _attn_kernel.  It computes what repro/kernels/ref.py::attention_ref
// computes: q (B,Sq,H,hd), k/v (B,Sk,K,hd), query head h reads KV head
// h / (H/K), queries are the last Sq of the Sk key positions (causal offset
// Sk-Sq), softmax in f32, output in the dtype of q.
//
// Bound: 4*H*hd*Sq*Sk/2 FLOP for causal attention (two products, half the
// square) at 989 TFLOP/s bf16 on an H100 SXM; for one qwen3-1.7b layer at
// Sq=Sk=1024 that is 4.3 GFLOP, about 4.3 us.  It is bound by operations at
// every prefill length, so the products of the bf16 path run on the tensor
// cores (WMMA 16x16x16, f32 accumulate); the f32 path multiplies on the CUDA
// cores in full f32, since TF32 would miss the f32 tolerance.
//
// Design: one block of 4 warps per (q-tile of 64 rows, head, batch); a loop
// over 64-key tiles inside the block keeps the online-softmax state (running
// max, sum, f32 accumulator) in shared memory and stops at the last tile the
// causal mask lets the block's rows see.  Warp w owns query rows
// [16w, 16w+16) in every phase (scores, softmax, PV), so only the K/V tile
// loads need the whole block to synchronise.  Inputs are read in place
// through their strides; ragged tails of Sq and Sk are masked, not asserted.
// Masked scores take the oracle's -1e30; key rows past Sk take -inf, so they
// never count.  Head dims 64, 80 (zamba2's shared block: five 16-wide WMMA
// tiles, 160-byte rows) and 128 are compiled.  Not yet used: TMA, wgmma,
// warp specialisation, keeping the accumulator in registers.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using repro_torch::from_f32;
using repro_torch::kNegInf;
using repro_torch::Tile;
using repro_torch::to_f32;

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

// S[rows of warp] = Q K^T, bf16 path on the tensor cores.  K is stored
// [key][d] row-major, which is K^T column-major.
template <int HD>
__device__ __forceinline__ void tile_scores(const __nv_bfloat16* Qs, const __nv_bfloat16* Ks,
                                            float* Ss, int warp, int /*lane*/) {
  using TL = Tile<__nv_bfloat16, HD>;
  using SM = AttnSmem<__nv_bfloat16, HD>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::load_matrix_sync(a, Qs + warp * 16 * TL::kLd + kk * 16, TL::kLd);
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(b, Ks + n * 16 * TL::kLd + kk * 16, TL::kLd);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < BK / 16; ++n)
    wmma::store_matrix_sync(Ss + warp * 16 * SM::kLdS + n * 16, acc[n], SM::kLdS,
                            wmma::mem_row_major);
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

// O[rows of warp] = O * corr + P V, bf16 path on the tensor cores: the
// accumulator is rescaled in shared memory, then loaded as the WMMA C operand.
template <int HD>
__device__ __forceinline__ void tile_pv(const __nv_bfloat16* Ps, const __nv_bfloat16* Vs,
                                        float* Os, const float* Cs, int warp, int lane) {
  using TL = Tile<__nv_bfloat16, HD>;
  using SM = AttnSmem<__nv_bfloat16, HD>;
  for (int i = lane; i < 16 * HD; i += 32) {
    const int r = warp * 16 + i / HD;
    Os[r * SM::kLdO + i % HD] *= Cs[r];
  }
  __syncwarp();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[BK / 16];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wmma::load_matrix_sync(a[kk], Ps + warp * 16 * SM::kLdP + kk * 16, SM::kLdP);
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) {
    float* o_tile = Os + warp * 16 * SM::kLdO + n * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, o_tile, SM::kLdO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(b, Vs + kk * 16 * TL::kLd + n * 16, TL::kLd);
      wmma::mma_sync(acc, a[kk], b, acc);
    }
    wmma::store_matrix_sync(o_tile, acc, SM::kLdO, wmma::mem_row_major);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int group,
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
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                   int Sk, int H, int K, const long long* st, float scale, int causal,
                   cudaStream_t stream) {
  using SM = AttnSmem<T, HD>;
  auto kernel = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SM::bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, SM::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H / K, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale, causal);
  return cudaGetLastError();
}

}  // namespace

// strides: q (b, s, h), k (b, s, k), v (b, s, k), o (b, s, h), in elements;
// the head dim is contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int is_bf16, int device, int B, int Sq, int Sk, int H,
                                   int K, int hd, int causal, const long long* strides,
                                   float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, Sq, Sk, H, K, strides, scale, causal, s);
  if (is_bf16 && hd == 80)
    return launch<__nv_bfloat16, 80>(q, k, v, o, B, Sq, Sk, H, K, strides, scale, causal, s);
  if (is_bf16 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, Sq, Sk, H, K, strides, scale, causal, s);
  if (!is_bf16 && hd == 128)
    return launch<float, 128>(q, k, v, o, B, Sq, Sk, H, K, strides, scale, causal, s);
  if (!is_bf16 && hd == 80)
    return launch<float, 80>(q, k, v, o, B, Sq, Sk, H, K, strides, scale, causal, s);
  if (!is_bf16 && hd == 64)
    return launch<float, 64>(q, k, v, o, B, Sq, Sk, H, K, strides, scale, causal, s);
  return cudaErrorInvalidValue;
}
