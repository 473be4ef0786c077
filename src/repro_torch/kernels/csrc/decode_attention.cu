// Flash decode: one query token per slot against the KV cache, for Hopper
// (sm_90a).
//
// Replaces repro/kernels/decode_attention.py::flash_decode, the Pallas TPU
// kernel _decode_kernel.  It computes what
// repro/kernels/ref.py::decode_attention_ref computes: q (B,1,H,hd) against
// a cache (B,Smax,K,hd), positions at or past the slot's length masked with
// -1e30, softmax in f32, output in the dtype of q.  Unlike the Pallas kernel
// it takes per-slot (B,) lengths (a scalar is broadcast with stride 0), read
// from device memory so the host never waits, and it masks the ragged tail
// of the cache instead of asserting Smax % block.
//
// Bound: the K/V bytes the valid positions hold, over 3.35 TB/s on an H100
// SXM; one qwen3-1.7b layer with 8 slots at length 1000 reads
// 8 * 1000 * 8 heads * 128 * 2 B * 2 = 32.8 MB, about 9.8 us.  The work per
// byte is tiny (group * 2 FLOP per element), so only the bytes matter: the
// cache is read once, in place through its strides (no per-call transpose
// or copy), and only the tiles below the slot's length are read.
//
// Design (split-K flash decoding): one block per (KV head, slot, chunk of
// `chunk` positions), so that B*K*chunks blocks fill the 132 SMs where B*K
// alone (64 for qwen3 at 8 slots) would leave half of them idle and each
// block's long dependent chain of shared-memory reads exposed.  All `group`
// query heads of the KV head share each K/V tile, which 128 threads copy
// with 16-byte loads into padded shared memory.  Per 64-key tile: scores
// (two threads per key, half the head dim each), an online softmax per head
// (one warp per head), then PV with each thread owning one output column
// (head dims 64, 80 and 128; at 80, 80 of the 128 threads do PV).
// Each block writes its unnormalised f32 accumulator with its running max
// and sum; a second kernel rescales the slot's chunks to a common max and
// sums them.  Chunks past the slot's length are neither run nor read.  Not
// yet used: TMA, overlapping the next tile's load with this tile's
// arithmetic, a compile-time group size.

#include "common.cuh"

using repro_torch::from_f32;
using repro_torch::kNegInf;
using repro_torch::Tile;
using repro_torch::to_f32;

namespace {

constexpr int NT = 128;   // threads per block
constexpr int TK = 64;    // keys per tile (NT / TK = 2 threads per key)
constexpr int MAXG = 8;   // largest GQA group the kernel takes

template <typename T, int HD>
struct DecodeSmem {
  using TL = Tile<T, HD>;
  // threads per output column; for HD 80 only the first kSplit * HD = 80
  // threads accumulate PV, the other 48 sit that phase out
  static constexpr int kSplit = NT / HD;
  static constexpr int kActive = kSplit * HD;
  static constexpr size_t q = 0;                                     // f32 [MAXG][HD]
  static constexpr size_t k = q + sizeof(float) * MAXG * HD;         // T [TK][kLd]
  static constexpr size_t v = k + sizeof(T) * TK * TL::kLd;          // T [TK][kLd]
  static constexpr size_t sp = v + sizeof(T) * TK * TL::kLd;         // f32 [2][MAXG][TK]
  static constexpr size_t s = sp + sizeof(float) * 2 * MAXG * TK;    // f32 [MAXG][TK]
  static constexpr size_t red = s + sizeof(float) * MAXG * TK;       // f32 [kSplit][MAXG][HD]
  static constexpr size_t m = red + sizeof(float) * kSplit * MAXG * HD;
  static constexpr size_t l = m + sizeof(float) * MAXG;
  static constexpr size_t corr = l + sizeof(float) * MAXG;
  static constexpr size_t bytes = corr + sizeof(float) * MAXG;
};

// Partial results of chunk c of (slot b, KV head kh), query head g of the
// group: part_acc[((b*K + kh)*chunks + c)*group + g][HD] and part_m / part_l
// at the same row index.
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_decode_chunk_kernel(const T* __restrict__ q, const T* __restrict__ ck,
                          const T* __restrict__ cv, const int* __restrict__ lengths,
                          int len_stride, int Smax, int group, int chunk, long long qsb,
                          long long qsh, long long ksb, long long kss, long long ksh,
                          long long vsb, long long vss, long long vsh, float scale,
                          float* __restrict__ part_acc, float* __restrict__ part_m,
                          float* __restrict__ part_l) {
  using TL = Tile<T, HD>;
  using SM = DecodeSmem<T, HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + SM::q);
  T* Ks = reinterpret_cast<T*>(smem + SM::k);
  T* Vs = reinterpret_cast<T*>(smem + SM::v);
  float* SP = reinterpret_cast<float*>(smem + SM::sp);
  float* Sx = reinterpret_cast<float*>(smem + SM::s);
  float* Red = reinterpret_cast<float*>(smem + SM::red);
  float* Ms = reinterpret_cast<float*>(smem + SM::m);
  float* Ls = reinterpret_cast<float*>(smem + SM::l);
  float* Cs = reinterpret_cast<float*>(smem + SM::corr);

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int c = blockIdx.z;
  const int K = gridDim.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long row = ((static_cast<long long>(b) * K + kh) * gridDim.z + c) * group;

  // positions [0, n) are visited; [0, len) are valid.  len <= 0 masks every
  // position, which the oracle turns into a uniform average over all Smax.
  const int len = lengths[b * len_stride];
  const int n = len <= 0 ? Smax : min(len, Smax);
  const int start = c * chunk;
  const int end = min(start + chunk, n);
  if (start >= end) return;  // past the visited span: the combine skips it

  for (int i = tid; i < group * HD; i += NT)
    Qs[i] = to_f32(q[b * qsb + (kh * group + i / HD) * qsh + i % HD]);
  if (tid < MAXG) {
    Ms[tid] = kNegInf;
    Ls[tid] = 0.f;
  }
  const int col = tid % HD;         // output column this thread accumulates
  const int kpart = tid / HD;       // ... over keys j with j % kSplit == kpart
  // ... if it takes part in PV at all (every thread unless HD is 80)
  const bool pv = SM::kActive == NT || tid < SM::kActive;
  float acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;
  __syncthreads();

  for (int k0 = start; k0 < end; k0 += TK) {
    repro_torch::load_rows<T, HD, NT>(Ks, ck + b * ksb + k0 * kss + kh * ksh, kss, TK,
                                      min(TK, end - k0));
    repro_torch::load_rows<T, HD, NT>(Vs, cv + b * vsb + k0 * vss + kh * vsh, vss, TK,
                                      min(TK, end - k0));
    __syncthreads();
    {
      // partial scores: key j, half `part` of the head dim
      const int j = tid % TK;
      const int part = tid / TK;
      const T* krow = Ks + j * TL::kLd + part * (HD / 2);
      const float* qpart = Qs + part * (HD / 2);
      float ps[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) ps[g] = 0.f;
      for (int d = 0; d < HD / 2; d += TL::kVec) {
        const int4 raw = *reinterpret_cast<const int4*>(krow + d);
        const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < TL::kVec; ++e) {
          const float kf = to_f32(kv[e]);
#pragma unroll
          for (int g = 0; g < MAXG; ++g)
            if (g < group) ps[g] = fmaf(kf, qpart[g * HD + d + e], ps[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < group) SP[(part * MAXG + g) * TK + j] = ps[g];
    }
    __syncthreads();
    for (int i = tid; i < group * TK; i += NT) {
      const int g = i / TK;
      const int j = i % TK;
      const int pos = k0 + j;
      float x = (SP[g * TK + j] + SP[(MAXG + g) * TK + j]) * scale;
      if (pos >= len) x = kNegInf;
      if (pos >= end) x = -INFINITY;  // past this chunk: never counts here
      Sx[g * TK + j] = x;
    }
    __syncthreads();
    for (int g = warp; g < group; g += NT / 32) {
      float* srow = Sx + g * TK;
      const float x0 = srow[lane];
      const float x1 = srow[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(x0 - m_new);
      const float p1 = expf(x1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      srow[lane] = p0;
      srow[lane + 32] = p1;
      __syncwarp();  // every lane has read Ms[g]
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        Ms[g] = m_new;
        Ls[g] = Ls[g] * corr + sum;
        Cs[g] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < group) acc[g] *= Cs[g];
    if (pv) {
      for (int j = kpart; j < TK; j += SM::kSplit) {
        const float vf = to_f32(Vs[j * TL::kLd + col]);
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < group) acc[g] = fmaf(Sx[g * TK + j], vf, acc[g]);
      }
    }
    __syncthreads();  // K/V tiles and scores are overwritten next
  }

#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    if (pv && g < group) Red[(kpart * MAXG + g) * HD + col] = acc[g];
  __syncthreads();
  for (int i = tid; i < group * HD; i += NT) {
    const int g = i / HD;
    const int d = i % HD;
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < SM::kSplit; ++s) sum += Red[(s * MAXG + g) * HD + d];
    part_acc[row * HD + i] = sum;
  }
  if (tid < group) {
    part_m[row + tid] = Ms[tid];
    part_l[row + tid] = Ls[tid];
  }
}

// o[b, 0, kh*group + g, :] = sum_c acc_c e^(m_c - m) / sum_c l_c e^(m_c - m),
// m = max_c m_c over the chunks that hold visited positions, for one
// (KV head, slot) per block.
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_decode_combine_kernel(const float* __restrict__ part_acc,
                            const float* __restrict__ part_m,
                            const float* __restrict__ part_l,
                            const int* __restrict__ lengths, int len_stride, int Smax,
                            int group, int chunk, int chunks, T* __restrict__ o,
                            long long osb, long long osh) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const long long base = (static_cast<long long>(b) * gridDim.x + kh) * chunks;
  const int len = lengths[b * len_stride];
  const int n = len <= 0 ? Smax : min(len, Smax);
  const int used = (n + chunk - 1) / chunk;
  for (int i = threadIdx.x; i < group * HD; i += NT) {
    const int g = i / HD;
    const int d = i % HD;
    float m = -INFINITY;
    for (int c = 0; c < used; ++c) m = fmaxf(m, part_m[(base + c) * group + g]);
    float l = 0.f, acc = 0.f;
    for (int c = 0; c < used; ++c) {
      const long long r = (base + c) * group + g;
      const float w = expf(part_m[r] - m);
      l = fmaf(part_l[r], w, l);
      acc = fmaf(part_acc[r * HD + d], w, acc);
    }
    o[b * osb + (kh * group + g) * osh + d] = from_f32<T>(acc / l);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* ck, const void* cv, const int* lengths,
                   int len_stride, void* o, int B, int Smax, int H, int K, int chunk,
                   const long long* st, float scale, float* part, cudaStream_t stream) {
  using SM = DecodeSmem<T, HD>;
  const int group = H / K;
  const int chunks = (Smax + chunk - 1) / chunk;
  const size_t rows = static_cast<size_t>(B) * K * chunks * group;
  float* part_acc = part;
  float* part_m = part + rows * HD;
  float* part_l = part_m + rows;
  auto kernel = flash_decode_chunk_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SM::bytes));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(K, B, chunks), NT, SM::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ck), static_cast<const T*>(cv),
      lengths, len_stride, Smax, group, chunk, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], scale, part_acc, part_m, part_l);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_combine_kernel<T, HD><<<dim3(K, B), NT, 0, stream>>>(
      part_acc, part_m, part_l, lengths, len_stride, Smax, group, chunk, chunks,
      static_cast<T*>(o), st[8], st[9]);
  return cudaGetLastError();
}

}  // namespace

// strides: q (b, h), cache k (b, s, k), cache v (b, s, k), o (b, h), in
// elements; the head dim is contiguous.  lengths holds B int32 counts, or one
// with len_stride 0.  part is f32 scratch of B*K*ceil(Smax/chunk)*(H/K)*(hd+2)
// floats.  Returns cudaGetLastError() after the launches.
extern "C" int flash_decode_fwd(const void* q, const void* ck, const void* cv,
                                const int* lengths, int len_stride, void* o, int is_bf16,
                                int device, int B, int Smax, int H, int K, int hd, int chunk,
                                const long long* strides, float scale, void* part,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (H / K > MAXG || chunk <= 0 || chunk % TK) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (is_bf16 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, ck, cv, lengths, len_stride, o, B, Smax, H, K,
                                      chunk, strides, scale, p, s);
  if (is_bf16 && hd == 80)
    return launch<__nv_bfloat16, 80>(q, ck, cv, lengths, len_stride, o, B, Smax, H, K,
                                     chunk, strides, scale, p, s);
  if (is_bf16 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, ck, cv, lengths, len_stride, o, B, Smax, H, K,
                                     chunk, strides, scale, p, s);
  if (!is_bf16 && hd == 128)
    return launch<float, 128>(q, ck, cv, lengths, len_stride, o, B, Smax, H, K, chunk,
                              strides, scale, p, s);
  if (!is_bf16 && hd == 80)
    return launch<float, 80>(q, ck, cv, lengths, len_stride, o, B, Smax, H, K, chunk,
                             strides, scale, p, s);
  if (!is_bf16 && hd == 64)
    return launch<float, 64>(q, ck, cv, lengths, len_stride, o, B, Smax, H, K, chunk,
                             strides, scale, p, s);
  return cudaErrorInvalidValue;
}
