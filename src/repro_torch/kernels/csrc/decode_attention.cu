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
// of the cache instead of asserting Smax % block.  A length <= 0 averages
// uniformly over all Smax positions and a length past Smax is clamped, as
// in the oracle.  Where the caller passes `lse`, each launch also writes
// every query head's log-sum-exp of its scaled, masked scores (f32, natural
// log, lse[b * H + h]), with which a caller merges the outputs of caches
// split over their positions: o = sum_r o_r e^(lse_r - M) / sum_r e^(lse_r - M).
//
// Bound: bytes.  The K/V rows below each slot's length, read once, over
// 3.35 TB/s on an H100 SXM; the work per byte is tiny (about `group` FLOP
// per byte, group = H/K).  At the served shapes: qwen3-1.7b, 8 slots
// at lengths 48-1293 (H=16 K=8 hd 128), 17.4 MB, 5.19 us; zamba2's shared
// block, 4 slots at 716 (H=K=32 hd 80), 29.4 MB, 8.77 us; qwen3-moe, 4
// slots at 308 (H=32 K=4 hd 128), 2.59 MB, 0.77 us.  The cache is read in
// place through its strides (a layer of a stacked cache is fine), and rows
// past the slot's length are never read.
//
// bf16 design (the served path):
//  - Tensor cores, mma.sync m16n8k16 (bf16 in, f32 accumulate).  For Q K^T
//    the A operand is a block of the group's query rows padded to 16,
//    loaded once into registers; B is a K tile read with ldmatrix from
//    [key][d] rows.  The two n8 score fragments of 16 keys are, converted
//    to bf16, the k16 A operand of P V; B is V through ldmatrix.trans.
//    Head dims 64, 80, 128 are 4, 5, 8 k16 steps and 8, 10, 16 n8 tiles,
//    so 80 needs no padding.  Scores, P and O stay in registers for the
//    whole key loop.  Row blocks: a group up to 8 fills rows 0-7 (rows
//    8-15 are zeros and their results dropped, ROWS = 8: the kernel of
//    groups 1-8, unchanged); a group of 9-16 fills all 16 rows (ROWS =
//    16, each lane carrying two query rows through the softmax); a larger
//    group is cut into ceil(group / 16) blocks of 16 rows, each of which
//    reads the (slot, KV head)'s cache on its own.  Within a block the
//    rows are a runtime count, since the m16 rows hold any count alike.
//  - Split-K inside a block: each of the 4 warps takes 16 keys of every
//    64-key tile and keeps its own running max, sum and O (8 rows x hd
//    f32); row max and sum take two quad shuffles.  The warps merge once,
//    through shared memory, after the block's last tile.
//  - Split-K across blocks, sized on the device: block (kh, b, c) reads
//    len[b] and takes an equal share of that slot's T = ceil(n / 64)
//    visited tiles (spans = min(T, splits) blocks hold one or more), so a
//    (slot, KV head) gets its blocks whatever its length; the host picks
//    `splits` <= 4 from B*K, Smax and the SM count alone (about one block
//    per SM).  A block walks its span through a 3-stage ring of K/V tiles
//    filled by 16-byte cp.async copies (rows past the visited length
//    zero-filled, not read): the next two tiles are in flight while this
//    one computes, one barrier a tile.  A row block above counts as a
//    pair of its own.
//  - Where a (slot, KV head) has one span the block writes the output
//    itself.  Otherwise the `splits` blocks of the pair run as one thread
//    block cluster: each leaves its unnormalised f32 output, max and sum
//    (base 2) in its shared memory, and after a cluster barrier the blocks
//    read every span's partial through distributed shared memory and write
//    a share of the output each.  No scratch in device memory, no second
//    kernel.
// Measured on the H100 (PERF.md; chip_smoke.py phase 7, L2 flushed by
// zeroing): about 2.7x the bytes bound at zamba2, 3.8x at qwen3-1.7b and
// 15x at qwen3-moe, where a fixed cost of about 10 us a call (launch, the
// first loads after the flush, one tile's latency, the merge) outweighs
// 2.6 MB of reads.  scripts/decode_variants.py builds patched copies of
// this file: planted faults (for the checks' limits), an L2 evict-first
// hint on the copies (faster only under that flush, not in the served
// steps, so not kept) and other splits.  Not done: a compile-time group
// that would skip the zero query rows; shortening the fixed cost.
//
// f32 path (phase-2 checks only, not served): one block per (KV head, row
// block, slot, 64-position chunk) on the CUDA cores, a row block holding up
// to MAXG = 8 query heads (groups 1-8) or 16 (larger groups, cut into
// ceil(group / 16) blocks; MAXG sizes register arrays, so groups up to 8
// keep theirs).  The block's query heads share each
// K/V tile, which 128 threads copy into padded shared memory; per tile,
// scores (two threads per key), an online softmax per head (one warp per
// head), then P V with each thread owning one output column.  Each chunk
// writes an unnormalised partial with its max and sum, and a second kernel
// rescales a slot's chunks to a common max and sums them.

#include "common.cuh"
#include "sm90.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

using repro_torch::kNegInf;
using repro_torch::Tile;

namespace {

constexpr int NT = 128;   // threads per block
constexpr int TK = 64;    // keys per tile: f32, 2 threads a key; bf16, 16 keys a warp
constexpr int ROW_BLOCK = 16;   // query heads a row block of a group above 8 holds

// query heads per row block for a GQA group: the whole group up to 8, else
// blocks of ROW_BLOCK
__host__ __device__ __forceinline__ int row_blocks(int group) {
  return group <= 8 ? 1 : (group + ROW_BLOCK - 1) / ROW_BLOCK;
}

template <int HD, int MAXG>
struct DecodeSmem {
  using TL = Tile<float, HD>;
  // threads per output column; for HD 80 only the first kSplit * HD = 80
  // threads accumulate PV, the other 48 sit that phase out
  static constexpr int kSplit = NT / HD;
  static constexpr int kActive = kSplit * HD;
  static constexpr size_t q = 0;                                     // f32 [MAXG][HD]
  static constexpr size_t k = q + sizeof(float) * MAXG * HD;         // f32 [TK][kLd]
  static constexpr size_t v = k + sizeof(float) * TK * TL::kLd;      // f32 [TK][kLd]
  static constexpr size_t sp = v + sizeof(float) * TK * TL::kLd;     // f32 [2][MAXG][TK]
  static constexpr size_t s = sp + sizeof(float) * 2 * MAXG * TK;    // f32 [MAXG][TK]
  static constexpr size_t red = s + sizeof(float) * MAXG * TK;       // f32 [kSplit][MAXG][HD]
  static constexpr size_t m = red + sizeof(float) * kSplit * MAXG * HD;
  static constexpr size_t l = m + sizeof(float) * MAXG;
  static constexpr size_t corr = l + sizeof(float) * MAXG;
  static constexpr size_t bytes = corr + sizeof(float) * MAXG;
};

// Partial results of chunk c of (slot b, KV head kh), query head g of the
// group: part_acc[((b*K + kh)*chunks + c)*group + g][HD] and part_m / part_l
// at the same row index.  Block x = kh * rblocks + rb takes the group's
// query heads [rb * MAXG, min(group, (rb + 1) * MAXG)).
template <int HD, int MAXG>
__global__ void __launch_bounds__(NT)
flash_decode_chunk_kernel(const float* __restrict__ q, const float* __restrict__ ck,
                          const float* __restrict__ cv, const int* __restrict__ lengths,
                          int len_stride, int Smax, int group, int rblocks, int chunk, long long qsb,
                          long long qsh, long long ksb, long long kss, long long ksh,
                          long long vsb, long long vss, long long vsh, float scale,
                          float* __restrict__ part_acc, float* __restrict__ part_m,
                          float* __restrict__ part_l) {
  using TL = Tile<float, HD>;
  using SM = DecodeSmem<HD, MAXG>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + SM::q);
  float* Ks = reinterpret_cast<float*>(smem + SM::k);
  float* Vs = reinterpret_cast<float*>(smem + SM::v);
  float* SP = reinterpret_cast<float*>(smem + SM::sp);
  float* Sx = reinterpret_cast<float*>(smem + SM::s);
  float* Red = reinterpret_cast<float*>(smem + SM::red);
  float* Ms = reinterpret_cast<float*>(smem + SM::m);
  float* Ls = reinterpret_cast<float*>(smem + SM::l);
  float* Cs = reinterpret_cast<float*>(smem + SM::corr);

  const int kh = blockIdx.x / rblocks;
  const int g0 = blockIdx.x % rblocks * MAXG;   // the block's first query head of the group
  const int rows = min(MAXG, group - g0);       // ... and its count
  const int b = blockIdx.y;
  const int c = blockIdx.z;
  const int K = gridDim.x / rblocks;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long row = ((static_cast<long long>(b) * K + kh) * gridDim.z + c) * group + g0;

  // positions [0, n) are visited; [0, len) are valid.  len <= 0 masks every
  // position, which the oracle turns into a uniform average over all Smax.
  const int len = lengths[b * len_stride];
  const int n = len <= 0 ? Smax : min(len, Smax);
  const int start = c * chunk;
  const int end = min(start + chunk, n);
  if (start >= end) return;  // past the visited span: the combine skips it

  for (int i = tid; i < rows * HD; i += NT)
    Qs[i] = q[b * qsb + (kh * group + g0 + i / HD) * qsh + i % HD];
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
    repro_torch::load_rows<float, HD, NT>(Ks, ck + b * ksb + k0 * kss + kh * ksh, kss, TK,
                                          min(TK, end - k0));
    repro_torch::load_rows<float, HD, NT>(Vs, cv + b * vsb + k0 * vss + kh * vsh, vss, TK,
                                          min(TK, end - k0));
    __syncthreads();
    {
      // partial scores: key j, half `part` of the head dim
      const int j = tid % TK;
      const int part = tid / TK;
      const float* krow = Ks + j * TL::kLd + part * (HD / 2);
      const float* qpart = Qs + part * (HD / 2);
      float ps[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) ps[g] = 0.f;
      for (int d = 0; d < HD / 2; d += TL::kVec) {
        const float4 kv4 = *reinterpret_cast<const float4*>(krow + d);
        const float kv[4] = {kv4.x, kv4.y, kv4.z, kv4.w};
#pragma unroll
        for (int e = 0; e < TL::kVec; ++e) {
          const float kf = kv[e];
#pragma unroll
          for (int g = 0; g < MAXG; ++g)
            if (g < rows) ps[g] = fmaf(kf, qpart[g * HD + d + e], ps[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < rows) SP[(part * MAXG + g) * TK + j] = ps[g];
    }
    __syncthreads();
    for (int i = tid; i < rows * TK; i += NT) {
      const int g = i / TK;
      const int j = i % TK;
      const int pos = k0 + j;
      float x = (SP[g * TK + j] + SP[(MAXG + g) * TK + j]) * scale;
      if (pos >= len) x = kNegInf;
      if (pos >= end) x = -INFINITY;  // past this chunk: never counts here
      Sx[g * TK + j] = x;
    }
    __syncthreads();
    for (int g = warp; g < rows; g += NT / 32) {
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
      if (g < rows) acc[g] *= Cs[g];
    if (pv) {
      for (int j = kpart; j < TK; j += SM::kSplit) {
        const float vf = Vs[j * TL::kLd + col];
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < rows) acc[g] = fmaf(Sx[g * TK + j], vf, acc[g]);
      }
    }
    __syncthreads();  // K/V tiles and scores are overwritten next
  }

#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    if (pv && g < rows) Red[(kpart * MAXG + g) * HD + col] = acc[g];
  __syncthreads();
  for (int i = tid; i < rows * HD; i += NT) {
    const int g = i / HD;
    const int d = i % HD;
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < SM::kSplit; ++s) sum += Red[(s * MAXG + g) * HD + d];
    part_acc[row * HD + i] = sum;
  }
  if (tid < rows) {
    part_m[row + tid] = Ms[tid];
    part_l[row + tid] = Ls[tid];
  }
}

// o[b, 0, kh*group + g, :] = sum_c acc_c e^(m_c - m) / sum_c l_c e^(m_c - m),
// m = max_c m_c over the chunks that hold visited positions, for one
// (KV head, slot) per block.
template <int HD>
__global__ void __launch_bounds__(NT)
flash_decode_combine_kernel(const float* __restrict__ part_acc,
                            const float* __restrict__ part_m,
                            const float* __restrict__ part_l,
                            const int* __restrict__ lengths, int len_stride, int Smax,
                            int group, int chunk, int chunks, float* __restrict__ o,
                            long long osb, long long osh, float* __restrict__ lse) {
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
    o[b * osb + (kh * group + g) * osh + d] = acc / l;
    if (lse != nullptr && d == 0)
      lse[(static_cast<long long>(b) * gridDim.x + kh) * group + g] = m + logf(l);
  }
}


// ---------------------------------------------------------------------------
// bf16 path
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using repro_torch::sm90::ex2;
using repro_torch::sm90::smem_addr;

constexpr int STAGES = 3;       // K/V tiles in the ring
constexpr int MAX_SPLITS = 4;   // blocks per (slot, KV head): one cluster
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// the oracle's mask value -1e30 in base-2 units, so that a fully masked
// slot's log-sum-exp is the oracle's -1e30 + log(n)
constexpr float kNegInfLog2 = kNegInf * kLog2e;

// 16-byte copy into shared memory; with valid false the bytes are
// zero-filled and src is not read (src-size 0).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the row address of row l % 8 of
// matrix l / 8 and receives, of each matrix, row l / 4, columns 2 (l % 4)
// and 2 (l % 4) + 1 (with .trans: those of the transposed matrix).
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.x4.m8n8.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.x4.trans.m8n8.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += A(16x16) B(16x8), bf16 in, f32 accumulate, with rows 8-15 of A zero.
// Lane l holds a0 = A[l/4][2(l%4) + {0,1}], a2 = A[l/4][8 + 2(l%4) + {0,1}],
// b0 = B[2(l%4) + {0,1}][l/4], b1 = B[8 + 2(l%4) + {0,1}][l/4] and
// d = D[l/4][2(l%4) + {0,1}]; D's rows 8-15 are dropped.
__device__ __forceinline__ void mma_rows8(float (&d)[2], uint32_t a0, uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  [[maybe_unused]] float unused2, unused3;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %10, %10};\n"
      : "+f"(d[0]), "+f"(d[1]), "=f"(unused2), "=f"(unused3)
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1), "f"(0.f));
}

// The same with all 16 rows: a1 and a3 are rows l/4 + 8 of A's two k8
// halves, and d[2], d[3] = D[l/4 + 8][2(l%4) + {0,1}].
__device__ __forceinline__ void mma_rows16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += A B over the query rows the block holds: rows 0-7 (RH = 1) or 0-15
// (RH = 2); a[0..3] as mma_rows16 takes them, d[2 RH].
template <int RH>
__device__ __forceinline__ void mma_rows(float (&d)[2 * RH], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (RH == 1)
    mma_rows8(d, a[0], a[2], b0, b1);
  else
    mma_rows16(d, a[0], a[1], a[2], a[3], b0, b1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD, int ROWS>
struct MmaSmem {
  using TL = Tile<bf16, HD>;
  static constexpr size_t tile = sizeof(bf16) * TK * TL::kLd;
  static constexpr size_t bytes = STAGES * 2 * tile;   // stage s: K tile, then V tile
  // after the key loop the ring holds the warps' states (O, max, sum), then
  // the block's partial (O, max, sum per query head) that the cluster merges
  static constexpr int kLdO = HD + 4;
  static constexpr size_t o = 0;                                      // f32 [4][ROWS][kLdO]
  static constexpr size_t m = o + sizeof(float) * 4 * ROWS * kLdO;    // f32 [4][ROWS]
  static constexpr size_t l = m + sizeof(float) * 4 * ROWS;           // f32 [4][ROWS]
  static constexpr size_t pacc = l + sizeof(float) * 4 * ROWS;        // f32 [ROWS][HD]
  static constexpr size_t pm = pacc + sizeof(float) * ROWS * HD;      // f32 [ROWS]
  static constexpr size_t pl = pm + sizeof(float) * ROWS;             // f32 [ROWS]
  static_assert(pl + sizeof(float) * ROWS <= bytes, "merge does not fit in the ring");
};

// A slot's T visited tiles go to spans = min(T, splits) blocks; span c < spans
// holds tiles [span_begin(c), span_begin(c + 1)), at least one.
__device__ __forceinline__ int span_begin(int c, int T, int spans) {
  return static_cast<int>(static_cast<long long>(c) * T / spans);
}

// Tiles [t0, t0 + nt) of slot b, KV head kh, for the `rows` query heads at
// qrow (rows <= ROWS): their unnormalised output, max and sum (base 2) into
// shared memory at SM::pacc / pm / pl, or, if `direct`, the normalised
// output into o_row[g * osh + d] (and, given lse_row, the log-sum-exp into
// lse_row[g]).
template <int HD, int ROWS>
__device__ __forceinline__ void attend_span(const bf16* __restrict__ qrow,
                                            const bf16* __restrict__ kbase,
                                            const bf16* __restrict__ vbase, long long kss,
                                            long long vss, int t0, int nt, int n, int len,
                                            int rows, long long qsh, float scale_log2,
                                            bool direct, bf16* __restrict__ o_row,
                                            long long osh, float* __restrict__ lse_row,
                                            unsigned char* smem) {
  using TL = Tile<bf16, HD>;
  using SM = MmaSmem<HD, ROWS>;
  constexpr int RH = ROWS / 8;                         // query rows a lane carries
  constexpr int KS = HD / 16;                          // k16 steps of Q K^T
  constexpr int NJ = HD / 8;                           // n8 tiles of P V
  constexpr int kCopies = TK * TL::kVecPerRow / NT;    // 16-byte copies per thread per tile
  static_assert(TK * TL::kVecPerRow % NT == 0 && NJ % 2 == 0, "tile shape");
  static_assert(ROWS == 8 || ROWS == 16, "row block");
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row = lane / 4;    // query heads row and row + 8 hold this lane's results
  const int quad = lane % 4;

  // issue the copies of tile t (of the slot) into ring stage `stage`; rows
  // past the visited length are zero-filled, not read
  auto load_tile = [&](int t, int stage) {
    bf16* Ks = ring + stage * 2 * TK * TL::kLd;
    bf16* Vs = Ks + TK * TL::kLd;
#pragma unroll
    for (int k = 0; k < kCopies; ++k) {
      const int i = tid + k * NT;
      const int r = i / TL::kVecPerRow;
      const int col = (i % TL::kVecPerRow) * TL::kVec;
      const int pos = t * TK + r;
      const bool ok = pos < n;
      const long long at = ok ? pos : 0;
      cp_async16(smem_addr(Ks + r * TL::kLd + col), kbase + at * kss + col, ok);
      cp_async16(smem_addr(Vs + r * TL::kLd + col), vbase + at * vss + col, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt) load_tile(t0 + s, s);
    cp_async_commit();
  }

  // A operand of Q K^T: rows `row` and `row + 8` of the block, zeros past
  // its rows (and rows 8-15 with ROWS 8)
  uint32_t qa[KS][4];
  {
    const bf16* qp = qrow + row * qsh + 2 * quad;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qa[ks][0] = row < rows ? *reinterpret_cast<const uint32_t*>(qp + 16 * ks) : 0u;
      qa[ks][2] = row < rows ? *reinterpret_cast<const uint32_t*>(qp + 16 * ks + 8) : 0u;
      const bool hi = RH == 2 && row + 8 < rows;
      qa[ks][1] = hi ? *reinterpret_cast<const uint32_t*>(qp + 8 * qsh + 16 * ks) : 0u;
      qa[ks][3] = hi ? *reinterpret_cast<const uint32_t*>(qp + 8 * qsh + 16 * ks + 8) : 0u;
    }
  }

  // per row half h (rows row + 8 h): running max over the warp's keys (base
  // 2), this lane's share of the row sum, and O's columns 8 j + 2 quad + {0,1}
  // at acc[j][2 h + {0,1}]
  float m[RH], l[RH];
  float acc[NJ][2 * RH];
#pragma unroll
  for (int h = 0; h < RH; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2 * RH; ++e) acc[j][e] = 0.f;

  // ldmatrix row addresses (bytes) of this lane inside the warp's 16 keys
  const uint32_t k_off =
      ((((lane >> 4) << 3) + (lane & 7)) * TL::kLd + ((lane >> 3) & 1) * 8) * sizeof(bf16);
  const uint32_t v_off =
      (((((lane >> 3) & 1) << 3) + (lane & 7)) * TL::kLd + (lane >> 4) * 8) * sizeof(bf16);

  for (int i = 0; i < nt; ++i) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of tile i have landed
    __syncthreads();               // everyone's have; stage (i-1) % STAGES is free
    if (i + STAGES - 1 < nt) load_tile(t0 + i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();

    const uint32_t ks_base =
        smem_addr(ring + (i % STAGES) * 2 * TK * TL::kLd + warp * 16 * TL::kLd);
    const uint32_t vs_base = ks_base + TK * TL::kLd * sizeof(bf16);

    // S = Q K^T over the warp's 16 keys: s[0] keys 0-7, s[1] keys 8-15; of
    // each, [2 h + {0,1}] is row half h
    float s[2][2 * RH];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 2 * RH; ++e) s[t][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t kb[4];
      ldsm_x4(ks_base + k_off + ks * 16 * sizeof(bf16), kb);
      mma_rows<RH>(s[0], qa[ks], kb[0], kb[1]);
      mma_rows<RH>(s[1], qa[ks], kb[2], kb[3]);
    }

    // mask, online softmax in base 2, row half by row half; p[h][e] is key
    // 8 (e >> 1) + 2 quad + (e & 1) of the warp's 16
    const int pos0 = (t0 + i) * TK + warp * 16 + 2 * quad;
    float p[RH][4];
#pragma unroll
    for (int h = 0; h < RH; ++h) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = pos0 + (e & 1) + 8 * (e >> 1);
        const float v = s[e >> 1][2 * h + (e & 1)] * scale_log2;
        x[e] = pos >= n ? -INFINITY : (len <= 0 ? kNegInfLog2 : v);
      }
      float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float ref = m_new == -INFINITY ? 0.f : m_new;   // no key of the warp yet
      const float corr = ex2(m[h] - ref);
#pragma unroll
      for (int e = 0; e < 4; ++e) p[h][e] = ex2(x[e] - ref);
      l[h] = l[h] * corr + (p[h][0] + p[h][1]) + (p[h][2] + p[h][3]);
      m[h] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[j][2 * h] *= corr;
        acc[j][2 * h + 1] *= corr;
      }
    }

    // O += P V: P's score fragments are the A operand
    uint32_t pa[4];
    pa[0] = pack_bf16(p[0][0], p[0][1]);
    pa[2] = pack_bf16(p[0][2], p[0][3]);
    pa[1] = RH == 2 ? pack_bf16(p[RH - 1][0], p[RH - 1][1]) : 0u;
    pa[3] = RH == 2 ? pack_bf16(p[RH - 1][2], p[RH - 1][3]) : 0u;
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      uint32_t vb[4];
      ldsm_x4_trans(vs_base + v_off + j * 8 * sizeof(bf16), vb);
      mma_rows<RH>(acc[j], pa, vb[0], vb[1]);
      mma_rows<RH>(acc[j + 1], pa, vb[2], vb[3]);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < RH; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }

  // merge the four warps through shared memory (the ring is free now)
  __syncthreads();
  float* Os = reinterpret_cast<float*>(smem + SM::o);
  float* Ms = reinterpret_cast<float*>(smem + SM::m);
  float* Ls = reinterpret_cast<float*>(smem + SM::l);
#pragma unroll
  for (int h = 0; h < RH; ++h) {
    const int r = warp * ROWS + row + 8 * h;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      *reinterpret_cast<float2*>(Os + r * SM::kLdO + 8 * j + 2 * quad) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    if (quad == 0) {
      Ms[r] = m[h];
      Ls[r] = l[h];
    }
  }
  __syncthreads();
  // a warp that saw no visited key has m = -inf and weight 0; warp 0 always
  // sees the span's first key, so the block's max is finite
  float* Pacc = reinterpret_cast<float*>(smem + SM::pacc);
  float* Pm = reinterpret_cast<float*>(smem + SM::pm);
  float* Pl = reinterpret_cast<float*>(smem + SM::pl);
  for (int idx = tid; idx < rows * HD; idx += NT) {
    const int g = idx / HD;
    const int d = idx % HD;
    float mall = Ms[g];
#pragma unroll
    for (int w = 1; w < 4; ++w) mall = fmaxf(mall, Ms[w * ROWS + g]);
    float lsum = 0.f, osum = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float wt = ex2(Ms[w * ROWS + g] - mall);
      lsum = fmaf(Ls[w * ROWS + g], wt, lsum);
      osum = fmaf(Os[(w * ROWS + g) * SM::kLdO + d], wt, osum);
    }
    if (direct) {
      o_row[g * osh + d] = __float2bfloat16(__fdividef(osum, lsum));
      if (lse_row != nullptr && d == 0) lse_row[g] = (mall + __log2f(lsum)) * kLn2;
    } else {
      Pacc[idx] = osum;
      if (d == 0) {
        Pm[g] = mall;
        Pl[g] = lsum;
      }
    }
  }
}

// Block (kh * rblocks + rb, b, c): span c of slot b's visited tiles for KV
// head kh and the group's query heads [rb * ROWS, min(group, (rb + 1) *
// ROWS)).  The `splits` blocks of one (slot, KV head, row block) form a
// thread-block cluster along z; where the slot has more than one span, the
// blocks merge their partials through distributed shared memory and write
// o, each a share of it.
template <int HD, int ROWS>
__global__ void __launch_bounds__(NT)
flash_decode_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ ck,
                        const bf16* __restrict__ cv, const int* __restrict__ lengths,
                        int len_stride, int Smax, int group, int rblocks, long long qsb,
                        long long qsh, long long ksb, long long kss, long long ksh,
                        long long vsb, long long vss, long long vsh, float scale_log2,
                        bf16* __restrict__ o, long long osb, long long osh,
                        float* __restrict__ lse) {
  using SM = MmaSmem<HD, ROWS>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int kh = blockIdx.x / rblocks;
  const int g0 = blockIdx.x % rblocks * ROWS;   // the block's first query head of the group
  const int rows = min(ROWS, group - g0);       // ... and its count
  const int b = blockIdx.y;
  const int c = blockIdx.z;
  const int splits = gridDim.z;

  // positions [0, n) are visited; [0, len) are valid.  len <= 0 masks every
  // position, which the oracle turns into a uniform average over all Smax.
  const int len = lengths[b * len_stride];
  const int n = len <= 0 ? Smax : min(len, Smax);
  const int T = (n + TK - 1) / TK;
  const int spans = min(T, splits);   // the same for every block of the cluster
  bf16* o_row = o + b * osb + (kh * group + g0) * osh;
  float* lse_row = lse == nullptr ? nullptr
                                  : lse + (static_cast<long long>(b) * (gridDim.x / rblocks) +
                                           kh) * group + g0;
  if (c < spans) {
    const int t0 = span_begin(c, T, spans);
    attend_span<HD, ROWS>(q + b * qsb + (kh * group + g0) * qsh, ck + b * ksb + kh * ksh,
                          cv + b * vsb + kh * vsh, kss, vss, t0,
                          span_begin(c + 1, T, spans) - t0, n, len, rows, qsh, scale_log2,
                          spans == 1, o_row, osh, lse_row, smem);
  }
  if (spans == 1) return;

  // o = sum_r acc_r 2^(m_r - M) / sum_r l_r 2^(m_r - M) over the spans r < spans,
  // M = max_r m_r, read from the blocks' shared memory; thread `tid` of block
  // c takes four columns of one query head
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every span's partial is in its block's shared memory
  const float* Pacc = reinterpret_cast<const float*>(smem + SM::pacc);
  const float* Pm = reinterpret_cast<const float*>(smem + SM::pm);
  const float* Pl = reinterpret_cast<const float*>(smem + SM::pl);
  for (int i = c * NT + threadIdx.x; i < rows * HD / 4; i += splits * NT) {
    const int g = i / (HD / 4);
    const int d = i % (HD / 4) * 4;
    float mall = -INFINITY;
    for (int r = 0; r < spans; ++r) mall = fmaxf(mall, cluster.map_shared_rank(Pm, r)[g]);
    float lsum = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < spans; ++r) {
      const float w = ex2(cluster.map_shared_rank(Pm, r)[g] - mall);
      const float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(Pacc, r) +
                                                        g * HD + d);
      lsum = fmaf(cluster.map_shared_rank(Pl, r)[g], w, lsum);
      acc.x = fmaf(v.x, w, acc.x);
      acc.y = fmaf(v.y, w, acc.y);
      acc.z = fmaf(v.z, w, acc.z);
      acc.w = fmaf(v.w, w, acc.w);
    }
    const float inv = __fdividef(1.f, lsum);
    *reinterpret_cast<uint2*>(o_row + g * osh + d) =
        make_uint2(pack_bf16(acc.x * inv, acc.y * inv), pack_bf16(acc.z * inv, acc.w * inv));
    if (lse_row != nullptr && d == 0) lse_row[g] = (mall + __log2f(lsum)) * kLn2;
  }
  cluster.sync();   // no block leaves while another reads its shared memory
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int HD, int MAXG>
cudaError_t launch_f32(const void* q, const void* ck, const void* cv, const int* lengths,
                       int len_stride, void* o, int B, int Smax, int H, int K,
                       const long long* st, float scale, float* part, float* lse,
                       cudaStream_t stream) {
  using SM = DecodeSmem<HD, MAXG>;
  const int group = H / K;
  const int rblocks = (group + MAXG - 1) / MAXG;
  const int chunk = TK;
  const int chunks = (Smax + chunk - 1) / chunk;
  const size_t rows = static_cast<size_t>(B) * K * chunks * group;
  float* part_acc = part;
  float* part_m = part + rows * HD;
  float* part_l = part_m + rows;
  auto kernel = flash_decode_chunk_kernel<HD, MAXG>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SM::bytes));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(K * rblocks, B, chunks), NT, SM::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(ck),
      static_cast<const float*>(cv),
      lengths, len_stride, Smax, group, rblocks, chunk, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], scale, part_acc, part_m, part_l);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_combine_kernel<HD><<<dim3(K, B), NT, 0, stream>>>(
      part_acc, part_m, part_l, lengths, len_stride, Smax, group, chunk, chunks,
      static_cast<float*>(o), st[8], st[9], lse);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* ck, const void* cv, const int* lengths,
                       int len_stride, void* o, int B, int Smax, int H, int K,
                       const long long* st, float scale, float* part, float* lse,
                       cudaStream_t stream) {
  if (H / K <= 8)
    return launch_f32<HD, 8>(q, ck, cv, lengths, len_stride, o, B, Smax, H, K, st, scale,
                             part, lse, stream);
  return launch_f32<HD, ROW_BLOCK>(q, ck, cv, lengths, len_stride, o, B, Smax, H, K, st,
                                   scale, part, lse, stream);
}

template <int HD, int ROWS>
cudaError_t launch_bf16(const void* q, const void* ck, const void* cv, const int* lengths,
                        int len_stride, void* o, int B, int Smax, int H, int K, int splits,
                        const long long* st, float scale, float* lse, cudaStream_t stream) {
  using SM = MmaSmem<HD, ROWS>;
  const int group = H / K;
  const int rblocks = row_blocks(group);
  auto kernel = flash_decode_mma_kernel<HD, ROWS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SM::bytes));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K * rblocks, B, splits);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = SM::bytes;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = splits > 1;   // one block per pair needs no cluster (and is faster without)
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(q),
                            static_cast<const bf16*>(ck), static_cast<const bf16*>(cv), lengths,
                            len_stride, Smax, group, rblocks, st[0], st[1], st[2], st[3], st[4],
                            st[5], st[6], st[7], scale * kLog2e, static_cast<bf16*>(o), st[8],
                            st[9], lse);
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* ck, const void* cv, const int* lengths,
                        int len_stride, void* o, int B, int Smax, int H, int K, int splits,
                        const long long* st, float scale, float* lse, cudaStream_t stream) {
  if (splits > MAX_SPLITS) return cudaErrorInvalidValue;
  if (H / K <= 8)
    return launch_bf16<HD, 8>(q, ck, cv, lengths, len_stride, o, B, Smax, H, K, splits, st,
                              scale, lse, stream);
  return launch_bf16<HD, ROW_BLOCK>(q, ck, cv, lengths, len_stride, o, B, Smax, H, K, splits,
                                    st, scale, lse, stream);
}

}  // namespace

// strides: q (b, h), cache k (b, s, k), cache v (b, s, k), o (b, h), in
// elements; the head dim is contiguous.  lengths holds B int32 counts, or one
// with len_stride 0.  Any GQA group H / K: above 8 it is cut into
// ceil(group / 16) row blocks (decode_attention.py::row_blocks), each
// reading the cache.  bf16
// splits each (slot, KV head, row block) over `splits` <= 4 blocks (one
// cluster) and needs no scratch; f32 takes ceil(Smax/64) chunks, ignores
// `splits` and needs `part`, f32 scratch of B*K*ceil(Smax/64)*(H/K)*(hd+2)
// floats.  `lse`, if not null, receives B*H f32 log-sum-exps.  Returns the
// launches' error.
extern "C" int flash_decode_fwd(const void* q, const void* ck, const void* cv,
                                const int* lengths, int len_stride, void* o, int is_bf16,
                                int device, int B, int Smax, int H, int K, int hd, int splits,
                                const long long* strides, float scale, void* part,
                                void* lse_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (K <= 0 || H % K || splits <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* lse = static_cast<float*>(lse_out);
  if (is_bf16 && hd == 128)
    return launch_bf16<128>(q, ck, cv, lengths, len_stride, o, B, Smax, H, K, splits, strides,
                            scale, lse, s);
  if (is_bf16 && hd == 80)
    return launch_bf16<80>(q, ck, cv, lengths, len_stride, o, B, Smax, H, K, splits, strides,
                           scale, lse, s);
  if (is_bf16 && hd == 64)
    return launch_bf16<64>(q, ck, cv, lengths, len_stride, o, B, Smax, H, K, splits, strides,
                           scale, lse, s);
  if (!is_bf16 && hd == 128)
    return launch_f32<128>(q, ck, cv, lengths, len_stride, o, B, Smax, H, K, strides, scale,
                           p, lse, s);
  if (!is_bf16 && hd == 80)
    return launch_f32<80>(q, ck, cv, lengths, len_stride, o, B, Smax, H, K, strides, scale,
                          p, lse, s);
  if (!is_bf16 && hd == 64)
    return launch_f32<64>(q, ck, cv, lengths, len_stride, o, B, Smax, H, K, strides, scale,
                          p, lse, s);
  return cudaErrorInvalidValue;
}
