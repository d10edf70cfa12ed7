// swa_attention: causal sliding-window attention with an online softmax,
// over the diagonal band only.  CUDA C++ for sm_90a (Hopper).
//
// Replaces the Pallas TPU kernel src/repro/kernels/swa_attention.py
// swa_attention_pallas (_kernel):
//
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, g] * hd^-0.5) v[b, j, g]
//   over the keys j with  j <= i  and  j > i - window,  g = h / (H / K).
//
// q, o (B, S, H, hd); k, v (B, S, K, hd) with H % K == 0: the KV heads
// are read in place, never repeated to H (the Pallas signature takes them
// repeated; at the LM prefill's shape that would be two 805 MB copies a
// layer).  fp32 or bf16 in, the same type out; scores, softmax statistics
// and the accumulator are fp32, as in the Pallas kernel: the scale on the
// scores, NEG_INF = -1e30 for masked scores, l clamped at 1e-30 before
// the divide.  hd is 64, 128 or a multiple of 256 (the wrapper zero-pads
// any other hd to the next of these); S a multiple of 64 (the wrapper refuses
// any other S, as repro.kernels.ops refuses S % 128 != 0: the only
// caller, gqa_attention's banded branch, takes S % 1024 == 0); window >= 1.
//
// What bounds it on an H100.  The work is 4 hd operations for every
// (query, key) pair in the band: at the Mistral-Large prefill (B=1,
// S=32,768, H=96, K=8, hd=128, window 4096) 1.2e10 pairs, 6.2e12
// operations, 6.25 ms at the 989 TFLOP/s of the bf16 tensor cores; the
// bytes (q, o 805 MB each, k, v 67 MB each) take 0.52 ms at 3.35 TB/s.
// So it is bound by operations, and only the tensor cores (wgmma) reach
// that rate: scalar fp32 FMAs peak at 67 TFLOP/s, >= 92 ms.
//
// bf16: swa_attention_kernel_wgmma, FlashAttention-3's shape.  A block
// holds one 128-row q tile of one query head; 384 threads in three
// warpgroups.  The producer warpgroup gives most of its registers back
// (setmaxnreg) and one of its threads issues every TMA load: Q once, then
// the band's K and V tiles through a ring in shared memory, each stage
// with a full barrier for K and one for V.  Tensor maps are 4-D, {hd,
// heads, S, B}, in 64-element (128-byte) boxes, 128-byte swizzled: the
// layout wgmma's shared-memory descriptors read directly; rows past S (S %
// 128 == 64) read as zeros and are never stored, and never come from the
// next batch.  Each consumer warpgroup owns 64 query rows (wgmma's M): S =
// Q K^T is a wgmma from shared memory into fp32 registers; the element
// mask runs only on tiles that cross an edge of the band; the softmax
// runs in fp32 in registers (a row lives on the 4 lanes of a quad, so
// its max takes two xor-shuffles); l sums the fp32 p; P is rounded to
// bf16 in place -- the accumulator's layout is the A operand's -- and O =
// O alpha + P V is a second wgmma with A from registers and V read
// transposed from shared memory.  Two overlaps keep the tensor cores fed
// while the softmax runs on the other units: within a warpgroup, tile
// i's Q K^T and tile i - 1's P V are issued together and tile i's softmax
// runs while P V does; between the two warpgroups, named barriers make
// them take turns to issue (pingpong), so one's softmax runs while the
// other's products do.  O is divided by max(l, 1e-30) and rounded to bf16
// once, staged in the warpgroup's own rows of Q's space and stored by TMA.
// Blocks run in the order (batch, KV head, q tile, query head): the query
// heads that share a KV head, and neighbouring q tiles, read the same K/V
// tiles from L2 close together.  Sums run in a fixed order and there are
// no atomics, so two launches agree bitwise.
//
// hd 64 and 128: 128-key tiles, a ring of 4 (hd 64) or 3 (hd 128) stages
// holding K and V together, one empty barrier a stage; the consumers take
// 232 registers.  hd 256 (swa_attention_kernel_wgmma_hd256): O (64 x 256
// fp32) alone is 128 registers a consumer thread, and 128-key Q, K and V
// tiles of 64 KB each would not fit shared memory in more than one stage.
// So K/V tiles hold 64 keys (S = Q K^T is 16 m64n64k16 steps over the
// four boxes, P V four m64n256k16 steps), which leaves O 128 + S 32 + P 16
// registers and keeps both overlaps within the consumers' 240 (the
// producer keeps 24); shared memory is Q 64 KB + 2 stages x (K 32 KB + V
// 32 KB).  With only two stages, K and V are released apart (an empty
// barrier each): K(i)'s stage once Q K^T(i) is done, V(i)'s once P V(i)
// is, so the next K tile loads during the softmax.
//
// Rounding P to bf16 (wgmma multiplies bf16, as FlashAttention-3 does)
// costs up to 2^-9 of each p: the output can move by 2^-9 sum_j p_j |v_j|
// / l on top of its own rounding, 2^-9 |o|.  ref.swa_bf16_bound states
// that limit, and the checks hold the kernel to it.
//
// fp32: swa_attention_kernel_bulk at hd 64, 128 and 256, scalar.  TF32
// tensor cores would round q and k to 10-bit mantissas and break the 3e-5
// bound that the fp32 checks hold, so fp32 keeps scalar FMAs (67 TFLOP/s):
// one block of 8 warps per (q tile, b * H + h), 64 rows at hd 64 and 256
// and 128 at hd 128, loops over the band's 64-key tiles with m, l and acc
// in registers.  Two things held the
// kernel it replaced under half that bound, and both were measured on an
// H100 (PERF.md): its loads went through registers with no overlap, and
// its 4 x 4 register tiles took 2 FMAs a float read from shared memory,
// whose 128 bytes a cycle then fed only half the 128 FMA lanes.  So one
// thread issues TMA copies of Q once and of each K and V tile (K in
// 128-byte-swizzled boxes of 32 columns, so that the float4 reads of a
// quarter warp hit distinct banks), on a full mbarrier a stage; K and V
// are released apart, and the last warp to release a stage issues the
// next copy there, so the copies overlap the FMAs and no block-wide
// barrier stands in the tile loop.  One stage each at hd 256, two at hd
// 64 and 128.  A warp owns 8 query rows (16 at hd 128); in Q K^T its
// lanes split the head dim four ways (two at hd 64 and 128), each thread
// summing 8 x 8 partial scores (8 x 4 at hd 64), 4 FMAs a float read, and
// the partial sums are added across the lanes by shuffles; P goes through
// a warp-private space; in P V a thread holds 8 rows x 8 columns of O (8
// x 4 at hd 64).  Every sum runs in a
// fixed order, with no atomics.  The replaced code, staged through
// registers, is the chunked build below (swa_attention_kernel), which
// the C entry still runs at hd 256 as one chunk.
//
// Above hd 256 (hd = 256 c, c >= 2; the wrapper pads any other hd to
// the next of these): two passes through a banded score workspace
// (launch_band; the wrapper allocates it and runs the heads in groups
// that keep it under a cap).  Pass 1
// takes Q K^T once over the head dim: one block a (128-row q tile, key
// block of its band, head), the head dim its reduction loop, streamed by
// TMA (bf16: swa_band_scores_wgmma, 64-column boxes of Q and of a
// 256-key K block, m64n256k16 on the tensor cores; fp32:
// swa_band_scores_f32, 32-column swizzled boxes, 128-key blocks, 8 x 8
// register tiles).  It scales and masks the scores (-1e30, as the
// Pallas kernel) and writes them as fp32 into the item's slab, each
// row's max and sum of exp over the block beside them.  Pass 2 (bf16:
// swa_band_pv_wgmma; fp32: swa_band_pv_f32) is one block a (q tile,
// 256 columns of O, head), the slices of a q tile back to back so that
// its slab comes from device memory once and from L2 after: it merges
// the blocks' statistics in ascending order into m and l, walks the
// band's 64-key tiles (scores and V's slice staged by TMA), p = exp(s -
// m) (bf16: rounded to bf16, so ref.swa_bf16_bound holds as it does for
// the other builds), O += P V, and writes O / l: the softmax is exact,
// with no online rescale.  What bounds it on an H100: the products,
// twice the pairs' 2 hd multiply-adds, as every build; the band's
// 128-row, 64-key alignment adds ~1.2x the pairs at window 2,048.  Both
// passes read their operands from L2 for every tile (pass 1: Q's and
// K's k-slices, 85 FLOP a byte at 128 x 256; pass 2: 4 bytes of score
// and 4 of V for every 512 FLOP), which is what the tile shapes are
// chosen for; the slab itself (1.2 GB at RecurrentGemma-9B's shape
// with hd widened) is written once and read once from device memory.
// Every sum runs in a fixed order, with no atomics, and a head's
// arithmetic does not depend on its group.  The chunked scalar build
// these replaced (swa_attention_kernel at hd 256 in hd / 256 chunks
// along blockIdx.z, each chunk's block recomputing the scores over the
// whole head dim, bf16 widened to fp32) stays for comparison, reached
// only through the C entry's kSplitChunks.  From hd 512 to 2,048 the
// band also replaced thread-block clusters of hd / 256 CTAs that split
// the head dim and exchanged partial scores through distributed shared
// memory: on an H100 it was faster at each of those hd in both dtypes
// (PERF.md; tools/swa_band_boundary.py times both, the clusters from an
// older commit's source).  At hd 256 the one-block builds stay: the band
// was slower there.  RecurrentGemma-9B's local
// attention (H=16, K=1, window 2048) is the config that reaches hd
// 256; none in the repo goes above it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---- fp32: the scalar kernel -------------------------------------------

constexpr int kTile = 64;                  // query rows and keys per tile
constexpr int kThreads = 256;              // 16 x 16
constexpr int kKStride = 4;                // K row padding (floats)
constexpr int kPStride = kTile + 16;       // P row stride (floats)
constexpr float kNegInf = -1e30f;

template <typename T>
struct Vec4;  // four consecutive elements of T as one fp32 float4

template <>
struct Vec4<float> {
  static __device__ __forceinline__ float4 load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

// bf16 in the chunked scalar build (kept for comparison): four values in
// one 8-byte load, widened to fp32; stored rounded to nearest
template <>
struct Vec4<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float4 v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 raw;
    raw.x = *reinterpret_cast<const uint32_t*>(&lo);
    raw.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

// Rows [row0, row0 + kTile) of one head, `step` elements apart in
// global memory, into shared memory as fp32 with row stride `stride`.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int stride, const T* src,
                                          long long step, int row0) {
  constexpr int kVecs = HD / 4;
  for (int i = threadIdx.x; i < kTile * kVecs; i += kThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 4;
    *reinterpret_cast<float4*>(dst + r * stride + c) = Vec4<T>::load(src + (row0 + r) * step + c);
  }
}

template <int HD>
__host__ __device__ constexpr int k_region() {  // floats of K's space, which P reuses
  return kTile * (HD + kKStride) > kTile * kPStride ? kTile * (HD + kKStride)
                                                    : kTile * kPStride;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kTile * HD + k_region<HD>());
}

// The scores of a 64 x 64 tile over the HD columns staged in qs and ks:
// sc[i][j] += q[ty + 16 i] . k[tx + 16 j]
template <int HD>
__device__ __forceinline__ void add_scores(float (&sc)[4][4], const float* qs, const float* ks,
                                           int tx, int ty) {
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * HD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * (HD + kKStride) + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = sc[i][j];
        s = fmaf(qv[i].x, kv[j].x, s);
        s = fmaf(qv[i].y, kv[j].y, s);
        s = fmaf(qv[i].z, kv[j].z, s);
        s = fmaf(qv[i].w, kv[j].w, s);
        sc[i][j] = s;
      }
  }
}

// The tile at q row q0, key k0: the scale, the element mask where the tile
// crosses an edge of the band, and the online softmax (m, l, alpha
// updated; sc becomes p).  Each row's 64 scores lie on the 16 lanes of its
// ty.
__device__ __forceinline__ void softmax_tile(float (&sc)[4][4], float (&m)[4], float (&l)[4],
                                             float (&alpha)[4], int q0, int k0, int window,
                                             float scale, int tx, int ty) {
  const bool edge = !(k0 + kTile - 1 <= q0 && k0 > q0 + kTile - 1 - window);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = sc[i][j] * scale;
      if (edge) {
        const int qp = q0 + ty + 16 * i, kp = k0 + tx + 16 * j;
        if (!(kp <= qp && kp > qp - window)) s = kNegInf;
      }
      sc[i][j] = s;
    }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3]));
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m[i], mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sc[i][j] = expf(sc[i][j] - m_new);
      sum += sc[i][j];
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    alpha[i] = expf(m[i] - m_new);
    l[i] = l[i] * alpha[i] + sum;
    m[i] = m_new;
  }
}

// P into K's space (every thread is done reading K), then acc = acc *
// alpha + P V over the HD columns of V staged in vs
template <int HD>
__device__ __forceinline__ void add_pv(float (&acc)[4][HD / 64][4], const float (&sc)[4][4],
                                       const float (&alpha)[4], float* ps, const float* vs,
                                       int tx, int ty) {
  constexpr int kCols = HD / 64;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * kPStride + tx + 16 * j] = sc[i][j];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha[i];
#pragma unroll 2
  for (int j = 0; j < kTile; j += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * kPStride + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + (j + jj) * HD + 64 * c + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y : jj == 2 ? pv[i].z : pv[i].w;
          acc[i][c][0] = fmaf(p, vv.x, acc[i][c][0]);
          acc[i][c][1] = fmaf(p, vv.y, acc[i][c][1]);
          acc[i][c][2] = fmaf(p, vv.z, acc[i][c][2]);
          acc[i][c][3] = fmaf(p, vv.w, acc[i][c][3]);
        }
      }
    }
  }
}

// O / max(l, 1e-30) for rows q0 + ty + 16 i, columns 64 c + 4 tx of ob
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* ob, long long q_step,
                                           const float (&acc)[4][HD / 64][4], const float (&l)[4],
                                           int q0, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < HD / 64; ++c) {
      const float4 out = make_float4(acc[i][c][0] / denom, acc[i][c][1] / denom,
                                     acc[i][c][2] / denom, acc[i][c][3] / denom);
      Vec4<T>::store(ob + row * q_step + 64 * c + 4 * tx, out);
    }
  }
}

// The chunked build: staged through registers, with no overlap.  Only
// HD = 256 is launched (bf16 and fp32), whose shared memory (197,632
// bytes) holds one block an SM, so the bound asks for one and lets a
// thread keep its 64 accumulators in up to 255 registers.
//
// HD is the block's chunk of the head dim, which is chunks x HD: the C
// entry's kSplitChunks runs a head dim of 256 c at HD = 256 in chunks of
// 256 columns (the code hd above 2,048 ran before the band builds, kept
// for comparison; the wrapper never sends it).  Block (x, y, z)
// writes the 64 q rows x of head y and the output columns [z HD, z HD +
// HD): each tile's scores run over the whole head dim, chunk by chunk in
// ascending order, each chunk of Q and K staged in Q's and K's space; V's
// chunk z is staged with K's first chunk; the softmax statistics are the
// block's own (every chunk's block recomputes them, Q K^T chunks times).
// At one chunk Q is staged once, and the FMAs and their order are those
// of a kernel without chunks.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, (HD == 256 ? 1 : 2))
swa_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int S, int H,
                     int K, int window, float scale, int head_chunks) {
  // a compile-time 1 below hd 256, so those builds keep no chunk loop
  const int chunks = HD == 256 ? head_chunks : 1;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // kTile x HD
  float* ks = qs + kTile * HD;                   // kTile x (HD + kKStride)
  float* ps = ks;                                // kTile x kPStride, after the scores
  float* vs = ks + k_region<HD>();               // kTile x HD
  constexpr int kCols = HD / 64;                 // float4 output groups per thread

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kTile;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int g = h / (H / K);
  const long long hd = static_cast<long long>(chunks) * HD;  // the head dim
  const long long q_step = H * hd;
  const long long kv_step = K * hd;
  const long long col0 = HD == 256 ? static_cast<long long>(blockIdx.z) * HD : 0;  // V's, O's chunk
  const T* qb = q + (static_cast<long long>(b) * S * H + h) * hd;
  const T* kb = k + (static_cast<long long>(b) * S * K + g) * hd;
  const T* vb = v + (static_cast<long long>(b) * S * K + g) * hd + col0;

  if (chunks == 1) load_tile<T, HD>(qs, HD, qb, q_step, q0);

  float acc[4][kCols][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  const int k_start = (max(q0 - window + 1, 0) / kTile) * kTile;
  for (int k0 = k_start; k0 <= q0; k0 += kTile) {
    float sc[4][4];  // scores of rows ty + 16 i against keys tx + 16 j
    for (int c = 0; c < chunks; ++c) {
      __syncthreads();  // Q is staged; the last chunk's Q and K, the last tile's P and V are read
      if (chunks > 1) load_tile<T, HD>(qs, HD, qb + c * HD, q_step, q0);
      load_tile<T, HD>(ks, HD + kKStride, kb + c * HD, kv_step, k0);
      if (c == 0) load_tile<T, HD>(vs, HD, vb, kv_step, k0);
      __syncthreads();
      if (c == 0) {  // zeroed after the loads, as sc is not live across them
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
      }
      add_scores<HD>(sc, qs, ks, tx, ty);
    }
    float alpha[4];
    softmax_tile(sc, m, l, alpha, q0, k0, window, scale, tx, ty);
    add_pv<HD>(acc, sc, alpha, ps, vs, tx, ty);
  }
  store_rows<T, HD>(o + (static_cast<long long>(b) * S * H + h) * hd + col0, q_step, acc, l, q0,
                    tx, ty);
}

constexpr int kMaxChunks = 65535;  // chunks of the head dim along gridDim.z

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
           int K, int window, float scale, int chunks, void* stream) {
  if (chunks < 1 || chunks > kMaxChunks) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = swa_attention_kernel<T, HD>;
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(S / kTile), static_cast<unsigned>(B * H),
                  static_cast<unsigned>(chunks));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, K, window, scale, chunks);
  return static_cast<int>(cudaGetLastError());
}

// ---- fp32 at hd 64, 128 and 256: staged by TMA, overlapping the FMAs ---

constexpr int kWarps = kThreads / 32;

// How the fp32 kernel's threads split a tile's work at HD.  A block holds
// kRows query rows, warp w the rows w + 8 h (h < kWarpRows): 64 rows at hd
// 64 and 256, 128 at hd 128 (16 a warp), whose shared memory and
// registers allow it.  Q K^T: the lanes form kRowGroups x kSplit groups,
// group (rg, D) taking the warp's rows h = 8 rg + i (i < 8) over the head
// dim's columns [D kPart, (D + 1) kPart), lane lk of a group's kLanes the
// keys lk + kLanes j (j < kKeys).  At hd 128 and 256 a thread sums 8 x 8
// partial scores from 16 float4 reads a step, 4 FMAs a float read (the 16
// x 16 grid's 4 x 4 tile took 2); hd 64 keeps 8 x 4 within two blocks'
// 128 registers a thread.  The D groups then sum the partial scores over
// the head dim (bulk_scores), each thread keeping kSRows rows, h = 8 rg +
// kSRows D + i, of kKeys keys: its softmax rows.  P V: lane cg of a
// group's kColLanes takes the float4 columns cg + kColLanes c (c < kCol4),
// the lane groups the rows h = 8 prg + r (r < 8) and, at hd 64, halves of
// the tile's keys (kKeyParts): 8 rows x 8 columns a thread at hd 128 and
// 256, 16 float4 reads for 256 FMAs (the grid's 4 x 16 took 20 at hd
// 256), 8 x 4 at hd 64, whose key halves are added once, after the last
// tile.
template <int HD>
struct BulkTiles {
  static constexpr int kWarpRows = HD == 128 ? 16 : 8;
  static constexpr int kRows = 8 * kWarpRows;
  static constexpr int kRowGroups = kWarpRows / 8;
  static constexpr int kSplit = HD == 256 ? 4 : 2;
  static constexpr int kPart = HD / kSplit;
  static constexpr int kLanes = 32 / (kRowGroups * kSplit);
  static constexpr int kKeys = kTile / kLanes;
  static constexpr int kSRows = 8 / kSplit;
  static constexpr int kColLanes = HD == 64 ? 16 : 32 / kRowGroups;
  static constexpr int kCol4 = HD / 4 / kColLanes;
  static constexpr int kKeyParts = 32 / (kRowGroups * kColLanes);
  static constexpr int kPvKeys = kTile / kKeyParts;
};

// The shared memory of swa_attention_kernel_bulk<HD>: kStages stages of K
// (HD / 32 boxes of kTile rows x 32 columns, 128-byte swizzled, so that
// the float4 reads of a quarter warp from 8 rows hit distinct banks), Q
// (kRows x HD), kStages stages of V, P (kRows x kTile), then the barriers
// (Q's, a full barrier for each stage of K and of V) and a release count
// for each stage of K and of V; 1,024 bytes more to align the swizzled
// boxes.
template <int HD>
struct BulkLayout {
  static constexpr int kStages = HD == 256 ? 1 : 2;
  static constexpr int kRows = BulkTiles<HD>::kRows;
  static constexpr int kQ = kRows * HD, kK = kTile * HD, kV = kTile * HD, kP = kRows * kTile;
  static constexpr int kFloats = kStages * (kK + kV) + kQ + kP;
  static constexpr size_t kSmem = 1024 + sizeof(float) * kFloats +
                                  sizeof(uint64_t) * (1 + 2 * kStages) +
                                  sizeof(uint32_t) * 2 * kStages;
  static constexpr uint32_t kTileBytes = kTile * HD * sizeof(float);  // K or V a tile
  static constexpr uint32_t kQBytes = kRows * HD * sizeof(float);
};

// The K tile at row0 (its HD / 32 swizzled boxes), or the box of `bytes`
// at row0 of Q or V, into dst, counted on `bar`: by one thread
template <int HD>
__device__ __forceinline__ void stage_k(float* dst, const CUtensorMap* map, uint64_t* bar,
                                        int head, int row0, int b) {
  hopper::mbar_expect_tx(bar, BulkLayout<HD>::kTileBytes);
  for (int x = 0; x < HD / 32; ++x)
    hopper::tma_load_4d(dst + x * kTile * 32, map, bar, 32 * x, head, row0, b);
}

__device__ __forceinline__ void stage_rows(float* dst, const CUtensorMap* map, uint64_t* bar,
                                           uint32_t bytes, int head, int row0, int b) {
  hopper::mbar_expect_tx(bar, bytes);
  hopper::tma_load_4d(dst, map, bar, 0, head, row0, b);
}

// The calling warp is done reading a stage that all kWarps warps read:
// true, on every lane, for the warp that says so last (it alone then
// stages the next tile there).  The fences order every warp's reads of
// the stage before the copy that overwrites it.
__device__ __forceinline__ bool released_last(uint32_t* count, int lane) {
  __syncwarp();
  uint32_t last = 0;
  if (lane == 0) {
    __threadfence_block();
    last = atomicAdd(count, 1u) % kWarps == kWarps - 1;
  }
  last = __shfl_sync(0xffffffffu, last, 0);
  if (last) {
    __threadfence_block();
    hopper::fence_async_smem();
  }
  return last != 0;
}

// Key c of P's row r sits at c ^ p_flip(r): the rows that a warp's lane
// groups write at once land on distinct banks.
template <int HD>
__device__ __forceinline__ int p_flip(int r) {
  return ((r / (BulkTiles<HD>::kRows / 4)) & 3) << 3;
}

// Half of the N rows of x stay with this lane and the other half go to the
// lane `mask` away, which keeps that half; each kept row gets the
// partner's partial sums added.  Lanes with `upper` keep rows [N / 2, N).
template <int N, int C>
__device__ __forceinline__ void keep_half(const float (&x)[N][C], float (&kept)[N / 2][C],
                                          bool upper, int mask) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const float theirs = __shfl_xor_sync(0xffffffffu, upper ? x[i][j] : x[i + N / 2][j], mask);
      kept[i][j] = (upper ? x[i + N / 2][j] : x[i][j]) + theirs;
    }
}

// Q K^T of a tile: sc[i][j] = q[w + 8 (8 rg + kSRows D + i)] . k[lk +
// kLanes j], the sum of the kSplit column groups' partial sums, added
// pairwise across the groups (a shfl_xor on each bit of D, the highest
// first), so that each thread ends with its own rows.  Column col of K's
// row r is at box col / 32, row r, 16-byte chunk ((col / 4) % 8) ^ (r %
// 8); a thread's rows all have r % 8 = lk % 8.
template <int HD>
__device__ __forceinline__ void bulk_scores(
    float (&sc)[BulkTiles<HD>::kSRows][BulkTiles<HD>::kKeys], const float* qs, const float* ks,
    int w, int lane) {
  using T = BulkTiles<HD>;
  const int rg = lane / (T::kLanes * T::kSplit), D = (lane / T::kLanes) % T::kSplit;
  const int lk = lane % T::kLanes;
  const float* qr = qs + (w + 64 * rg) * HD + D * T::kPart;
  const float* kr = ks + lk * 32;
  float part[8][T::kKeys];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < T::kKeys; ++j) part[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < T::kPart; d += 4) {
    const int col = D * T::kPart + d;
    const float* kc = kr + (col >> 5) * (kTile * 32) + ((((col >> 2) & 7) ^ (lk & 7)) << 2);
    float4 qv[8], kv[T::kKeys];
#pragma unroll
    for (int i = 0; i < 8; ++i) qv[i] = *reinterpret_cast<const float4*>(qr + 8 * i * HD + d);
#pragma unroll
    for (int j = 0; j < T::kKeys; ++j)
      kv[j] = *reinterpret_cast<const float4*>(kc + T::kLanes * j * 32);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < T::kKeys; ++j) {
        float s = part[i][j];
        s = fmaf(qv[i].x, kv[j].x, s);
        s = fmaf(qv[i].y, kv[j].y, s);
        s = fmaf(qv[i].z, kv[j].z, s);
        s = fmaf(qv[i].w, kv[j].w, s);
        part[i][j] = s;
      }
  }
  if constexpr (T::kSplit == 2) {
    keep_half(part, sc, D == 1, T::kLanes);
  } else {
    float half[4][T::kKeys];
    keep_half(part, half, (D >> 1) == 1, 2 * T::kLanes);
    keep_half(half, sc, (D & 1) == 1, T::kLanes);
  }
}

// The tile at q row q0, key k0 for a thread's softmax rows: the scale, the
// element mask where the tile crosses an edge of the band, and the online
// softmax (m, l, alpha updated; sc becomes p).  sc[i] is row q0 + row0 + 8
// i, keys lk + kLanes j; a row's 64 scores lie on the kLanes lanes of one
// group, so its max and sum are xor-shuffles over them.
template <int HD>
__device__ __forceinline__ void bulk_softmax(
    float (&sc)[BulkTiles<HD>::kSRows][BulkTiles<HD>::kKeys],
    float (&m)[BulkTiles<HD>::kSRows], float (&l)[BulkTiles<HD>::kSRows],
    float (&alpha)[BulkTiles<HD>::kSRows], int q0, int k0, int window, float scale, int row0,
    int lk) {
  using T = BulkTiles<HD>;
  const bool edge = !(k0 + kTile - 1 <= q0 && k0 > q0 + T::kRows - 1 - window);
#pragma unroll
  for (int i = 0; i < T::kSRows; ++i)
#pragma unroll
    for (int j = 0; j < T::kKeys; ++j) {
      float s = sc[i][j] * scale;
      if (edge) {
        const int qp = q0 + row0 + 8 * i, kp = k0 + lk + T::kLanes * j;
        if (!(kp <= qp && kp > qp - window)) s = kNegInf;
      }
      sc[i][j] = s;
    }
#pragma unroll
  for (int i = 0; i < T::kSRows; ++i) {
    float mx = sc[i][0];
#pragma unroll
    for (int j = 1; j < T::kKeys; ++j) mx = fmaxf(mx, sc[i][j]);
#pragma unroll
    for (int off = T::kLanes / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m[i], mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < T::kKeys; ++j) {
      sc[i][j] = expf(sc[i][j] - m_new);
      sum += sc[i][j];
    }
#pragma unroll
    for (int off = T::kLanes / 2; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    alpha[i] = expf(m[i] - m_new);
    l[i] = l[i] * alpha[i] + sum;
    m[i] = m_new;
  }
}

// P (the thread's softmax rows row0 + 8 i, keys lk + kLanes j) into P's
// space.  A warp writes and reads only its own rows (w mod 8), so it alone
// waits.
template <int HD>
__device__ __forceinline__ void bulk_write_p(
    float* ps, const float (&sc)[BulkTiles<HD>::kSRows][BulkTiles<HD>::kKeys], int row0, int lk) {
  using T = BulkTiles<HD>;
  __syncwarp();  // the warp's reads of the last tile's P are done
#pragma unroll
  for (int i = 0; i < T::kSRows; ++i) {
    const int r = row0 + 8 * i;
#pragma unroll
    for (int j = 0; j < T::kKeys; ++j)
      ps[r * kTile + ((lk + T::kLanes * j) ^ p_flip<HD>(r))] = sc[i][j];
  }
  __syncwarp();
}

// x of the warp's row w + 8 h, h % kSRows == i, from the lane group whose
// softmax rows hold it (group h / kSRows)
template <int HD>
__device__ __forceinline__ float row_value(const float (&x)[BulkTiles<HD>::kSRows], int i, int h) {
  using T = BulkTiles<HD>;
  return __shfl_sync(0xffffffffu, x[i], T::kLanes * (h / T::kSRows));
}

// acc = acc * alpha + P V over the thread's kPvKeys keys of the tile, its
// rows w + 8 (8 prg + r) and float4 columns cg + kColLanes c of V staged
// in vs
template <int HD>
__device__ __forceinline__ void bulk_pv(float (&acc)[8][BulkTiles<HD>::kCol4 * 4],
                                        const float (&alpha)[BulkTiles<HD>::kSRows],
                                        const float* ps, const float* vs, int w, int lane) {
  using T = BulkTiles<HD>;
  const int cg = lane % T::kColLanes, rest = lane / T::kColLanes;
  const int prg = rest / T::kKeyParts, kp = rest % T::kKeyParts;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float a = row_value<HD>(alpha, r % T::kSRows, 8 * prg + r);
#pragma unroll
    for (int e = 0; e < T::kCol4 * 4; ++e) acc[r][e] *= a;
  }
  const float* vc = vs + 4 * cg;
#pragma unroll 2
  for (int j = kp * T::kPvKeys; j < (kp + 1) * T::kPvKeys; j += 4) {
    float4 pv[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = w + 8 * (8 * prg + r);
      pv[r] = *reinterpret_cast<const float4*>(ps + row * kTile + (j ^ p_flip<HD>(row)));
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int c = 0; c < T::kCol4; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vc + (j + jj) * HD + 4 * T::kColLanes * c);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float p = jj == 0 ? pv[r].x : jj == 1 ? pv[r].y : jj == 2 ? pv[r].z : pv[r].w;
          acc[r][4 * c] = fmaf(p, vv.x, acc[r][4 * c]);
          acc[r][4 * c + 1] = fmaf(p, vv.y, acc[r][4 * c + 1]);
          acc[r][4 * c + 2] = fmaf(p, vv.z, acc[r][4 * c + 2]);
          acc[r][4 * c + 3] = fmaf(p, vv.w, acc[r][4 * c + 3]);
        }
      }
    }
  }
}

// O / max(l, 1e-30) for R of the warp's rows, w + 8 (r + r0), at the
// thread's float4 columns; rows from S on (a block of 128 rows at S % 128
// == 64) are not stored
template <int HD, int R>
__device__ __forceinline__ void bulk_store(float* ob, long long q_step,
                                           const float (&acc)[R][BulkTiles<HD>::kCol4 * 4],
                                           const float (&l)[BulkTiles<HD>::kSRows], int q0,
                                           int w, int r0, int S) {
  using T = BulkTiles<HD>;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int h = r + r0, row = q0 + w + 8 * h;
    const float denom = fmaxf(row_value<HD>(l, r % T::kSRows, h), 1e-30f);
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < T::kCol4; ++c)
      *reinterpret_cast<float4*>(ob + row * q_step + 4 * T::kColLanes * c) =
          make_float4(acc[r][4 * c] / denom, acc[r][4 * c + 1] / denom, acc[r][4 * c + 2] / denom,
                      acc[r][4 * c + 3] / denom);
  }
}

// fp32 at hd 64, 128 and 256: one block of 8 warps a (q tile of kRows
// rows, b * H + h) loops over the band's 64-key tiles with no thread
// staging anything through its registers and no block-wide barrier in
// the loop.
// One thread issues TMA copies (cp.async.bulk.tensor): Q once and each K
// and V tile, completing on a full mbarrier a stage (K in HD / 32
// 128-byte-swizzled boxes, Q and V in one box each).  A stage is handed
// back by a count in shared memory instead of an empty barrier that a
// producer warp would wait on: the last warp to finish reading a stage
// issues the copy of the tile kStages on, so the block spends no warp and
// no registers on a producer, and no warp waits for a release.  K and V
// are released apart: K(t) once Q K^T(t) is done, V(t) once P V(t) is.
// At hd 256 (one stage each, 214,048 bytes, one block an SM) K(t + 1)
// then lands during the softmax and P V(t), and V(t + 1) during Q K^T(t +
// 1); at hd 64 and 128 two stages each (99,384 bytes, two blocks an SM at
// hd 64; 230,456 at hd 128, one) give a tile's copy a whole tile of lead.
// A block of 128 rows (hd 128) walks the tiles that either half's band
// reaches, masking the rest: one tile more than a half needs.  P has a
// space of its own, warp-private, so the softmax waits for no other warp
// either.  What bounds the products is then shared memory's
// 128 bytes a cycle beside the 128 FMA lanes: BulkTiles' register tiles
// take 4 FMAs a float read (2 in the 4 x 4 tile it replaced).
template <int HD>
__global__ void __launch_bounds__(kThreads, (HD == 64 ? 2 : 1))
swa_attention_kernel_bulk(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map, float* __restrict__ o,
                          int S, int H, int K, int window, float scale) {
  using L = BulkLayout<HD>;
  using T = BulkTiles<HD>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  float* ks = reinterpret_cast<float*>(
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023));  // stage s at ks + s L::kK
  float* qs = ks + kStages * L::kK;                                       // kRows x HD
  float* vs = qs + L::kQ;                                                 // stage s at vs + s L::kV
  float* ps = vs + kStages * L::kV;                                       // kRows x kTile
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ps + L::kP);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint32_t* k_freed = reinterpret_cast<uint32_t*>(v_full + kStages);
  uint32_t* v_freed = k_freed + kStages;

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the first of the thread's softmax rows (rg, D), 8 apart
  const int row0 = w + 8 * (8 * (lane / (T::kLanes * T::kSplit)) +
                            T::kSRows * ((lane / T::kLanes) % T::kSplit));
  const int lk = lane % T::kLanes;
  const int q0 = blockIdx.x * T::kRows;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int g = h / (H / K);
  const int k_start = (max(q0 - window + 1, 0) / kTile) * kTile;
  const int n_tiles = ((min(q0 + T::kRows, S) - 1) / kTile * kTile - k_start) / kTile + 1;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      k_freed[s] = 0;
      v_freed[s] = 0;
    }
    hopper::mbar_init_fence();
    stage_rows(qs, &q_map, q_full, L::kQBytes, h, q0, b);
    for (int s = 0; s < kStages && s < n_tiles; ++s) {
      stage_k<HD>(ks + s * L::kK, &k_map, &k_full[s], g, k_start + s * kTile, b);
      stage_rows(vs + s * L::kV, &v_map, &v_full[s], L::kTileBytes, g, k_start + s * kTile, b);
    }
  }
  __syncthreads();

  float acc[8][T::kCol4 * 4];
  float m[T::kSRows], l[T::kSRows];  // of the softmax rows row0 + 8 i
#pragma unroll
  for (int i = 0; i < T::kSRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int e = 0; e < T::kCol4 * 4; ++e) acc[r][e] = 0.f;

  hopper::mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const uint32_t parity = (t / kStages) & 1;
    const int k0 = k_start + t * kTile;
    const bool refill = t + kStages < n_tiles;
    float* kst = ks + s * L::kK;
    float* vst = vs + s * L::kV;
    float sc[T::kSRows][T::kKeys];
    hopper::mbar_wait(&k_full[s], parity);
    bulk_scores<HD>(sc, qs, kst, w, lane);
    if (released_last(&k_freed[s], lane) && refill && lane == 0)
      stage_k<HD>(kst, &k_map, &k_full[s], g, k0 + kStages * kTile, b);
    float alpha[T::kSRows];
    bulk_softmax<HD>(sc, m, l, alpha, q0, k0, window, scale, row0, lk);
    bulk_write_p<HD>(ps, sc, row0, lk);
    hopper::mbar_wait(&v_full[s], parity);
    bulk_pv<HD>(acc, alpha, ps, vst, w, lane);
    if (released_last(&v_freed[s], lane) && refill && lane == 0)
      stage_rows(vst, &v_map, &v_full[s], L::kTileBytes, g, k0 + kStages * kTile, b);
  }

  float* ob = o + (static_cast<long long>(b) * S * H + h) * HD + 4 * (lane % T::kColLanes);
  const long long q_step = static_cast<long long>(H) * HD;
  if constexpr (T::kKeyParts == 1) {
    bulk_store<HD, 8>(ob, q_step, acc, l, q0, w, 8 * (lane / T::kColLanes), S);
  } else {  // the two key groups' sums, each group storing half the rows
    const int kp = lane / T::kColLanes;
    float sum[4][T::kCol4 * 4];
    keep_half(acc, sum, kp == 1, 16);
    bulk_store<HD, 4>(ob, q_step, sum, l, q0, w, 4 * kp, S);
  }
}

template <int HD>
int launch_bulk(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int K,
                int window, float scale, void* stream) {
  auto kernel = swa_attention_kernel_bulk<HD>;
  constexpr size_t smem = BulkLayout<HD>::kSmem;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[3];  // q (kRows-row boxes), k (32-column swizzled boxes), v
  constexpr int kRows = BulkTiles<HD>::kRows;
  int res = hopper::f32_map_4d(&maps[0], q, HD, H, S, B, HD, 1, kRows);
  if (res == 0) res = hopper::f32_map_4d(&maps[1], k, HD, K, S, B, 32, 1, kTile, true);
  if (res == 0) res = hopper::f32_map_4d(&maps[2], v, HD, K, S, B, HD, 1, kTile);
  if (res != 0) return res;
  const dim3 grid(static_cast<unsigned>((S + kRows - 1) / kRows), static_cast<unsigned>(B * H));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], static_cast<float*>(o), S, H, K, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16: tensor cores, TMA, warp specialisation ----------------------

constexpr int kRows = 128;                    // query rows a block; keys a K/V tile below hd 256
constexpr int kHalf = 64;                     // query rows a consumer warpgroup (wgmma's M)
constexpr int kRowBytes = 128;                // a swizzled row: 64 bf16 of hd
constexpr int kBoxBytes = kRows * kRowBytes;  // 128 rows of one 64-column box
constexpr int kWgThreads = 128;
constexpr int kWgmmaThreads = 3 * kWgThreads;  // producer + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kTurn = 3;  // named barriers kTurn, kTurn + 1: the consumers' turns
// registers: 384 threads start with 168 each (65,536 / 384, in steps of
// 8); below hd 256 the producer gives 128 x 128 back and the consumers
// take 256 x 64, at hd 256 the producer gives 128 x 144 and they take
// 256 x 72 (O alone is 128 registers a thread there)
constexpr int kLaunchRegs = 168;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct WgmmaLayout {
  static constexpr int kBoxes = HD / 64;                   // 64-column boxes of a row
  static constexpr int kKeys = HD == 256 ? 64 : kRows;     // keys a K/V tile
  static constexpr int kKvBoxBytes = kKeys * kRowBytes;    // one box of a K or V tile
  static constexpr int kQBytes = kBoxes * kBoxBytes;       // the Q tile (128 rows)
  static constexpr int kKvBytes = kBoxes * kKvBoxBytes;    // a K or V tile
  static constexpr int kStages = HD == 256 ? 2 : HD == 128 ? 3 : 4;  // the K/V ring
  static constexpr int kProducerRegs = HD == 256 ? 24 : 40;
  static constexpr int kConsumerRegs = HD == 256 ? 240 : 232;
  // Q; K full, V full, empty a stage (hd 256: K empty and V empty apart)
  static constexpr int kBarriers = 1 + (HD == 256 ? 4 : 3) * kStages;
  // 1024 bytes of slack to align the swizzle atoms
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * kStages * kKvBytes + 8 * kBarriers;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S (64 x KEYS keys, fp32) = Q K^T: Q's 64 rows at q_addr (in boxes of 128
// rows), the K tile at k_addr (in boxes of KEYS rows), both HD wide in
// 64-column boxes
template <int HD, int KEYS>
__device__ __forceinline__ void issue_qk(float (&sc)[KEYS / 2], uint32_t q_addr,
                                         uint32_t k_addr) {
  using namespace hopper;
  reg_fence(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    const uint64_t desc_q = sw128_desc(q_addr + (kk / 4) * kBoxBytes + col, 16, 1024);
    const uint64_t desc_k = sw128_desc(k_addr + (kk / 4) * KEYS * kRowBytes + col, 16, 1024);
    if constexpr (KEYS == 128)
      wgmma_m64n128k16_ss(sc, desc_q, desc_k, kk > 0);
    else
      wgmma_m64n64k16_ss(sc, desc_q, desc_k, kk > 0);
  }
  wgmma_commit();
}

// O (64 x 2N, fp32) += P V: P from registers, the V tile of KEYS keys at
// v_addr read transposed (MN-major), 16 keys a step
template <int N, int KEYS>
__device__ __forceinline__ void issue_pv(float (&o)[N], uint32_t (&p)[KEYS / 16][4],
                                         uint32_t v_addr) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) reg_fence(p[kk]);
  reg_fence(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) {
    const uint64_t desc_v = sw128_desc(v_addr + kk * 16 * kRowBytes, KEYS * kRowBytes, 1024);
    if constexpr (N == 128)
      wgmma_m64n256k16_rs(o, p[kk], desc_v);
    else if constexpr (N == 64)
      wgmma_m64n128k16_rs(o, p[kk], desc_v);
    else
      wgmma_m64n64k16_rs(o, p[kk], desc_v);
  }
  wgmma_commit();
}

// where a thread's accumulator elements lie: rows `row` and row + 8 of
// the warpgroup's 64 (the first is r_lo), columns 8 c + col + {0, 1}
struct Rows {
  int r_lo, row, col, window;
  float scale_log2;
};

// The online softmax of the KEYS-key tile at key k0, in place on sc: m,
// alpha and l updated, sc = p = exp2(S scale_log2 - m) in fp32.
template <int KEYS>
__device__ __forceinline__ void online_softmax(float (&sc)[KEYS / 2], float (&m)[2],
                                               float (&l)[2], float (&alpha)[2],
                                               const Rows& at, int k0) {
  // The element mask only where the tile crosses an edge of the band for
  // a row of this warpgroup.  A masked score is -inf: a row with no key in
  // the tile keeps m (>= kNegInf, finite) and gets p = 0, where the Pallas
  // kernel's kNegInf gives p = 1 until a key of the band arrives with
  // alpha = 0 -- the same result either way.
  const bool inside = k0 + KEYS - 1 <= at.r_lo && k0 > at.r_lo + kHalf - 1 - at.window;
  if (!inside) {
    const float masked = __int_as_float(0xff800000);
#pragma unroll
    for (int c = 0; c < KEYS / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = at.row + 8 * (e / 2), kp = k0 + 8 * c + at.col + e % 2;
        if (!(kp <= qp && kp > qp - at.window)) sc[4 * c + e] = masked;
      }
  }
  float neg_m[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {  // the row max, in the log2 domain (scale_log2 > 0)
    float mx = sc[2 * j];
#pragma unroll
    for (int c = 0; c < KEYS / 8; ++c)
      mx = fmaxf(mx, fmaxf(sc[4 * c + 2 * j], sc[4 * c + 2 * j + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(m[j], mx * at.scale_log2);
    alpha[j] = hopper::exp2_approx(m[j] - mx);
    m[j] = mx;
    neg_m[j] = -mx;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < KEYS / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = hopper::exp2_approx(fmaf(sc[4 * c + e], at.scale_log2, neg_m[e / 2]));
      sum[e / 2] += x;
      sc[4 * c + e] = x;
    }
#pragma unroll
  for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + sum[j];
}

// O *= alpha, and P rounded to bf16: fragment f of keys 16 kk .. 16 kk +
// 15 is row f % 2, columns 8 (f / 2) + col + {0, 1}, which are registers
// 8 kk + 2 f + {0, 1} of the accumulator
template <int N, int KEYS>
__device__ __forceinline__ void rescale_and_round(float (&o)[N], uint32_t (&p)[KEYS / 16][4],
                                                  const float (&sc)[KEYS / 2],
                                                  const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= alpha[(i / 2) % 2];
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) p[kk][f] = pack_bf16(sc[8 * kk + 2 * f], sc[8 * kk + 2 * f + 1]);
}

// Where a block lies: blocks in the order (b, KV head g, q tile, query
// head of g's group), so that the heads sharing a KV head, and
// neighbouring q tiles, read the same K/V tiles from L2 close together
struct Block {
  int b, g, h, q0;
};

__device__ __forceinline__ Block block_of(int S, int H, int K, int idx) {
  const int group = H / K;
  const int n_qt = (S + kRows - 1) / kRows;
  const int h_in_group = idx % group;
  idx /= group;
  const int qt = idx % n_qt;
  idx /= n_qt;
  const int g = idx % K;
  return {idx / K, g, g * group + h_in_group, qt * kRows};
}

// Q's 64-row halves with a row < S, by TMA into Q's space
template <int HD>
__device__ __forceinline__ void load_q(uint8_t* qs, const CUtensorMap* q_map, uint64_t* q_full,
                                       const Block& at, int S) {
  const int halves = at.q0 + kHalf < S ? 2 : 1;
  hopper::mbar_expect_tx(q_full, halves * (HD / 64) * kHalf * kRowBytes);
  for (int half = 0; half < halves; ++half)
    for (int x = 0; x < HD / 64; ++x)
      hopper::tma_load_4d(qs + x * kBoxBytes + half * kHalf * kRowBytes, q_map, q_full,
                          64 * x, at.h, at.q0 + half * kHalf, at.b);
}

// The consumer's epilogue: O / l rounded to bf16 into this warpgroup's own
// rows of Q's space (its products are done), swizzled as TMA reads it,
// then one TMA store a box, from output column c0
template <int HD>
__device__ __forceinline__ void store_o(float (&o)[HD / 2], float (&l)[2], uint8_t* qs,
                                        const CUtensorMap* o_map, const Block& at, int cw,
                                        int r_lo, int col, int c0 = 0) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  // a row's four partial sums of l, in a fixed order
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
    l[j] = fmaxf(l[j], 1e-30f);
  }
  uint8_t* out = qs + cw * kHalf * kRowBytes;
#pragma unroll
  for (int c = 0; c < HD / 8; ++c)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = 16 * warp + lane / 4 + 8 * j;
      const int chunk = (c % 8) ^ (r % 8);
      *reinterpret_cast<uint32_t*>(out + (c / 8) * kBoxBytes + r * kRowBytes + chunk * 16 +
                                   2 * col) =
          pack_bf16(o[4 * c + 2 * j] / l[j], o[4 * c + 2 * j + 1] / l[j]);
    }
  hopper::fence_async_smem();
  hopper::named_barrier(1 + cw, kWgThreads);
  if (threadIdx.x % kWgThreads == 0) {
    for (int x = 0; x < HD / 64; ++x)
      hopper::tma_store_4d(o_map, out + x * kBoxBytes, c0 + 64 * x, at.h, r_lo, at.b);
    hopper::tma_store_wait();
  }
}

// Pingpong: the two consumers take turns to issue their products, named
// barrier kTurn + w opening warpgroup w's turn, so that one's softmax runs
// while the other's products hold the tensor cores.  Off in a block with a
// warpgroup past S.
struct Turns {
  int cw;
  bool on;
  __device__ __forceinline__ void mine() const {
    if (on) hopper::named_barrier(kTurn + cw, 2 * kWgThreads);
  }
  __device__ __forceinline__ void theirs() const {
    if (on) hopper::named_barrier_arrive(kTurn + 1 - cw, 2 * kWgThreads);
  }
};

// hd 64 and 128: 128-key tiles, K and V of a tile in one stage of the
// ring, released together
template <int HD>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
swa_attention_kernel_wgmma(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap o_map, int S, int H, int K,
                           int window, float scale_log2) {
  using namespace hopper;
  using L = WgmmaLayout<HD>;
  static_assert(L::kKeys == kRows, "one K/V tile a q tile");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* kv = qs + L::kQBytes;  // stage s: K at kv + 2 s tiles, V the tile after
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv + 2 * L::kStages * L::kKvBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + L::kStages;
  uint64_t* empty = v_full + L::kStages;

  const Block at = block_of(S, H, K, blockIdx.x);
  const int t_first = max(at.q0 - window + 1, 0) / kRows;
  const int n_tiles = at.q0 / kRows - t_first + 1;  // the band's K/V tiles, through the diagonal

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the warpgroup, through a shuffle so that the compiler sees it is the
  // same on every lane: setmaxnreg holds only in a warp-uniform branch
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWgThreads, 0);
  if (wg == 0) {  // producer
    regs_release<L::kProducerRegs>();
    if (threadIdx.x == 0) {
      load_q<HD>(qs, &q_map, q_full, at, S);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % L::kStages;
        mbar_wait(&empty[s], ((i / L::kStages) & 1) ^ 1);  // the first round passes at once
        const int k0 = (t_first + i) * kRows;
        uint8_t* ks = kv + 2 * s * L::kKvBytes;
        mbar_expect_tx(&k_full[s], L::kKvBytes);
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load_4d(ks + x * L::kKvBoxBytes, &k_map, &k_full[s], 64 * x, at.g, k0, at.b);
        mbar_expect_tx(&v_full[s], L::kKvBytes);
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load_4d(ks + L::kKvBytes + x * L::kKvBoxBytes, &v_map, &v_full[s], 64 * x, at.g,
                      k0, at.b);
      }
    }
  } else {  // two consumers, 64 query rows each
    regs_acquire<L::kConsumerRegs>();
    const int cw = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int r_lo = at.q0 + cw * kHalf;  // the warpgroup's first row
    if (r_lo >= S) {
      // rows past S (S % 128 == 64): release every stage, compute nothing
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % L::kStages;
        const uint32_t parity = (i / L::kStages) & 1;
        mbar_wait(&k_full[s], parity);
        mbar_wait(&v_full[s], parity);
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      return;
    }
    // this thread's part of a 64 x N accumulator: rows `row` and row + 8,
    // columns 8 c + col and 8 c + col + 1, at registers 4 c + {0, 1} and
    // 4 c + {2, 3}
    const int row = r_lo + 16 * warp + lane / 4;
    const int col = 2 * (lane % 4);
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this lane's part of the sum
    const uint32_t q_addr = smem_u32(qs) + cw * kHalf * kRowBytes;
    float sc[kRows / 2];        // S of a tile, then its p in fp32
    uint32_t p[kRows / 16][4];  // P in bf16: the A fragments of P V
    float alpha[2];
    auto k_tile = [&](int i) { return smem_u32(kv + 2 * (i % L::kStages) * L::kKvBytes); };
    auto parity = [](int i) { return static_cast<uint32_t>((i / L::kStages) & 1); };
    const Rows rows{r_lo, row, col, window, scale_log2};
    const Turns turn{cw, at.q0 + kHalf < S};
    if (cw == 1) turn.theirs();  // consumer 0 goes first

    mbar_wait(q_full, 0);
    mbar_wait(&k_full[0], 0);
    turn.mine();
    issue_qk<HD, kRows>(sc, q_addr, k_tile(0));
    turn.theirs();
    wgmma_wait<0>();
    reg_fence(sc);
    online_softmax<kRows>(sc, m, l, alpha, rows, t_first * kRows);
    rescale_and_round<HD / 2, kRows>(o, p, sc, alpha);
    // tile i's Q K^T and tile i - 1's P V go to the tensor cores together;
    // tile i's softmax runs while P V does
    for (int i = 1; i < n_tiles; ++i) {
      mbar_wait(&k_full[i % L::kStages], parity(i));
      mbar_wait(&v_full[(i - 1) % L::kStages], parity(i - 1));
      turn.mine();
      issue_qk<HD, kRows>(sc, q_addr, k_tile(i));
      issue_pv<HD / 2, kRows>(o, p, k_tile(i - 1) + L::kKvBytes);
      turn.theirs();
      wgmma_wait<1>();
      reg_fence(sc);
      online_softmax<kRows>(sc, m, l, alpha, rows, (t_first + i) * kRows);
      wgmma_wait<0>();
      reg_fence(o);
      if (lane == 0) mbar_arrive(&empty[(i - 1) % L::kStages]);
      rescale_and_round<HD / 2, kRows>(o, p, sc, alpha);
    }
    mbar_wait(&v_full[(n_tiles - 1) % L::kStages], parity(n_tiles - 1));
    turn.mine();
    issue_pv<HD / 2, kRows>(o, p, k_tile(n_tiles - 1) + L::kKvBytes);
    if (cw == 0) turn.theirs();  // consumer 1's last turn; its own last arrival has no taker
    wgmma_wait<0>();
    reg_fence(o);
    store_o<HD>(o, l, qs, &o_map, at, cw, r_lo, col);
  }
}

// hd 256: FlashAttention-3's hd-256 shape.  O is 64 x 256 fp32, 128
// registers a consumer thread, so K/V tiles hold 64 keys (S 32 registers,
// P 16) and the consumers take 240 registers (the producer keeps 24).
// Shared memory: Q 64 KB and a ring of 2 stages of K 32 KB and V 32 KB
// (192 KB).  With two stages, K and V have empty barriers of their own:
// K(i)'s stage is free once Q K^T(i) is done, V(i)'s once P V(i) is, so
// the producer loads K(i + 2) during tile i's softmax instead of after
// tile i + 1's P V.  Both consumers walk every tile of the block's band
// (a tile outside one warpgroup's rows is masked whole: 1 of ~33 at
// window 2048), so their turns stay paired.
__global__ void __launch_bounds__(kWgmmaThreads, 1)
swa_attention_kernel_wgmma_hd256(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map,
                                 const __grid_constant__ CUtensorMap o_map, int S, int H, int K,
                                 int window, float scale_log2) {
  using namespace hopper;
  using L = WgmmaLayout<256>;
  constexpr int kKeys = L::kKeys, kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = qs + L::kQBytes;           // K of stage s at ks + s tiles
  uint8_t* vs = ks + kStages * L::kKvBytes;  // V of stage s at vs + s tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * L::kKvBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const Block at = block_of(S, H, K, blockIdx.x);
  const int t_first = max(at.q0 - window + 1, 0) / kKeys;
  const int t_last = (min(at.q0 + kRows, S) - 1) / kKeys;  // the diagonal; no key >= S
  const int n_tiles = t_last - t_first + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], kConsumerWarps);
      mbar_init(&v_empty[s], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWgThreads, 0);
  if (wg == 0) {  // producer
    regs_release<L::kProducerRegs>();
    if (threadIdx.x == 0) {
      load_q<256>(qs, &q_map, q_full, at, S);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t released = ((i / kStages) & 1) ^ 1;  // the first round passes at once
        const int k0 = (t_first + i) * kKeys;
        mbar_wait(&k_empty[s], released);
        mbar_expect_tx(&k_full[s], L::kKvBytes);
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load_4d(ks + s * L::kKvBytes + x * L::kKvBoxBytes, &k_map, &k_full[s], 64 * x,
                      at.g, k0, at.b);
        mbar_wait(&v_empty[s], released);
        mbar_expect_tx(&v_full[s], L::kKvBytes);
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load_4d(vs + s * L::kKvBytes + x * L::kKvBoxBytes, &v_map, &v_full[s], 64 * x,
                      at.g, k0, at.b);
      }
    }
  } else {  // two consumers, 64 query rows each
    regs_acquire<L::kConsumerRegs>();
    const int cw = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int r_lo = at.q0 + cw * kHalf;
    auto parity = [](int i) { return static_cast<uint32_t>((i / kStages) & 1); };
    if (r_lo >= S) {  // rows past S: release every stage, compute nothing
      for (int i = 0; i < n_tiles; ++i) {
        mbar_wait(&k_full[i % kStages], parity(i));
        if (lane == 0) mbar_arrive(&k_empty[i % kStages]);
        mbar_wait(&v_full[i % kStages], parity(i));
        if (lane == 0) mbar_arrive(&v_empty[i % kStages]);
      }
      return;
    }
    const int row = r_lo + 16 * warp + lane / 4;
    const int col = 2 * (lane % 4);
    float o[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    const uint32_t q_addr = smem_u32(qs) + cw * kHalf * kRowBytes;
    float sc[kKeys / 2];
    uint32_t p[kKeys / 16][4];
    float alpha[2];
    auto k_tile = [&](int i) { return smem_u32(ks + (i % kStages) * L::kKvBytes); };
    auto v_tile = [&](int i) { return smem_u32(vs + (i % kStages) * L::kKvBytes); };
    const Rows rows{r_lo, row, col, window, scale_log2};
    const Turns turn{cw, at.q0 + kHalf < S};
    if (cw == 1) turn.theirs();

    mbar_wait(q_full, 0);
    mbar_wait(&k_full[0], 0);
    turn.mine();
    issue_qk<256, kKeys>(sc, q_addr, k_tile(0));
    turn.theirs();
    wgmma_wait<0>();
    reg_fence(sc);
    if (lane == 0) mbar_arrive(&k_empty[0]);
    online_softmax<kKeys>(sc, m, l, alpha, rows, t_first * kKeys);
    rescale_and_round<128, kKeys>(o, p, sc, alpha);
    for (int i = 1; i < n_tiles; ++i) {
      mbar_wait(&k_full[i % kStages], parity(i));
      mbar_wait(&v_full[(i - 1) % kStages], parity(i - 1));
      turn.mine();
      issue_qk<256, kKeys>(sc, q_addr, k_tile(i));
      issue_pv<128, kKeys>(o, p, v_tile(i - 1));
      turn.theirs();
      wgmma_wait<1>();  // Q K^T(i) is done
      reg_fence(sc);
      if (lane == 0) mbar_arrive(&k_empty[i % kStages]);
      online_softmax<kKeys>(sc, m, l, alpha, rows, (t_first + i) * kKeys);
      wgmma_wait<0>();  // P V(i - 1) is done
      reg_fence(o);
      if (lane == 0) mbar_arrive(&v_empty[(i - 1) % kStages]);
      rescale_and_round<128, kKeys>(o, p, sc, alpha);
    }
    mbar_wait(&v_full[(n_tiles - 1) % kStages], parity(n_tiles - 1));
    turn.mine();
    issue_pv<128, kKeys>(o, p, v_tile(n_tiles - 1));
    if (cw == 0) turn.theirs();
    wgmma_wait<0>();
    reg_fence(o);
    store_o<256>(o, l, qs, &o_map, at, cw, r_lo, col);
  }
}

// The tensor maps of q, k, v and o at head dim HD: 0 or a cudaError_t
template <int HD>
int wgmma_maps(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v, void* o,
               int B, int S, int H, int K) {
  using L = WgmmaLayout<HD>;
  int res = hopper::bf16_map_4d(&maps[0], q, HD, H, S, B, kHalf);
  if (res == 0) res = hopper::bf16_map_4d(&maps[1], k, HD, K, S, B, L::kKeys);
  if (res == 0) res = hopper::bf16_map_4d(&maps[2], v, HD, K, S, B, L::kKeys);
  if (res == 0) res = hopper::bf16_map_4d(&maps[3], o, HD, H, S, B, kHalf);
  return res;
}

// setmaxnreg.inc waits for registers the producer gave back: with fewer
// than kLaunchRegs a thread at launch, the consumers would wait forever
template <typename Kernel>
int check_launch_regs(Kernel kernel) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  return attr.numRegs < kLaunchRegs ? static_cast<int>(cudaErrorInvalidConfiguration) : 0;
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                 int K, int window, float scale, void* stream) {
  using L = WgmmaLayout<HD>;
  void (*kernel)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, int, int, int, int, float);
  if constexpr (HD == 256)
    kernel = swa_attention_kernel_wgmma_hd256;
  else
    kernel = swa_attention_kernel_wgmma<HD>;
  int res = check_launch_regs(kernel);
  if (res != 0) return res;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[4];  // q, k, v, o
  res = wgmma_maps<HD>(maps, q, k, v, o, B, S, H, K);
  if (res != 0) return res;
  const unsigned blocks = static_cast<unsigned>(B) * H * ((S + kRows - 1) / kRows);
  kernel<<<blocks, kWgmmaThreads, L::kSmem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], S, H, K, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// ---- above hd 256: two passes through a banded score workspace ---------
//
// A band item is one q tile of kItemRows query rows of one head; items are
// numbered (b * H + h, q tile), q tiles fastest, and a launch runs a group
// of consecutive items (the wrapper plans the groups so that the workspace
// stays under its cap).  An item's band is the keys [k_start, k_end):
// k_start the band's first 64-key tile, k_end past the diagonal (and at
// most S).  The workspace holds, for each item of the group, a slab of
// kItemRows rows x `blocks` key blocks (pass 1's block width: 256 keys in
// bf16, 128 in fp32) of fp32 scores, and beside it each row's (max, sum of
// exp) of every block.  Rows from S on are never written, nor read by a
// thread that computes.

constexpr int kItemRows = 128;  // query rows of a band item
constexpr int kBandKeysBf16 = 256, kBandKeysF32 = 128;  // keys of a pass-1 block

struct Item {
  int b, h, g, q0, k_start, k_end;
};

__device__ __forceinline__ Item item_of(int item, int S, int H, int K, int window) {
  const int n_qt = (S + kItemRows - 1) / kItemRows;
  const int bh = item / n_qt, q0 = (item % n_qt) * kItemRows, h = bh % H;
  return {bh / H, h, h / (H / K), q0, max(q0 - window + 1, 0) / kTile * kTile,
          min(q0 + kItemRows, S)};
}

// A thread's row: the merged softmax statistics over the item's band,
// the blocks' maxima first, then the sums rescaled to their max and added
// in ascending block order.  Returns (m, l); with kLog2, exp2 on the
// log2e-scaled difference (the bf16 build's exp), else expf.
template <bool kLog2>
__device__ __forceinline__ float2 merge_stats(const float2* __restrict__ row, int n) {
  float m = row[0].x;
  for (int j = 1; j < n; ++j) m = fmaxf(m, row[j].x);
  float l = 0.f;
  for (int j = 0; j < n; ++j) {
    const float2 t = row[j];
    l += t.y * (kLog2 ? hopper::exp2_approx((t.x - m) * kLog2e) : expf(t.x - m));
  }
  return make_float2(m, l);
}

// -- fp32 --

constexpr int kF32Stages = 4;    // pass 1's k-steps in flight
constexpr int kF32StepCols = 32;  // head-dim columns a k-step: one 128-byte swizzled box
constexpr int kPvStages = 2;     // pass 2's tiles in flight

struct BandF32Layout {
  static constexpr int kBox = kItemRows * kF32StepCols;  // floats of Q's or K's box a k-step
  static constexpr uint32_t kStepBytes = 2 * kBox * sizeof(float);
  static constexpr size_t kScoreSmem =
      1024 + kF32Stages * size_t{kStepBytes} + kF32Stages * (sizeof(uint64_t) + sizeof(uint32_t));
  static constexpr int kS = kTile * kTile;  // a pass-2 tile's scores, then its p
  static constexpr int kV = kTile * 256;    // a pass-2 tile's V: 64 keys x 256 columns
  static constexpr uint32_t kPvBytes = (kS + kV) * sizeof(float);
  static constexpr size_t kPvSmem =
      1024 + kPvStages * size_t{kPvBytes} + kPvStages * (sizeof(uint64_t) + sizeof(uint32_t));
};

// Pass 1, fp32: block (j, item) takes the scores of the item's 128 rows
// against its band's key block j (128 keys from k_start + 128 j), the
// head dim its reduction loop: 32-column boxes of Q and K (128-byte
// swizzled, so that the float4 reads of a quarter warp hit distinct
// banks) staged by TMA, kF32Stages k-steps in flight, the last warp to
// release a stage issuing its next copy (as swa_attention_kernel_bulk
// does).  Thread (tx, ty) of a 16 x 16 grid sums the 8 x 8 scores of rows
// ty + 16 i and keys tx + 16 j, 4 FMAs a float read.  Then the scale, the
// mask (-1e30, as the Pallas kernel), each row's max and sum of exp over
// the block, and the scores stored into the slab.
__global__ void __launch_bounds__(kThreads, 1)
swa_band_scores_f32(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map, float* __restrict__ ws,
                    float2* __restrict__ stats, int S, int H, int K, int hd, int window,
                    float scale, int item0, int blocks) {
  using L = BandF32Layout;
  const int j = blockIdx.x, rel = blockIdx.y;
  const Item at = item_of(item0 + rel, S, H, K, window);
  const int k0 = at.k_start + j * kBandKeysF32;
  if (k0 >= at.k_end) return;  // past the band of an item near the start of S
  extern __shared__ uint8_t smem_raw[];
  float* stage = reinterpret_cast<float*>(
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023));  // Q then K a stage
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + kF32Stages * 2 * L::kBox);
  uint32_t* freed = reinterpret_cast<uint32_t*>(full + kF32Stages);
  const int steps = hd / kF32StepCols;
  const CUtensorMap* qm = &q_map;
  const CUtensorMap* km = &k_map;
  auto issue = [=](int t) {  // k-step t into its stage, by one thread
    float* dst = stage + (t % kF32Stages) * 2 * L::kBox;
    uint64_t* bar = &full[t % kF32Stages];
    hopper::mbar_expect_tx(bar, L::kStepBytes);
    hopper::tma_load_4d(dst, qm, bar, t * kF32StepCols, at.h, at.q0, at.b);
    hopper::tma_load_4d(dst + L::kBox, km, bar, t * kF32StepCols, at.g, k0, at.b);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kF32Stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      freed[s] = 0;
    }
    hopper::mbar_init_fence();
    for (int t = 0; t < kF32Stages && t < steps; ++t) issue(t);
  }
  __syncthreads();

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, lane = threadIdx.x % 32;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.f;
  for (int t = 0; t < steps; ++t) {
    const int s = t % kF32Stages;
    hopper::mbar_wait(&full[s], (t / kF32Stages) & 1);
    // row r's 16-byte chunk c lies at chunk c ^ (r % 8); a thread's rows
    // all have r % 8 = ty % 8, its keys tx % 8
    const float* qs = stage + s * 2 * L::kBox + ty * kF32StepCols;
    const float* ks = stage + s * 2 * L::kBox + L::kBox + tx * kF32StepCols;
#pragma unroll 2
    for (int d = 0; d < kF32StepCols; d += 4) {
      const int cq = ((d >> 2) ^ (ty & 7)) << 2, ck = ((d >> 2) ^ (tx & 7)) << 2;
      float4 qv[8], kv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + 16 * i * kF32StepCols + cq);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        kv[jj] = *reinterpret_cast<const float4*>(ks + 16 * jj * kF32StepCols + ck);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          float a = acc[i][jj];
          a = fmaf(qv[i].x, kv[jj].x, a);
          a = fmaf(qv[i].y, kv[jj].y, a);
          a = fmaf(qv[i].z, kv[jj].z, a);
          a = fmaf(qv[i].w, kv[jj].w, a);
          acc[i][jj] = a;
        }
    }
    if (released_last(&freed[s], lane) && t + kF32Stages < steps && lane == 0)
      issue(t + kF32Stages);
  }

  const bool edge = !(k0 + kBandKeysF32 - 1 <= at.q0 && k0 > at.q0 + kItemRows - 1 - window);
  const long long keys = static_cast<long long>(blocks) * kBandKeysF32;  // a slab row
  float* srow = ws + static_cast<long long>(rel) * kItemRows * keys + j * kBandKeysF32 + tx;
  float2* trow = stats + static_cast<long long>(rel) * kItemRows * blocks + j;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 16 * i, qp = at.q0 + r;
    float mx = kNegInf;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      float s = acc[i][jj] * scale;
      const int kp = k0 + tx + 16 * jj;
      if (edge && !(kp <= qp && kp > qp - window)) s = kNegInf;
      acc[i][jj] = s;
      mx = fmaxf(mx, s);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) sum += expf(acc[i][jj] - mx);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (qp < S) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) srow[r * keys + 16 * jj] = acc[i][jj];
      if (tx == 0) trow[static_cast<long long>(r) * blocks] = make_float2(mx, sum);
    }
  }
}

// Pass 2, fp32: block (part * slices + slice, item) writes one 64-row
// part of the item, rows r0 = q0 + 64 part, at the output columns [256
// slice, 256 slice + 256).  Each thread first merges its row's statistics (warp w's rows w
// + 8 r sit on lanes r); then the block walks the 64-key tiles of its rows'
// band: a tile's scores (64 x 64 fp32 of the slab) and V's slice (64 keys x
// 256 columns) staged by TMA, kPvStages tiles in flight, released together
// by the last warp; each warp turns its own rows' scores into p = exp(s -
// m) in place and sums O += P V in 8 x 8 register tiles (rows w + 8 r,
// float4 columns lane + 32 c), as swa_attention_kernel_bulk's P V does.
// O / l at the end: the softmax is exact, with no rescale.
__global__ void __launch_bounds__(kThreads, 1)
swa_band_pv_f32(const __grid_constant__ CUtensorMap ws_map,
                const __grid_constant__ CUtensorMap v_map, const float2* __restrict__ stats,
                float* __restrict__ o, int S, int H, int K, int hd, int window, int item0,
                int blocks) {
  using L = BandF32Layout;
  const int slices = hd / 256, rel = blockIdx.y;
  const int part = blockIdx.x / slices, slice = blockIdx.x % slices;
  const Item at = item_of(item0 + rel, S, H, K, window);
  const int r0 = at.q0 + kTile * part;
  if (r0 >= S) return;  // the second part of the last item at S % 128 == 64
  const int t_first = max(r0 - window + 1, 0) / kTile;  // the rows' band, in 64-key tiles
  const int n_tiles = r0 / kTile - t_first + 1;
  const int slot0 = t_first * kTile - at.k_start;  // its first key's place in the slab row
  extern __shared__ uint8_t smem_raw[];
  float* stage = reinterpret_cast<float*>(
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023));  // scores then V a stage
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + kPvStages * (L::kS + L::kV));
  uint32_t* freed = reinterpret_cast<uint32_t*>(full + kPvStages);
  const CUtensorMap* wm = &ws_map;
  const CUtensorMap* vm = &v_map;
  auto issue = [=](int t) {  // tile t into its stage, by one thread
    float* dst = stage + (t % kPvStages) * (L::kS + L::kV);
    uint64_t* bar = &full[t % kPvStages];
    hopper::mbar_expect_tx(bar, L::kPvBytes);
    hopper::tma_load_4d(dst, wm, bar, slot0 + t * kTile, 0, rel * kItemRows + kTile * part, 0);
    hopper::tma_load_4d(dst + L::kS, vm, bar, 256 * slice, at.g, (t_first + t) * kTile, at.b);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kPvStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      freed[s] = 0;
    }
    hopper::mbar_init_fence();
    for (int t = 0; t < kPvStages && t < n_tiles; ++t) issue(t);
  }
  __syncthreads();

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nblk = (at.k_end - at.k_start + kBandKeysF32 - 1) / kBandKeysF32;
  const long long my_row =
      static_cast<long long>(rel) * kItemRows + kTile * part + w + 8 * (lane % 8);
  const float2 ml = merge_stats<false>(stats + my_row * blocks, nblk);
  float mp[4];  // m of the rows w + 8 (2 i + lane / 16) whose scores this lane turns into p
#pragma unroll
  for (int i = 0; i < 4; ++i) mp[i] = __shfl_sync(0xffffffffu, ml.x, 2 * i + lane / 16);
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kPvStages;
    hopper::mbar_wait(&full[s], (t / kPvStages) & 1);
    float* ps = stage + s * (L::kS + L::kV);
    const float* vs = ps + L::kS;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4* p = reinterpret_cast<float4*>(ps + (w + 8 * (2 * i + lane / 16)) * kTile +
                                            4 * (lane % 16));
      float4 x = *p;
      x.x = expf(x.x - mp[i]);
      x.y = expf(x.y - mp[i]);
      x.z = expf(x.z - mp[i]);
      x.w = expf(x.w - mp[i]);
      *p = x;
    }
    __syncwarp();
#pragma unroll 2
    for (int jk = 0; jk < kTile; jk += 4) {
      float4 pv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        pv[r] = *reinterpret_cast<const float4*>(ps + (w + 8 * r) * kTile + jk);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + (jk + jj) * 256 + 4 * lane +
                                                             128 * c);
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float p = jj == 0 ? pv[r].x : jj == 1 ? pv[r].y : jj == 2 ? pv[r].z : pv[r].w;
            acc[r][4 * c] = fmaf(p, vv.x, acc[r][4 * c]);
            acc[r][4 * c + 1] = fmaf(p, vv.y, acc[r][4 * c + 1]);
            acc[r][4 * c + 2] = fmaf(p, vv.z, acc[r][4 * c + 2]);
            acc[r][4 * c + 3] = fmaf(p, vv.w, acc[r][4 * c + 3]);
          }
        }
      }
    }
    hopper::fence_async_smem();  // this thread's writes of p before the copy over them
    if (released_last(&freed[s], lane) && t + kPvStages < n_tiles && lane == 0)
      issue(t + kPvStages);
  }

  float* ob = o + (static_cast<long long>(at.b) * S * H + at.h) * hd + 256 * slice + 4 * lane;
  const long long q_step = static_cast<long long>(H) * hd;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float denom = fmaxf(__shfl_sync(0xffffffffu, ml.y, r), 1e-30f);
    const long long row = r0 + w + 8 * r;
#pragma unroll
    for (int c = 0; c < 2; ++c)
      *reinterpret_cast<float4*>(ob + row * q_step + 128 * c) =
          make_float4(acc[r][4 * c] / denom, acc[r][4 * c + 1] / denom, acc[r][4 * c + 2] / denom,
                      acc[r][4 * c + 3] / denom);
  }
}

// -- bf16 --

constexpr int kBandStepBytes = kItemRows * kRowBytes + kBandKeysBf16 * kRowBytes;  // Q + K a k-step
constexpr int kBandScoreStages = 4;
constexpr int kBandScoreBoxBytes = kItemRows * 32 * sizeof(float);  // 32 keys of a score tile
constexpr int kBandTileBytes = 2 * kBandScoreBoxBytes + 4 * kTile * kRowBytes;  // scores + V
constexpr int kBandPvStages = 3;
constexpr int kBandSync = 3;  // named barrier: both consumers are done with every stage
constexpr size_t kBandScoreSmem =
    1024 + size_t{kBandScoreStages} * kBandStepBytes + 2 * 8 * kBandScoreStages;
constexpr size_t kBandPvSmem =
    1024 + size_t{kBandPvStages} * kBandTileBytes + 2 * 8 * kBandPvStages;

// 64 x 256 fp32 scores += Q K^T over the 64 columns of one k-step: Q's 64
// rows at q_addr (in a 128-row box), K's 256 keys at k_addr (one box)
__device__ __forceinline__ void issue_band_qk(float (&acc)[128], uint32_t q_addr,
                                              uint32_t k_addr) {
  using namespace hopper;
  reg_fence(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n256k16_ss(acc, sw128_desc(q_addr + kk * 32, 16, 1024),
                        sw128_desc(k_addr + kk * 32, 16, 1024), 1);
  wgmma_commit();
}

// One 64-key tile i of pass 2 for a consumer: its rows' scores (rows rr
// and rr + 8 of the item, from the tile's two 32-key boxes, 128-byte
// swizzled) turned into p = exp2(s log2e - m log2e) and rounded to bf16 in
// the A fragments' layout (fragment f of keys 16 kk .. 16 kk + 15: row rr +
// 8 (f % 2), keys 16 kk + 8 (f / 2) + col + {0, 1}), then O += P V issued;
// the product of tile i - 1, which ran while p was made, is then waited
// for and its stage released.
__device__ __forceinline__ void band_pv_tile(float (&o)[128], uint32_t (&p)[4][4],
                                             const uint8_t* stage, uint64_t* full,
                                             uint64_t* empty, int i, int rr, int col, int lane,
                                             const float (&neg_m)[2]) {
  using namespace hopper;
  const int s = i % kBandPvStages;
  mbar_wait(&full[s], (i / kBandPvStages) & 1);
  const uint8_t* sb = stage + s * kBandTileBytes;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int r = rr + 8 * (f % 2), key = 16 * kk + 8 * (f / 2) + col;
      const float2 sv = *reinterpret_cast<const float2*>(
          sb + (key / 32) * kBandScoreBoxBytes + r * 128 + ((((key % 32) / 4) ^ (lane / 4)) * 16) +
          (key % 4) * 4);
      p[kk][f] = pack_bf16(exp2_approx(fmaf(sv.x, kLog2e, neg_m[f % 2])),
                           exp2_approx(fmaf(sv.y, kLog2e, neg_m[f % 2])));
    }
  issue_pv<128, kTile>(o, p, smem_u32(sb + 2 * kBandScoreBoxBytes));
  if (i > 0) {
    wgmma_wait<1>();
    if (lane == 0) mbar_arrive(&empty[(i - 1) % kBandPvStages]);
  }
}

// Pass 1, bf16: block (j, item) takes the scores of the item's 128 rows
// against its band's key block j (256 keys from k_start + 256 j) on the
// tensor cores: a producer warpgroup streams the head dim's 64-column
// boxes of Q (128 rows) and K (256 keys) by TMA through kBandScoreStages
// stages; each consumer warpgroup accumulates its 64 rows x 256 keys in
// fp32 registers (m64n256k16 from shared memory, one k-step's products in
// flight while the next is issued).  Then, in registers, the scale, the
// mask (-1e30), each row's max and sum of exp over the block, and the
// scores stored into the slab.
__global__ void __launch_bounds__(kWgmmaThreads, 1)
swa_band_scores_wgmma(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map, float* __restrict__ ws,
                      float2* __restrict__ stats, int S, int H, int K, int hd, int window,
                      float scale, int item0, int blocks) {
  using namespace hopper;
  const int j = blockIdx.x, rel = blockIdx.y;
  const Item at = item_of(item0 + rel, S, H, K, window);
  const int k0 = at.k_start + j * kBandKeysBf16;
  if (k0 >= at.k_end) return;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* stage = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // Q then K a stage
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + kBandScoreStages * kBandStepBytes);
  uint64_t* empty = full + kBandScoreStages;
  const int steps = hd / 64;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBandScoreStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWgThreads, 0);
  if (wg == 0) {  // producer
    regs_release<24>();
    if (threadIdx.x == 0) {
      for (int t = 0; t < steps; ++t) {
        const int s = t % kBandScoreStages;
        mbar_wait(&empty[s], ((t / kBandScoreStages) & 1) ^ 1);  // the first round passes at once
        uint8_t* dst = stage + s * kBandStepBytes;
        mbar_expect_tx(&full[s], kBandStepBytes);
        tma_load_4d(dst, &q_map, &full[s], 64 * t, at.h, at.q0, at.b);
        tma_load_4d(dst + kItemRows * kRowBytes, &k_map, &full[s], 64 * t, at.g, k0, at.b);
      }
    }
    return;
  }
  regs_acquire<240>();
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int r_lo = at.q0 + cw * kHalf;
  auto parity = [](int t) { return static_cast<uint32_t>((t / kBandScoreStages) & 1); };
  if (r_lo >= S) {  // rows past S: release every stage, compute nothing
    for (int t = 0; t < steps; ++t) {
      mbar_wait(&full[t % kBandScoreStages], parity(t));
      if (lane == 0) mbar_arrive(&empty[t % kBandScoreStages]);
    }
    return;
  }
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  const uint32_t base = smem_u32(stage) + cw * kHalf * kRowBytes;
  for (int t = 0; t < steps; ++t) {
    const int s = t % kBandScoreStages;
    mbar_wait(&full[s], parity(t));
    issue_band_qk(acc, base + s * kBandStepBytes,
                  smem_u32(stage) + s * kBandStepBytes + kItemRows * kRowBytes);
    if (t > 0) {
      wgmma_wait<1>();  // k-step t - 1 is done with its stage
      if (lane == 0) mbar_arrive(&empty[(t - 1) % kBandScoreStages]);
    }
  }
  wgmma_wait<0>();
  reg_fence(acc);
  if (lane == 0) mbar_arrive(&empty[(steps - 1) % kBandScoreStages]);

  // acc[4 c + e]: row `row` + 8 (e / 2), key k0 + 8 c + col + e % 2
  const int row = r_lo + 16 * warp + lane / 4, col = 2 * (lane % 4);
  const bool edge =
      !(k0 + kBandKeysBf16 - 1 <= r_lo && k0 > r_lo + kHalf - 1 - window);
#pragma unroll
  for (int c = 0; c < 32; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float s = acc[4 * c + e] * scale;
      const int qp = row + 8 * (e / 2), kp = k0 + 8 * c + col + e % 2;
      if (edge && !(kp <= qp && kp > qp - window)) s = kNegInf;
      acc[4 * c + e] = s;
    }
  const long long keys = static_cast<long long>(blocks) * kBandKeysBf16;  // a slab row
  const int rr = row - at.q0;  // the row in the item
  float* srow =
      ws + (static_cast<long long>(rel) * kItemRows + rr) * keys + j * kBandKeysBf16 + col;
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // rows `row` and row + 8
    float mx = acc[2 * h];
#pragma unroll
    for (int c = 0; c < 32; ++c) mx = fmaxf(mx, fmaxf(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float neg = -mx * kLog2e;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) sum += exp2_approx(fmaf(acc[4 * c + 2 * h + e], kLog2e, neg));
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
#pragma unroll
    for (int c = 0; c < 32; ++c)
      *reinterpret_cast<float2*>(srow + 8 * h * keys + 8 * c) =
          make_float2(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
    if (lane % 4 == 0)
      stats[(static_cast<long long>(rel) * kItemRows + rr + 8 * h) * blocks + j] =
          make_float2(mx, sum);
  }
}

// Pass 2, bf16: block (slice, item) writes the item's 128 rows at the
// output columns [256 slice, 256 slice + 256); the c slices of an item run
// back to back, so its slab comes from device memory once and from L2
// after.  The producer streams each 64-key tile of the band: its scores
// (128 rows x 64 keys fp32, in two 32-key boxes, 128-byte swizzled) and
// V's slice (64 keys x 256 columns bf16).  Each consumer merges its rows'
// statistics, then per tile turns its 64 rows' scores into p = exp2(s
// log2e - m log2e), rounds p to bf16 in the A fragments' layout, and
// issues O += P V (m64n256k16, A from registers, V transposed from shared
// memory); the next tile's p is made while that product runs.  O / l,
// rounded to bf16 once, goes out by TMA through stage 0.
__global__ void __launch_bounds__(kWgmmaThreads, 1)
swa_band_pv_wgmma(const __grid_constant__ CUtensorMap ws_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const __grid_constant__ CUtensorMap o_map, const float2* __restrict__ stats,
                  int S, int H, int K, int window, int item0, int blocks) {
  using namespace hopper;
  const int slice = blockIdx.x, rel = blockIdx.y;
  const Item at = item_of(item0 + rel, S, H, K, window);
  const int n_tiles = (at.k_end - at.k_start) / kTile;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* stage = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // scores then V
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + kBandPvStages * kBandTileBytes);
  uint64_t* empty = full + kBandPvStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBandPvStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWgThreads, 0);
  if (wg == 0) {  // producer
    regs_release<24>();
    if (threadIdx.x == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kBandPvStages;
        mbar_wait(&empty[s], ((i / kBandPvStages) & 1) ^ 1);
        uint8_t* dst = stage + s * kBandTileBytes;
        mbar_expect_tx(&full[s], kBandTileBytes);
        for (int x = 0; x < 2; ++x)
          tma_load_4d(dst + x * kBandScoreBoxBytes, &ws_map, &full[s], kTile * i + 32 * x, 0,
                      rel * kItemRows, 0);
        for (int x = 0; x < 4; ++x)
          tma_load_4d(dst + 2 * kBandScoreBoxBytes + x * kTile * kRowBytes, &v_map, &full[s],
                      256 * slice + 64 * x, at.g, at.k_start + kTile * i, at.b);
      }
    }
    return;
  }
  regs_acquire<240>();
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int r_lo = at.q0 + cw * kHalf;
  auto parity = [](int i) { return static_cast<uint32_t>((i / kBandPvStages) & 1); };
  if (r_lo >= S) {  // rows past S: release every stage, compute nothing
    for (int i = 0; i < n_tiles; ++i) {
      mbar_wait(&full[i % kBandPvStages], parity(i));
      if (lane == 0) mbar_arrive(&empty[i % kBandPvStages]);
    }
    named_barrier(kBandSync, 2 * kWgThreads);
    return;
  }
  // rows rr and rr + 8 of the item (r % 8 == lane / 4 for both), columns
  // 8 c + col + {0, 1} of O
  const int rr = cw * kHalf + 16 * warp + lane / 4, col = 2 * (lane % 4);
  const int nblk = (at.k_end - at.k_start + kBandKeysBf16 - 1) / kBandKeysBf16;
  float neg_m[2], l[2];  // l: this lane's part of the row's sum, as store_o takes it
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float2 ml = merge_stats<true>(
        stats + (static_cast<long long>(rel) * kItemRows + rr + 8 * h) * blocks, nblk);
    neg_m[h] = -ml.x * kLog2e;
    l[h] = lane % 4 == 0 ? ml.y : 0.f;  // the quad's other parts add exact zeros
  }
  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  uint32_t pa[4][4], pb[4][4];  // two tiles' p: one in a product, the next being made
  int i = 0;
  for (; i + 1 < n_tiles; i += 2) {
    band_pv_tile(o, pa, stage, full, empty, i, rr, col, lane, neg_m);
    band_pv_tile(o, pb, stage, full, empty, i + 1, rr, col, lane, neg_m);
  }
  if (i < n_tiles) band_pv_tile(o, pa, stage, full, empty, i, rr, col, lane, neg_m);
  wgmma_wait<0>();
  reg_fence(o);
  if (lane == 0) mbar_arrive(&empty[(n_tiles - 1) % kBandPvStages]);
  named_barrier(kBandSync, 2 * kWgThreads);  // no consumer reads a stage any more
  store_o<256>(o, l, stage, &o_map, Block{at.b, at.g, at.h, at.q0}, cw, r_lo, col, 256 * slice);
}

// The passes `passes` names (1 the scores, 2 P V, 3 both) over a group of
// n_items items from item0: 0 or a cudaError_t.  ws holds n_items x 128
// rows x blocks key blocks of fp32 scores, stats n_items x 128 x blocks
// float2; blocks x the block width must hold the widest band, 64 min(2 +
// ceil((window - 1) / 64), ceil(S / 64)) keys.
int launch_band(const void* q, const void* k, const void* v, void* o, void* ws, void* stats, int B,
                int S, int H, int K, int hd, int window, float scale, int bf16, int blocks,
                int item0, int n_items, int passes, void* stream) {
  const long long items = static_cast<long long>(B) * H * ((S + kItemRows - 1) / kItemRows);
  const long long band_tiles = 2 + (static_cast<long long>(window) - 1 + kTile - 1) / kTile;
  const long long s_tiles = (S + kTile - 1) / kTile;
  const long long tiles = band_tiles < s_tiles ? band_tiles : s_tiles;
  const int width = bf16 ? kBandKeysBf16 : kBandKeysF32;
  if (hd < 256 || hd % 256 || n_items < 1 || n_items > 65535 || item0 < 0 || passes < 1 ||
      passes > 3 ||
      static_cast<long long>(item0) + n_items > items || blocks < 1 ||
      static_cast<long long>(blocks) * width < kTile * tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long keys = static_cast<long long>(blocks) * width;
  const auto cs = static_cast<cudaStream_t>(stream);
  const dim3 scores_grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_items));
  CUtensorMap maps[5];
  int res;
  if (bf16) {
    res = check_launch_regs(swa_band_scores_wgmma);
    if (res == 0) res = check_launch_regs(swa_band_pv_wgmma);
    cudaError_t err = cudaFuncSetAttribute(swa_band_scores_wgmma,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(kBandScoreSmem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(swa_band_pv_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kBandPvSmem));
    if (res == 0 && err != cudaSuccess) res = static_cast<int>(err);
    // q in 128-row boxes, k in 256-key boxes, the slab in 32-key swizzled
    // boxes of 128 rows, v and o in 64-row boxes
    if (res == 0) res = hopper::bf16_map_4d(&maps[0], q, hd, H, S, B, kItemRows);
    if (res == 0) res = hopper::bf16_map_4d(&maps[1], k, hd, K, S, B, kBandKeysBf16);
    if (res == 0)
      res = hopper::f32_map_4d(&maps[2], ws, static_cast<int>(keys), 1, n_items * kItemRows, 1, 32,
                               1, kItemRows, true);
    if (res == 0) res = hopper::bf16_map_4d(&maps[3], v, hd, K, S, B, kTile);
    if (res == 0) res = hopper::bf16_map_4d(&maps[4], o, hd, H, S, B, kHalf);
    if (res != 0) return res;
    if (passes & 1) {
      swa_band_scores_wgmma<<<scores_grid, kWgmmaThreads, kBandScoreSmem, cs>>>(
          maps[0], maps[1], static_cast<float*>(ws), static_cast<float2*>(stats), S, H, K, hd,
          window, scale, item0, blocks);
      res = static_cast<int>(cudaGetLastError());
      if (res != 0) return res;
    }
    if (passes & 2)
      swa_band_pv_wgmma<<<dim3(hd / 256, n_items), kWgmmaThreads, kBandPvSmem, cs>>>(
          maps[2], maps[3], maps[4], static_cast<const float2*>(stats), S, H, K, window, item0,
          blocks);
    return static_cast<int>(cudaGetLastError());
  }
  using L = BandF32Layout;
  cudaError_t err = cudaFuncSetAttribute(swa_band_scores_f32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::kScoreSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(swa_band_pv_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::kPvSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // q and k in 32-column swizzled boxes of 128 rows, the slab in 64 x 64
  // tiles, v in 256-column boxes of 64 keys
  res = hopper::f32_map_4d(&maps[0], q, hd, H, S, B, kF32StepCols, 1, kItemRows, true);
  if (res == 0)
    res = hopper::f32_map_4d(&maps[1], k, hd, K, S, B, kF32StepCols, 1, kItemRows, true);
  if (res == 0)
    res = hopper::f32_map_4d(&maps[2], ws, static_cast<int>(keys), 1, n_items * kItemRows, 1,
                             kTile, 1, kTile);
  if (res == 0) res = hopper::f32_map_4d(&maps[3], v, hd, K, S, B, 256, 1, kTile);
  if (res != 0) return res;
  if (passes & 1) {
    swa_band_scores_f32<<<scores_grid, kThreads, L::kScoreSmem, cs>>>(
        maps[0], maps[1], static_cast<float*>(ws), static_cast<float2*>(stats), S, H, K, hd,
        window, scale, item0, blocks);
    res = static_cast<int>(cudaGetLastError());
    if (res != 0) return res;
  }
  if (passes & 2)
    swa_band_pv_f32<<<dim3(2 * (hd / 256), n_items), kThreads, L::kPvSmem, cs>>>(
        maps[2], maps[3], static_cast<const float2*>(stats), static_cast<float*>(o), S, H, K, hd,
        window, item0, blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// How a launch splits the head dim: the wrapper (kernels/swa_attention.py,
// split_of) decides it, and this entry launches just that build.  Above
// hd 256 the wrapper calls swa_attention_band_launch instead, once a
// group of heads.
enum Split {
  kSplitOne = 0,     // hd 64, 128 or 256: one block a q tile
  kSplitChunks = 1,  // hd = 256 c: the chunked scalar hd-256 build, c chunks along blockIdx.z
};

// Returns the cudaError_t of the launch: cudaErrorInvalidValue for a
// split that does not take hd (kSplitOne: 64, 128 or 256; kSplitChunks:
// a multiple of 256 up to 65535 x 256), or a tensor map
// cuTensorMapEncodeTiled refuses.  The wrapper zero-pads any other hd to
// the next of these, and checks the rest: contiguous (B, S, H, hd) / (B,
// S, K, hd) tensors of one dtype, 16-byte aligned, H % K == 0, S a
// positive multiple of 64, window >= 1, B * H <= 65535.
extern "C" int swa_attention_launch(const void* q, const void* k, const void* v, void* o,
                                    int B, int S, int H, int K, int hd, int window,
                                    float scale, int bf16, int split, void* stream) {
  if (split == kSplitOne) {
    if (hd == 64)
      return bf16 ? launch_wgmma<64>(q, k, v, o, B, S, H, K, window, scale, stream)
                  : launch_bulk<64>(q, k, v, o, B, S, H, K, window, scale, stream);
    if (hd == 128)
      return bf16 ? launch_wgmma<128>(q, k, v, o, B, S, H, K, window, scale, stream)
                  : launch_bulk<128>(q, k, v, o, B, S, H, K, window, scale, stream);
    if (hd == 256)
      return bf16 ? launch_wgmma<256>(q, k, v, o, B, S, H, K, window, scale, stream)
                  : launch_bulk<256>(q, k, v, o, B, S, H, K, window, scale, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // kSplitChunks is the code hd 256 (one chunk, fp32) and hd above 2,048
  // ran before, kept for comparison; the wrapper never sends it
  if (split == kSplitChunks && hd >= 256 && hd % 256 == 0)
    return bf16 ? launch<__nv_bfloat16, 256>(q, k, v, o, B, S, H, K, window, scale, hd / 256,
                                             stream)
                : launch<float, 256>(q, k, v, o, B, S, H, K, window, scale, hd / 256, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Above hd 256 (and at hd 256, for comparison): the two passes
// through the banded score workspace (launch_band) over the group of
// n_items band items from item0, items numbered (b * H + h, 128-row q
// tile), q tiles fastest.  ws: n_items x 128 x blocks x (256 keys in bf16,
// 128 in fp32) fp32; stats: n_items x 128 x blocks float2, both 16-byte
// aligned.  `passes` is 3 (both) from the wrapper; 1 launches the scores
// alone, to time the passes apart.  Returns the cudaError_t of the
// launches: cudaErrorInvalidValue for an hd that is not a multiple of
// 256, a group outside the items or of more than 65,535, too few blocks
// for the band, or passes outside 1 to 3.
extern "C" int swa_attention_band_launch(const void* q, const void* k, const void* v, void* o,
                                         void* ws, void* stats, int B, int S, int H, int K,
                                         int hd, int window, float scale, int bf16, int blocks,
                                         int item0, int n_items, int passes, void* stream) {
  return launch_band(q, k, v, o, ws, stats, B, S, H, K, hd, window, scale, bf16, blocks, item0,
                     n_items, passes, stream);
}
