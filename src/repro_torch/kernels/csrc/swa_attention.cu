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
// fp32: swa_attention_kernel, scalar.  TF32 tensor cores would round q
// and k to 10-bit mantissas and break the 3e-5 bound that the fp32 checks
// hold, so fp32 keeps scalar FMAs: one block per (64-row q tile, b * H +
// h) loops over the band's 64-key tiles with m, l and acc in registers;
// K and V are staged in shared memory as fp32 (K rows padded by 4 floats
// so the float4 reads of a quarter warp hit distinct banks); P reuses K's
// space once the scores are in registers; the 256 threads form 16 x 16,
// thread (ty, tx) owning rows ty + 16 i and keys tx + 16 j (i, j < 4) of
// the scores and the same rows of the output, so a row's max and sum are
// xor-shuffles over its 16 lanes.  It is right and simple, not fast.
//
// fp32 from hd 256 and bf16 above it: the scalar kernel, built at a chunk
// of 256 columns.  bf16 is loaded 4 values at a time and widened to fp32,
// computed as fp32 is, and the output rounded to bf16 once (so it meets
// the fp32 bound before that rounding).  Its shared memory, 4 (2 x 64 x
// 256 + 64 x 260) = 197,632 bytes, holds one block an SM.  Above 256 the
// head dim runs in hd / 256 chunks along blockIdx.z: each chunk's block
// takes the scores over the whole head dim, 256 columns of Q and K at a
// time through the same shared memory, and writes its own 256 columns of
// O -- so it repeats Q K^T and the softmax hd / 256 times (right and
// simple, not fast).  RecurrentGemma-9B's local attention (H=16, K=1,
// window 2048) is the config that reaches hd 256; none in the repo goes
// above it.

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

// bf16 above hd 256 (the wgmma kernels take hd 64, 128 and 256): four
// values in one 8-byte load, widened to fp32; stored rounded to nearest
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

// Two blocks an SM at hd 64 and 128.  At hd 256 one block's shared
// memory (197,632 bytes) leaves room for no second, so the bound asks for
// one and lets a thread keep its 64 accumulators in up to 255 registers.
//
// HD is the block's chunk of the head dim, which is chunks x HD: a
// head dim above 256 runs HD = 256 in chunks of 256 columns (only there
// is chunks > 1).  Block (x, y, z) writes the 64 q rows x of head y and
// the output columns [z HD, z HD + HD): each tile's scores run over the
// whole head dim, chunk by chunk in ascending order, each chunk of Q and
// K staged in Q's and K's space; V's chunk z is staged with K's first
// chunk; the softmax statistics are the block's own (every chunk's block
// recomputes them, Q K^T chunks times).  At one chunk Q is staged once,
// and the FMAs and their order are those of a kernel without chunks.
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

    // the element mask, only where the tile crosses an edge of the band
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

    // online softmax: each row's 64 scores lie on the 16 lanes of its ty
    float alpha[4];
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

    __syncthreads();  // every thread is done reading K: P takes its place
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * kPStride + tx + 16 * j] = sc[i][j];
    __syncthreads();

    // acc = acc * alpha + P V
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

  T* ob = o + (static_cast<long long>(b) * S * H + h) * hd + col0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float4 out = make_float4(acc[i][c][0] / denom, acc[i][c][1] / denom,
                                     acc[i][c][2] / denom, acc[i][c][3] / denom);
      Vec4<T>::store(ob + row * q_step + 64 * c + 4 * tx, out);
    }
  }
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

__device__ __forceinline__ Block block_of(int S, int H, int K) {
  const int group = H / K;
  const int n_qt = (S + kRows - 1) / kRows;
  int idx = blockIdx.x;
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
      hopper::tma_load_4d(qs + x * kBoxBytes + half * kHalf * kRowBytes, q_map, q_full, 64 * x,
                          at.h, at.q0 + half * kHalf, at.b);
}

// The consumer's epilogue: O / l rounded to bf16 into this warpgroup's own
// rows of Q's space (its products are done), swizzled as TMA reads it,
// then one TMA store a box
template <int HD>
__device__ __forceinline__ void store_o(float (&o)[HD / 2], float (&l)[2], uint8_t* qs,
                                        const CUtensorMap* o_map, const Block& at, int cw,
                                        int r_lo, int col) {
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
      hopper::tma_store_4d(o_map, out + x * kBoxBytes, 64 * x, at.h, r_lo, at.b);
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

  const Block at = block_of(S, H, K);
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

  const Block at = block_of(S, H, K);
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

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                 int K, int window, float scale, void* stream) {
  using L = WgmmaLayout<HD>;
  void (*kernel)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, int, int, int, int, float);
  if constexpr (HD == 256)
    kernel = swa_attention_kernel_wgmma_hd256;
  else
    kernel = swa_attention_kernel_wgmma<HD>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  // setmaxnreg.inc waits for registers the producer gave back: with fewer
  // than kLaunchRegs a thread at launch, the consumers would wait forever
  if (attr.numRegs < kLaunchRegs) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[4];  // q, k, v, o
  int res = hopper::bf16_map_4d(&maps[0], q, HD, H, S, B, kHalf);
  if (res == 0) res = hopper::bf16_map_4d(&maps[1], k, HD, K, S, B, L::kKeys);
  if (res == 0) res = hopper::bf16_map_4d(&maps[2], v, HD, K, S, B, L::kKeys);
  if (res == 0) res = hopper::bf16_map_4d(&maps[3], o, HD, H, S, B, kHalf);
  if (res != 0) return res;
  const unsigned blocks = static_cast<unsigned>(B) * H * ((S + kRows - 1) / kRows);
  kernel<<<blocks, kWgmmaThreads, L::kSmem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], S, H, K, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (cudaErrorInvalidValue for an hd
// other than 64, 128 or a multiple of 256 up to 65535 x 256, or a tensor
// map cuTensorMapEncodeTiled refuses).  The wrapper zero-pads any other
// hd to the next of these.
// The wrapper (kernels/swa_attention.py) checks the rest: contiguous
// (B, S, H, hd) / (B, S, K, hd) tensors of one dtype, 16-byte aligned,
// H % K == 0, S a positive multiple of 64, window >= 1, B * H <= 65535.
extern "C" int swa_attention_launch(const void* q, const void* k, const void* v, void* o,
                                    int B, int S, int H, int K, int hd, int window,
                                    float scale, int bf16, void* stream) {
  if (hd == 64)
    return bf16 ? launch_wgmma<64>(q, k, v, o, B, S, H, K, window, scale, stream)
                : launch<float, 64>(q, k, v, o, B, S, H, K, window, scale, 1, stream);
  if (hd == 128)
    return bf16 ? launch_wgmma<128>(q, k, v, o, B, S, H, K, window, scale, stream)
                : launch<float, 128>(q, k, v, o, B, S, H, K, window, scale, 1, stream);
  if (hd == 256 && bf16) return launch_wgmma<256>(q, k, v, o, B, S, H, K, window, scale, stream);
  if (hd > 0 && hd % 256 == 0)  // fp32 from hd 256, bf16 above it: the scalar kernel in chunks
    return bf16 ? launch<__nv_bfloat16, 256>(q, k, v, o, B, S, H, K, window, scale, hd / 256,
                                             stream)
                : launch<float, 256>(q, k, v, o, B, S, H, K, window, scale, hd / 256, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
