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
// layer).  fp32 or bf16 in, the same type out; scores, softmax and the
// accumulator are fp32, as in the Pallas kernel: the scale on the scores,
// NEG_INF = -1e30 for masked scores, l clamped at 1e-30 before the divide.
// hd is 64 or 128; S a multiple of the 64-row tile (the wrapper refuses
// any other S, as repro.kernels.ops refuses S % 128 != 0: the only caller,
// gqa_attention's banded branch, takes S % 1024 == 0); window >= 1.
//
// Design.  One block per (64-row q tile, b * H + h); blocks run in no
// order, so the Pallas kernel's sequential third grid axis, which carried
// acc, m and l in VMEM scratch, becomes a loop inside the block with m, l
// and acc in registers.  The loop visits only the 64-key tiles that hold
// a key of the band of some row of the tile, from the tile of
// max(q0 - window + 1, 0) to the diagonal, instead of revisiting tile 0
// and masking duplicates; the element mask runs only on the tiles at the
// band's two edges.  Each K and V tile is staged in shared memory as fp32
// (K rows padded by 4 floats so the float4 reads of a quarter warp hit
// distinct banks); the probabilities P reuse K's space once the scores
// are in registers.  The 256 threads form 16 x 16: thread (ty, tx) owns
// rows ty + 16 i and keys tx + 16 j (i, j < 4) of the scores, and the
// same rows times columns 4 tx + 64 g .. +3 of the output, so the row
// statistics stay in the thread and a row's max and sum are xor-shuffle
// reductions over its 16 lanes.  Every sum runs in a fixed order with
// FMAs and there are no atomics, so two launches agree bitwise.
//
// What bounds it on an H100.  The work is 4 hd operations for every
// (query, key) pair in the band: at the Mistral-Large prefill (B=1,
// S=32,768, H=96, K=8, hd=128, window 4096) 1.2e10 pairs, 6.2e12
// operations, 6.25 ms at the 989 TFLOP/s of the bf16 tensor cores; the
// bytes (q, o 805 MB each, k, v 67 MB each) take 0.52 ms at 3.35 TB/s.
// So it is bound by operations.  This first kernel computes them with
// scalar fp32 FMAs, whose peak (67 TFLOP/s) alone puts it at >= 92 ms:
// it is right and simple, not fast.  The redesign (wgmma on bf16 tiles
// staged by TMA, warp-specialised, as FlashAttention-3 does) is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <>
struct Vec4<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float4 v) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
swa_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int S, int H,
                     int K, int window, float scale) {
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
  const long long q_step = static_cast<long long>(H) * HD;
  const long long kv_step = static_cast<long long>(K) * HD;
  const T* qb = q + (static_cast<long long>(b) * S * H + h) * HD;
  const T* kb = k + (static_cast<long long>(b) * S * K + g) * HD;
  const T* vb = v + (static_cast<long long>(b) * S * K + g) * HD;

  load_tile<T, HD>(qs, HD, qb, q_step, q0);

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
    __syncthreads();  // Q is staged; the last tile's P and V are read
    load_tile<T, HD>(ks, HD + kKStride, kb, kv_step, k0);
    load_tile<T, HD>(vs, HD, vb, kv_step, k0);
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
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

  T* ob = o + (static_cast<long long>(b) * S * H + h) * HD;
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

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
           int K, int window, float scale, void* stream) {
  auto kernel = swa_attention_kernel<T, HD>;
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(S / kTile), static_cast<unsigned>(B * H));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, K, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (cudaErrorInvalidValue for an hd
// other than 64 or 128).  The wrapper (kernels/swa_attention.py) checks
// the rest: contiguous (B, S, H, hd) / (B, S, K, hd) tensors of one
// dtype, H % K == 0, S a positive multiple of 64, window >= 1,
// B * H <= 65535.
extern "C" int swa_attention_launch(const void* q, const void* k, const void* v, void* o,
                                    int B, int S, int H, int K, int hd, int window,
                                    float scale, int bf16, void* stream) {
  if (hd == 64)
    return bf16 ? launch<__nv_bfloat16, 64>(q, k, v, o, B, S, H, K, window, scale, stream)
                : launch<float, 64>(q, k, v, o, B, S, H, K, window, scale, stream);
  if (hd == 128)
    return bf16 ? launch<__nv_bfloat16, 128>(q, k, v, o, B, S, H, K, window, scale, stream)
                : launch<float, 128>(q, k, v, o, B, S, H, K, window, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
