// gossip_mix: the federation's gossip step, a weighted sum of parameter
// rows followed by a where-select on the round's active mask, in four
// variants of one template.  CUDA C++ for sm_90a (Hopper).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/gossip_mix.py:
//   gossip_mix_pallas            (_kernel)            <Sparse=false, DP=false>
//   gossip_mix_sparse_pallas     (_sparse_kernel)     <Sparse=true,  DP=false>
//   gossip_mix_dp_pallas         (_dp_kernel)         <Sparse=false, DP=true>
//   gossip_mix_sparse_dp_pallas  (_sparse_dp_kernel)  <Sparse=true,  DP=true>
//
//   dense:      out[n] = sum_m M[n,m] * W[m]                     M (N, N)
//   sparse:     out[n] = sum_b wgt[n,b] * W[idx[n,b]]            idx, wgt (N, S)
//   dense DP:   out[n] = sum_m M[n,m] * (W+Z)[m] - M[n,n] * Z[n]
//   sparse DP:  out[n] = sum_b wgt[n,b] * (W+Z)[idx[n,b]] - wgt[n,0] * Z[n]
//   all:        out[n] = active[n] > 0 ? out[n] : W[n]
//
// W, Z, out (N, D) and M, wgt, active are fp32; idx is int32.  Slot 0 of
// a sparse row is the node itself, so wgt[n,0] is the densified diagonal.
//
// Design.  A 2-D grid: blockIdx.x is the row n, blockIdx.y a tile of
// 1024 columns; each of the 256 threads owns 4 columns of that tile,
// strided by 256 so a warp's loads are coalesced.  A thread sums its
// columns over m ascending (dense) or b ascending (sparse) with FMAs in
// fp32; the order depends on nothing but the row, so a row's result does
// not depend on the grid, N or D, and two launches agree bitwise.  The
// sparse block stages its row of (idx, wgt) in shared memory (the TPU
// kernel's scalar prefetch has no counterpart; the block loads its own
// indices); the dense block reads M[n, :] as a warp-uniform broadcast.
// An inactive row is a copy of its own W row and computes nothing: a
// where-select, so inactive rows are bitwise copies even when an active
// row holds NaN or Inf.  (The dense Pallas kernel and its jnp oracle
// blend arithmetically, act*mixed + (1-act)*w, which lets 0*NaN reach
// inactive rows; the port does not copy that.)  Any N and D are taken:
// the ragged D edge is masked, and nothing is padded to 8 rows or to 512
// columns as the TPU wrappers do.  An index outside [0, N) reads nothing
// and turns its row into NaN, so a broken table shows in the output.
//
// What bounds it on an H100.  Every variant is a memory stream: ~2 flops
// per 4-byte element read.  At the paper's scale (replace-bg, N=226
// nodes, H=128 so D=66,689) W is 60.3 MB, more than the 50 MB L2.
//   sparse:    W read once + out written once = 120.6 MB, ~36 us at
//              3.35 TB/s.  The table makes each W row feed B+1 = 8 output
//              rows.  Blocks run row-fastest, so the blocks in flight
//              share a few column tiles (N x 1024 x 4 B = 0.9 MB each)
//              and re-reads of a tile should come from L2, not HBM.
//   sparse DP: W and Z read, out written: 180.9 MB, ~54 us.
//   dense:     at N=12 (ohiot1dm) W is 3.2 MB, out as much: ~1.9 us, so
//              the launch itself dominates.
// Making these fast (W tiles staged in shared memory by TMA, several
// rows per block) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;                   // columns per thread
constexpr int kTile = kThreads * kCols;    // columns per block

template <bool Sparse, bool DP>
__global__ void __launch_bounds__(kThreads)
gossip_mix_kernel(const float* __restrict__ mix,      // dense (N, N)
                  const int* __restrict__ idx,        // sparse (N, S)
                  const float* __restrict__ wgt,      // sparse (N, S)
                  const float* __restrict__ w,        // (N, D)
                  const float* __restrict__ z,        // DP (N, D)
                  const float* __restrict__ active,   // (N,)
                  float* __restrict__ out,            // (N, D)
                  int N, int S, long long D) {
  extern __shared__ unsigned char smem_raw[];
  const int n = blockIdx.x;
  const long long col0 = static_cast<long long>(blockIdx.y) * kTile + threadIdx.x;
  const float* w_n = w + static_cast<size_t>(n) * D;
  float* out_n = out + static_cast<size_t>(n) * D;

  if (!(active[n] > 0.0f)) {  // block-uniform: the whole block returns
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const long long d = col0 + k * kThreads;
      if (d < D) out_n[d] = w_n[d];
    }
    return;
  }

  float acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) acc[k] = 0.0f;
  float self_w = 0.0f;  // the row's own weight, for the DP restore

  if constexpr (Sparse) {
    int* s_idx = reinterpret_cast<int*>(smem_raw);
    float* s_wgt = reinterpret_cast<float*>(smem_raw + sizeof(int) * S);
    for (int b = threadIdx.x; b < S; b += kThreads) {
      s_idx[b] = idx[static_cast<size_t>(n) * S + b];
      s_wgt[b] = wgt[static_cast<size_t>(n) * S + b];
    }
    __syncthreads();
    for (int b = 0; b < S; ++b) {
      const int j = s_idx[b];
      const float c = s_wgt[b];
      if (j < 0 || j >= N) {
#pragma unroll
        for (int k = 0; k < kCols; ++k) acc[k] = __int_as_float(0x7fc00000);
        continue;
      }
      const float* w_j = w + static_cast<size_t>(j) * D;
      const float* z_j = DP ? z + static_cast<size_t>(j) * D : nullptr;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const long long d = col0 + k * kThreads;
        if (d < D) {
          float v = w_j[d];
          if constexpr (DP) v += z_j[d];
          acc[k] = fmaf(c, v, acc[k]);
        }
      }
    }
    self_w = s_wgt[0];
  } else {
    const float* mix_n = mix + static_cast<size_t>(n) * N;
    for (int m = 0; m < N; ++m) {
      const float c = mix_n[m];
      const float* w_m = w + static_cast<size_t>(m) * D;
      const float* z_m = DP ? z + static_cast<size_t>(m) * D : nullptr;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const long long d = col0 + k * kThreads;
        if (d < D) {
          float v = w_m[d];
          if constexpr (DP) v += z_m[d];
          acc[k] = fmaf(c, v, acc[k]);
        }
      }
    }
    self_w = mix_n[n];
  }

  const float* z_n = DP ? z + static_cast<size_t>(n) * D : nullptr;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const long long d = col0 + k * kThreads;
    if (d < D) {
      float r = acc[k];
      if constexpr (DP) r = r - self_w * z_n[d];  // clean-self restore
      out_n[d] = r;
    }
  }
}

template <bool Sparse, bool DP>
int launch(const float* mix, const int* idx, const float* wgt, const float* w,
           const float* z, const float* active, float* out, int N, int S,
           long long D, void* stream) {
  const long long tiles = (D + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(N), static_cast<unsigned>(tiles));
  const size_t smem = Sparse ? static_cast<size_t>(S) * (sizeof(int) + sizeof(float)) : 0;
  gossip_mix_kernel<Sparse, DP><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      mix, idx, wgt, w, z, active, out, N, S, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launcher returns the cudaError_t of its launch.  The wrapper
// (kernels/gossip_mix.py) checks N >= 1, 1 <= D, D / 1024 < 65536 tiles
// and a sparse row of at most 6144 slots (48 KB of shared memory).
extern "C" int gossip_mix_dense_launch(const float* mix, const float* w, const float* active,
                                       float* out, int N, long long D, void* stream) {
  return launch<false, false>(mix, nullptr, nullptr, w, nullptr, active, out, N, 0, D, stream);
}

extern "C" int gossip_mix_sparse_launch(const int* idx, const float* wgt, const float* w,
                                        const float* active, float* out, int N, int S,
                                        long long D, void* stream) {
  return launch<true, false>(nullptr, idx, wgt, w, nullptr, active, out, N, S, D, stream);
}

extern "C" int gossip_mix_dp_launch(const float* mix, const float* w, const float* z,
                                    const float* active, float* out, int N, long long D,
                                    void* stream) {
  return launch<false, true>(mix, nullptr, nullptr, w, z, active, out, N, 0, D, stream);
}

extern "C" int gossip_mix_sparse_dp_launch(const int* idx, const float* wgt, const float* w,
                                           const float* z, const float* active, float* out,
                                           int N, int S, long long D, void* stream) {
  return launch<true, true>(nullptr, idx, wgt, w, z, active, out, N, S, D, stream);
}
