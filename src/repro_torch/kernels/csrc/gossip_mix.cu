// gossip_mix: the federation's gossip step, a weighted sum of parameter
// rows followed by a where-select on the round's active mask, in four
// variants, each of which one or both of two kernel templates compute.
// CUDA C++ for sm_90a (Hopper).
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
// Two designs.  Both sum each output element in the same order with the
// same fp32 operations -- acc = 0, then acc = fmaf(c, v, acc) over m
// ascending (dense) or b ascending (sparse), v = w + z for DP, then the
// DP restore acc - c_self * z_n as one FMA (what nvcc's default
// contraction makes of the row-wise kernel's expression) -- so the two
// agree bitwise, and a row's result depends on nothing but its inputs:
// not the grid, N, D or the design, and two launches agree bitwise.  An
// inactive row is a copy of its own W row and computes nothing that is
// kept: a where-select, so inactive rows are bitwise copies even when an
// active row holds NaN or Inf.  (The dense Pallas kernel and its jnp
// oracle blend arithmetically, act*mixed + (1-act)*w, which lets 0*NaN
// reach inactive rows; the port does not copy that.)  Any N and D are
// taken: the ragged D edge is masked, and nothing is padded to 8 rows or
// to 512 columns as the TPU wrappers do.  An index outside [0, N) reads
// nothing and turns its row into NaN, so a broken table shows in the
// output.
//
// Row-wise (gossip_mix_kernel): blockIdx.x is the row n, blockIdx.y a
// tile of 1024 columns; each of the 256 threads owns 4 columns, strided by
// 256 so a warp's loads are coalesced, and reads the rows it mixes
// straight from global memory.  The sparse block stages its row of (idx,
// wgt) in shared memory (the TPU kernel's scalar prefetch has no
// counterpart); the dense block reads M[n, :] as a warp-uniform
// broadcast.  It serves gossip_mix_sparse, the other three beyond the
// staged kernel's shared memory, and as gossip_mix_rowwise_launch,
// gossip_mix_dp_rowwise_launch and gossip_mix_sparse_dp_rowwise_launch
// the checks that hold the staged kernel to its bits.
//
// Column-tile-stationary (gossip_mix_staged_kernel): a tile is T columns
// of ALL N rows.  A block copies W's (and Z's) N x T tile into shared
// memory with 4-byte cp.async (a row of D = 66,689 floats starts on no
// 16-byte boundary, so neither 16-byte copies nor a TMA map -- whose row
// stride must be a multiple of 16 bytes -- can take it), waits once, and
// mixes every row's outputs from shared memory; the operator (M
// transposed, or the (N, S) table with its indices turned into offsets
// in the tile) and the mask are staged once a block.  The grid is as many
// blocks as the card holds at once, each walking tiles b, b + gridDim.x,
// ...; a block's arithmetic hides behind the other blocks of its SM.
// kernels/gossip_mix.py:_plan picks T and the block size.
//
// What bounds them on an H100.  Every variant is a memory stream: ~2
// flops per 4-byte element read.  At the paper's scale (replace-bg,
// N=226 nodes, H=128 so D=66,689) W is 60.3 MB, more than the 50 MB L2.
//   sparse:    W read once + out written once = 120.6 MB, ~36 us at
//              3.35 TB/s.
//   sparse DP: W and Z read, out written: 180.9 MB, ~54 us.
//   dense:     at N=12 (ohiot1dm) W is 3.2 MB, out as much: ~1.9 us.
// The row-wise kernel meets those bytes only at HBM.  Each active row's
// block pulls its 8 neighbours' W (and Z) rows into its SM, so between
// L2 and the SMs the sparse kernel moves 8x the bytes (162 active rows x
// 8 x 266,756 B = 346 MB; DP twice that, 692 MB): bound by L2's
// bandwidth, not HBM's.  The dense kernel at N=12 is bound by latency: 4
// loads in flight a thread and 12 dependent row reads a block.  The
// staged kernel reads each element into one SM once and takes the 8x
// re-reads from shared memory.  What bounds it instead, measured on an
// H100 (PERF.md): its device-memory traffic runs at ~2 TB/s, not the
// ~3 TB/s of a contiguous stream, because each row is touched in pieces
// of 4 T bytes -- 128 bytes at T=32 -- and reads and writes of such
// pieces interleave.  A wider tile moves that up (the sparse mix's
// traffic at T=64 runs 1.3x the rate at T=32) but costs 8 N T bytes of
// shared memory for DP: at N=226, T=64 leaves one block an SM and no
// other block to hide its arithmetic; T=32 holds three.  Pipelining
// tiles inside a block, L2 prefetch of the next tiles, coalescing the
// stores through shared memory, clusters that issue adjacent tiles
// together, and 1 or 2 columns a thread were each tried, and none was
// clearly faster.
// At N=12 the 261 tiles of T=256 are all resident at once: one memory
// round trip, then arithmetic from shared memory (a 4 x 4 register tile
// a thread; for DP, v = w + z formed once for the tile's 4 rows and
// M[n, n] for the restore read from the staged M^T).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---- row-wise: one row and 1024 columns a block ------------------------

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
int launch_rowwise(const float* mix, const int* idx, const float* wgt, const float* w,
                   const float* z, const float* active, float* out, int N, int S,
                   long long D, void* stream) {
  const long long tiles = (D + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(N), static_cast<unsigned>(tiles));
  const size_t smem = Sparse ? static_cast<size_t>(S) * (sizeof(int) + sizeof(float)) : 0;
  gossip_mix_kernel<Sparse, DP><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      mix, idx, wgt, w, z, active, out, N, S, D);
  return static_cast<int>(cudaGetLastError());
}

// ---- column-tile-stationary: T columns of every row, staged ------------

__host__ __device__ inline int round4(int x) { return (x + 3) / 4 * 4; }

constexpr int kMaxThreads = 1024;

// The staged kernel's shared memory, in 4-byte words, each part starting
// on 16 bytes: the operator -- the table's idx and wgt rows padded to
// S4 = round4(S) slots (sparse), or M^T, N rows of round4(N)
// coefficients, zero past N (dense) -- the active mask, then the tile:
// W's N x T columns, and for DP Z's after them.
// kernels/gossip_mix.py:_smem_bytes mirrors it.
struct StagedLayout {
  int op, act, tile, words;
  __host__ __device__ StagedLayout(bool sparse, bool dp, int N, int S, int T) {
    op = 0;
    act = sparse ? 2 * N * round4(S) : N * round4(N);
    tile = act + round4(N);
    words = tile + N * T * (dp ? 2 : 1);
  }
};

// Copies columns [t T, t T + T) of W's (and Z's) N rows into the tile
// by 4-byte cp.async: thread i copies column i % T of rows i / T,
// + blockDim.x / T, ..., so a warp copies 32 consecutive columns of a row
template <bool DP>
__device__ __forceinline__ void stage_tile(float* tile, const float* w, const float* z, int N,
                                           long long D, int T, long long t) {
  const long long d = t * T + threadIdx.x % T;
  if (d >= D) return;  // the ragged edge: never read
  float* dst = tile + threadIdx.x % T;
  for (int n = threadIdx.x / T; n < N; n += blockDim.x / T) {
    const size_t src = static_cast<size_t>(n) * D + d;
    hopper::cp_async_4(dst + n * T, w + src);
    if constexpr (DP) hopper::cp_async_4(dst + (N + n) * T, z + src);
  }
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 4 outputs of row n from column d on, the ragged edge masked: the mix
// where the row is active, else its own W (a where-select)
__device__ __forceinline__ void store4(float* out, long long D, int n, long long d, int cols,
                                       bool on, const float (&acc)[4], float4 own) {
  float* out_n = out + static_cast<size_t>(n) * D + d;
  const float v[4] = {on ? acc[0] : own.x, on ? acc[1] : own.y, on ? acc[2] : own.z,
                      on ? acc[3] : own.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < cols) out_n[k] = v[k];
}

// A persistent grid of as many blocks as the card holds at once: block b
// mixes tiles b, b + gridDim.x, ... in turn.  It stages the operator and
// the mask once (the table's indices turned into offsets in the tile),
// then each tile, mixes it from shared memory and stores it; the other
// blocks on its SM load while it computes.  For the arithmetic, thread i
// owns the 4 columns 4 (i % (T/4)) .. + 3 of the tile and, dense, a
// chunk of 4 rows at a time (a 4 x 4 register tile: one float4 of W's
// tile and one of M^T a column m), sparse, one row at a time (rows
// i / (T/4), + groups, ...): float4 reads of shared memory, 4 FMAs each.
template <bool Sparse, bool DP>
__global__ void __launch_bounds__(kMaxThreads)
gossip_mix_staged_kernel(const float* __restrict__ mix,     // dense (N, N)
                         const int* __restrict__ idx,       // sparse (N, S)
                         const float* __restrict__ wgt,     // sparse (N, S)
                         const float* __restrict__ w,       // (N, D)
                         const float* __restrict__ z,       // DP (N, D)
                         const float* __restrict__ active,  // (N,)
                         float* __restrict__ out,           // (N, D)
                         int N, int S, long long D, int T) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const StagedLayout at(Sparse, DP, N, S, T);
  const float* act_s = smem + at.act;
  const float* w_s = smem + at.tile;
  const float* z_s = w_s + N * T;
  const int threads = blockDim.x;
  const int lanes = T / 4, c4 = 4 * (threadIdx.x % lanes);
  const int g = threadIdx.x / lanes, groups = threads / lanes;
  const long long tiles = (D + T - 1) / T;

  // the operator and the mask, once; the first tile behind them
  if constexpr (Sparse) {
    const int s4 = round4(S);
    for (int i = threadIdx.x; i < N * S; i += threads) {
      const int n = i / S, b = i % S;
      hopper::cp_async_4(smem + at.op + n * s4 + b, idx + i);
      hopper::cp_async_4(smem + at.op + (N + n) * s4 + b, wgt + i);
    }
  } else {
    const int n4 = round4(N);  // smem[op + m n4 + n] = M[n, m]
    for (int i = threadIdx.x; i < N * n4; i += threads) {
      const int m = i / n4, n = i % n4;
      if (n < N)
        hopper::cp_async_4(smem + at.op + i, mix + static_cast<size_t>(n) * N + m);
      else
        smem[at.op + i] = 0.0f;
    }
  }
  for (int n = threadIdx.x; n < N; n += threads) hopper::cp_async_4(smem + at.act + n, active + n);
  hopper::cp_async_commit();
  if (blockIdx.x < tiles) stage_tile<DP>(smem + at.tile, w, z, N, D, T, blockIdx.x);
  hopper::cp_async_commit();
  if constexpr (Sparse) {
    // The table once in place: each index as the offset of its row in the
    // tile; an index outside [0, N) as the row's own with weight NaN, so
    // that the row's sum turns NaN, as in the row-wise kernel.
    hopper::cp_async_wait_prior<1>();  // the operator's group
    __syncthreads();
    const int s4 = round4(S);
    int* idx_s = reinterpret_cast<int*>(smem + at.op);
    float* wgt_s = smem + at.op + N * s4;
    for (int i = threadIdx.x; i < N * S; i += threads) {
      const int n = i / S, b = i % S, j = idx_s[n * s4 + b];
      const bool ok = j >= 0 && j < N;
      idx_s[n * s4 + b] = (ok ? j : n) * T;
      if (!ok) wgt_s[n * s4 + b] = __int_as_float(0x7fc00000);
    }
  }

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    if (t != blockIdx.x) {
      stage_tile<DP>(smem + at.tile, w, z, N, D, T, t);
      hopper::cp_async_commit();
    }
    hopper::cp_async_wait_prior<0>();
    __syncthreads();
    const long long d = t * T + c4;
    const int cols = D - d < 4 ? static_cast<int>(D - d) : 4;  // <= 0: past the ragged edge
    if constexpr (Sparse) {
      const int s4 = round4(S);
      const int* off_s = reinterpret_cast<const int*>(smem + at.op);
      const float* wgt_s = smem + at.op + N * s4;
      for (int n = g; n < N && cols > 0; n += groups) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int b0 = 0; b0 < S; b0 += 4) {
          const int4 o4 = *reinterpret_cast<const int4*>(&off_s[n * s4 + b0]);
          const float4 k4 = lds4(&wgt_s[n * s4 + b0]);
          const int offs[4] = {o4.x, o4.y, o4.z, o4.w};
          const float ks[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (b0 + q >= S) break;
            float4 v = lds4(&w_s[offs[q] + c4]);
            if constexpr (DP) {
              const float4 zz = lds4(&z_s[offs[q] + c4]);
              v.x += zz.x;
              v.y += zz.y;
              v.z += zz.z;
              v.w += zz.w;
            }
            acc[0] = fmaf(ks[q], v.x, acc[0]);
            acc[1] = fmaf(ks[q], v.y, acc[1]);
            acc[2] = fmaf(ks[q], v.z, acc[2]);
            acc[3] = fmaf(ks[q], v.w, acc[3]);
          }
        }
        if constexpr (DP) {  // clean-self restore
          const float self_w = wgt_s[n * s4];
          const float4 zn = lds4(&z_s[n * T + c4]);
          acc[0] = fmaf(-self_w, zn.x, acc[0]);
          acc[1] = fmaf(-self_w, zn.y, acc[1]);
          acc[2] = fmaf(-self_w, zn.z, acc[2]);
          acc[3] = fmaf(-self_w, zn.w, acc[3]);
        }
        store4(out, D, n, d, cols, act_s[n] > 0.0f, acc, lds4(&w_s[n * T + c4]));
      }
    } else {
      const int n4 = round4(N);
      const float* mt_s = smem + at.op;
      for (int n0 = 4 * g; n0 < N && cols > 0; n0 += 4 * groups) {
        float acc[4][4] = {};
#pragma unroll 4
        for (int m = 0; m < N; ++m) {
          float4 v = lds4(&w_s[m * T + c4]);
          if constexpr (DP) {  // v = w + z once, for the tile's 4 rows
            const float4 zz = lds4(&z_s[m * T + c4]);
            v.x += zz.x;
            v.y += zz.y;
            v.z += zz.z;
            v.w += zz.w;
          }
          const float4 cf = lds4(&mt_s[m * n4 + n0]);
          const float vs[4] = {v.x, v.y, v.z, v.w};
          const float cs[4] = {cf.x, cf.y, cf.z, cf.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(cs[r], vs[k], acc[r][k]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = n0 + r;
          if (n >= N) continue;
          if constexpr (DP) {  // clean-self restore, M[n, n] from M^T
            const float self_w = mt_s[n * n4 + n];
            const float4 zn = lds4(&z_s[n * T + c4]);
            acc[r][0] = fmaf(-self_w, zn.x, acc[r][0]);
            acc[r][1] = fmaf(-self_w, zn.y, acc[r][1]);
            acc[r][2] = fmaf(-self_w, zn.z, acc[r][2]);
            acc[r][3] = fmaf(-self_w, zn.w, acc[r][3]);
          }
          store4(out, D, n, d, cols, act_s[n] > 0.0f, acc[r], lds4(&w_s[n * T + c4]));
        }
      }
    }
    __syncthreads();  // the tile is read: the next may land in it
  }
}

template <bool Sparse, bool DP>
int launch_staged(const float* mix, const int* idx, const float* wgt, const float* w,
                  const float* z, const float* active, float* out, int N, int S, long long D,
                  int T, int threads, void* stream) {
  if (T < 32 || (T & (T - 1)) != 0 || threads > kMaxThreads || threads % T != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gossip_mix_staged_kernel<Sparse, DP>;
  const size_t smem = sizeof(float) * StagedLayout(Sparse, DP, N, S, T).words;
  // a failed call also sets the runtime's last error: clear it, so that
  // the next good launch does not report it
  const auto fail = [](cudaError_t e) {
    (void)cudaGetLastError();
    return static_cast<int>(e);
  };
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return fail(err);
  }
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err == cudaSuccess && per_sm == 0) err = cudaErrorInvalidConfiguration;
  if (err != cudaSuccess) return fail(err);
  const long long tiles = (D + T - 1) / T;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const unsigned blocks = static_cast<unsigned>(tiles < resident ? tiles : resident);
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(mix, idx, wgt, w, z, active,
                                                                     out, N, S, D, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launcher returns the cudaError_t of its launch.  The wrapper
// (kernels/gossip_mix.py) checks the operands, and its _plan picks the
// design: the staged launchers take a tile of T columns, a power of two
// from 32 that divides the block's threads, with a layout of at most
// 232,448 bytes (a larger one is refused by cudaFuncSetAttribute); the
// row-wise ones D / 1024 < 65536 tiles and a sparse row of at most 6144
// slots (48 KB of shared memory).

// gossip_mix: staged, T columns a tile
extern "C" int gossip_mix_dense_launch(const float* mix, const float* w, const float* active,
                                       float* out, int N, long long D, int T, int threads,
                                       void* stream) {
  return launch_staged<false, false>(mix, nullptr, nullptr, w, nullptr, active, out, N, 0, D, T,
                                     threads, stream);
}

// gossip_mix: the row-wise kernel
extern "C" int gossip_mix_rowwise_launch(const float* mix, const float* w, const float* active,
                                         float* out, int N, long long D, void* stream) {
  return launch_rowwise<false, false>(mix, nullptr, nullptr, w, nullptr, active, out, N, 0, D,
                                      stream);
}

extern "C" int gossip_mix_sparse_launch(const int* idx, const float* wgt, const float* w,
                                        const float* active, float* out, int N, int S,
                                        long long D, void* stream) {
  return launch_rowwise<true, false>(nullptr, idx, wgt, w, nullptr, active, out, N, S, D, stream);
}

// gossip_mix_dp: staged, T columns a tile
extern "C" int gossip_mix_dp_launch(const float* mix, const float* w, const float* z,
                                    const float* active, float* out, int N, long long D, int T,
                                    int threads, void* stream) {
  return launch_staged<false, true>(mix, nullptr, nullptr, w, z, active, out, N, 0, D, T, threads,
                                    stream);
}

// gossip_mix_dp: the row-wise kernel
extern "C" int gossip_mix_dp_rowwise_launch(const float* mix, const float* w, const float* z,
                                            const float* active, float* out, int N, long long D,
                                            void* stream) {
  return launch_rowwise<false, true>(mix, nullptr, nullptr, w, z, active, out, N, 0, D, stream);
}

// gossip_mix_sparse_dp: staged, T columns a tile
extern "C" int gossip_mix_sparse_dp_launch(const int* idx, const float* wgt, const float* w,
                                           const float* z, const float* active, float* out,
                                           int N, int S, long long D, int T, int threads,
                                           void* stream) {
  return launch_staged<true, true>(nullptr, idx, wgt, w, z, active, out, N, S, D, T, threads,
                                   stream);
}

// gossip_mix_sparse_dp: the row-wise kernel
extern "C" int gossip_mix_sparse_dp_rowwise_launch(const int* idx, const float* wgt,
                                                   const float* w, const float* z,
                                                   const float* active, float* out, int N,
                                                   int S, long long D, void* stream) {
  return launch_rowwise<true, true>(nullptr, idx, wgt, w, z, active, out, N, S, D, stream);
}
