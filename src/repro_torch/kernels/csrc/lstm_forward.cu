// lstm_forward: L LSTM steps from zero state plus the linear head, one
// weight set per group, in one launch.  CUDA C++ for sm_90a (Hopper).
//
// Replaces the Pallas TPU kernel src/repro/kernels/lstm_cell.py:51
// (lstm_cell_pallas, body _kernel at line 27): that kernel computes one
// LSTM step and leaves the time loop to a lax.scan; this one runs the
// whole time loop and the head on chip, so h and c never leave it.
//
//   x (G, R, L, I), wx (G, I, 4H), wh (G, H, 4H), b (G, 4H),
//   w_out (G, H, 1), b_out (G, 1)  ->  y (G, R);   fp32 throughout.
//   Gates are ordered (i, f, g, o); the forget bias lives in b.
//
// Numerics, the same on every path: each gate column j of a row is
//   z_j = (fma chain over i of x_i wx[i, j] from 0)
//       + (fma chain over k = 0..H-1 of h_k wh[k, j] from 0)  + b_j,
// left to right (step 0's h = 0 chain included: a non-finite weight
// must still reach the result), then c = f*c + i*g, h = o*tanh(c) and
// the head's fma chain over k, + b_out.  No fast math, no split-K, no
// reassociation.  So a row's forecast is bitwise the same whatever else
// shares the launch (the serving contract the servable's selfcheck
// enforces), and bitwise the one-block-per-row kernel's, whatever the
// path.
//
// What bounds it on an H100.  At serving shapes (G=64, R=1, H=128,
// L=12) the weights are ~17 MB against ~0.1 GFLOP: the least time is
// the bytes over 3.35 TB/s (~5 us).  At the eval's shapes (G=1,
// R ~ 2,000) the weights are one 0.26 MB set and the work ~3.2 GFLOP of
// fp32 FMAs: the least time is FMA issue (~48 us at 67 TFLOP/s).  A
// one-block-per-row kernel (wh streamed from L2 at every step,
// since one row's wh, 256 KB at H=128, exceeds a block's 227 KB of
// shared memory) was 16x from the first bound and 13x from the second.
//
// Design: weight-stationary thread-block clusters.  A cluster of C
// CTAs runs one group's tile of T rows (T = the least power of two
// holding R, at most 8: the most rows whose chains fit in registers
// beside 128 weights, and the fastest tile on the card).  CTA c owns the hidden units [c*Hc, (c+1)*Hc),
// Hc = ceil(H/C), and their four gate columns, one thread a column, so
// the c/h update of its units is local.  Its slice of wh stays on chip
// for the whole launch, read from HBM once:
//  - at H = 128 (the paper's width, the served and trained one), C = 2
//    and each thread keeps its column's 128 weights in registers,
//    loaded straight from global memory (k fully unrolled);
//  - at any other H, in shared memory (H x 4Hc), with C in {1, 2, 4, 8}
//    the smallest whose slice fits beside the tile's state, loaded in
//    four k-chunks by one TMA box each (cp.async when H or Hc is not a
//    multiple of 4), each completing on its mbarrier, so that step 0's
//    k-chain starts on the first chunk while the others land.
// Above the largest H a cluster of 8 holds (312 at I=1), a
// one-block-per-row kernel streams wh from global memory.  A step: each
// thread runs its column's k-chain for the tile's rows (h read as float4
// broadcasts), adds x and b, applies its gate's activation; after a
// block barrier the owner of each (row, unit) updates c and h and
// stores h into the h buffer of every CTA of the cluster with st.async,
// which counts the bytes on the receiver's mbarrier (h double-buffered
// by step parity, one barrier a parity).  A step starts when its barrier has all T*H values: no
// cluster-wide barrier a step (one at the start, so that no CTA writes
// into a partner that has not started, and one at the end, so that none
// leaves while a partner may still write into it; a cluster of one CTA
// keeps h local behind block barriers).  CTA 0 takes the head.  The
// wrapper's _plan picks C, T and where the weights live; the launcher
// asks cudaOccupancyMaxActiveClusters first and refuses (returns an
// error) a cluster that cannot be resident.
//
// What holds it now (PERF.md): every FMA of the k-chain takes its h
// operand from a shared-memory broadcast, and shared memory delivers 32
// floats a cycle against 128 FMAs a cycle, so the k-chain runs at most
// at a quarter of the fp32 FMA rate, and a step also waits for the gate
// update and the exchange.  Weights in registers beat a shared-memory
// slice, which adds a shared-memory read per FMA.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kChunks = 4;          // k-chunks of a shared-memory wh slice
constexpr int kBarBytes = 128;      // chunk and h mbarriers; then TMA boxes, 128-byte aligned
constexpr int kRegHidden = 128;     // the H whose weights live in registers
constexpr int kUnschedulable = -1;  // no cluster of this shape can be resident

__device__ __forceinline__ float sigmoid_f(float v) { return 1.0f / (1.0f + expf(-v)); }

// rows of a k-chunk: a multiple of 4, so float4 reads of h stay aligned
__host__ __device__ inline int chunk_rows(int H) {
  return ((H + kChunks - 1) / kChunks + 3) / 4 * 4;
}

// Float offsets into a cluster CTA's dynamic shared memory (after the
// barriers).  The wrapper's _smem_bytes computes the same total.
struct Layout {
  int hc, nc, hp;         // units a CTA, its gate columns (4 hc), h row stride
  int w, wx, b, h, c, z;  // wh slice (kChunks * chunk_rows, nc; none when wh is in
                          // registers), wx (I, nc), b (nc), h (2, T, hp), c (T, hc),
                          // activated gates (T, nc)
  size_t bytes;
};

__host__ __device__ inline Layout layout(int H, int I, int C, int T, bool regs) {
  Layout s;
  s.hc = (H + C - 1) / C;
  s.nc = 4 * s.hc;
  s.hp = (H + 3) / 4 * 4;
  int off = 0;
  s.w = off;  off += regs ? 0 : kChunks * chunk_rows(H) * s.nc;
  s.wx = off; off += I * s.nc;
  s.b = off;  off += s.nc;
  s.h = off;  off += 2 * T * s.hp;
  s.c = off;  off += T * s.hc;
  s.z = off;  off += T * s.nc;
  s.bytes = kBarBytes + static_cast<size_t>(off) * sizeof(float);
  return s;
}

// One block per (g, r) row, wh streamed from global memory at every
// step: the path for H above what a cluster can hold.  Threads stride
// over the 4H columns; shared memory holds h, c and z (6H floats).
__global__ void lstm_forward_stream_kernel(const float* __restrict__ x,
                                           const float* __restrict__ wx,
                                           const float* __restrict__ wh,
                                           const float* __restrict__ b,
                                           const float* __restrict__ w_out,
                                           const float* __restrict__ b_out,
                                           float* __restrict__ y,
                                           int R, int L, int I, int H) {
  extern __shared__ float smem[];
  float* h_s = smem;          // (H,)  hidden state
  float* c_s = smem + H;      // (H,)  cell state
  float* z_s = smem + 2 * H;  // (4H,) gate pre-activations

  const int row = blockIdx.x;  // g * R + r
  const int g = row / R;
  const int H4 = 4 * H;
  const float* xr = x + static_cast<size_t>(row) * L * I;
  const float* wxg = wx + static_cast<size_t>(g) * I * H4;
  const float* whg = wh + static_cast<size_t>(g) * H * H4;
  const float* bg = b + static_cast<size_t>(g) * H4;

  for (int u = threadIdx.x; u < H; u += blockDim.x) {
    h_s[u] = 0.0f;
    c_s[u] = 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < L; ++t) {
    const float* xt = xr + static_cast<size_t>(t) * I;
    for (int j = threadIdx.x; j < H4; j += blockDim.x) {
      float ax = 0.0f;
      for (int i = 0; i < I; ++i) ax = fmaf(xt[i], wxg[static_cast<size_t>(i) * H4 + j], ax);
      float ah = 0.0f;
      const float* col = whg + j;
#pragma unroll 16
      for (int k = 0; k < H; ++k) ah = fmaf(h_s[k], col[static_cast<size_t>(k) * H4], ah);
      z_s[j] = ax + ah + bg[j];
    }
    __syncthreads();
    for (int u = threadIdx.x; u < H; u += blockDim.x) {
      const float ig = sigmoid_f(z_s[u]);
      const float fg = sigmoid_f(z_s[H + u]);
      const float gg = tanhf(z_s[2 * H + u]);
      const float og = sigmoid_f(z_s[3 * H + u]);
      const float c = fg * c_s[u] + ig * gg;
      c_s[u] = c;
      h_s[u] = og * tanhf(c);
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    const float* wog = w_out + static_cast<size_t>(g) * H;
    float acc = 0.0f;
    for (int k = 0; k < H; ++k) acc = fmaf(h_s[k], wog[k], acc);
    y[row] = acc + b_out[g];
  }
}

// ah[r] += h[r, k] * w[k] for k = k0 .. k1-1 in order, for the T rows of
// the tile: h rows `hp` apart (float4-aligned, k0 a multiple of 4), the
// column's weights `stride` apart.
template <int T>
__device__ __forceinline__ void k_chain(float (&ah)[T], const float* hcur, int hp,
                                        const float* wcol, int stride, int k0, int k1) {
  int k = k0;
#pragma unroll(T <= 2 ? 8 : 2)
  for (; k + 4 <= k1; k += 4) {
    const float w0 = wcol[k * stride], w1 = wcol[(k + 1) * stride];
    const float w2 = wcol[(k + 2) * stride], w3 = wcol[(k + 3) * stride];
#pragma unroll
    for (int r = 0; r < T; ++r) {
      const float4 hv = *reinterpret_cast<const float4*>(hcur + r * hp + k);
      ah[r] = fmaf(hv.x, w0, ah[r]);
      ah[r] = fmaf(hv.y, w1, ah[r]);
      ah[r] = fmaf(hv.z, w2, ah[r]);
      ah[r] = fmaf(hv.w, w3, ah[r]);
    }
  }
  for (; k < k1; ++k) {
    const float w = wcol[k * stride];
#pragma unroll
    for (int r = 0; r < T; ++r) ah[r] = fmaf(hcur[r * hp + k], w, ah[r]);
  }
}

// One cluster per (g, tile of T rows); see the note at the top.  Thread
// jl < nc owns gate column jl = q*hc + u (gate q, local unit u; global
// column q*H + c*hc + u).  KH > 0: wh in registers, H == KH, fully
// unrolled; KH == 0: wh in shared memory, loaded by TMA (`tma`, one box
// a chunk) or cp.async, each chunk completing on its mbarrier.
template <int T, int KH>
__global__ void __launch_bounds__(KH > 0 ? 256 : 512, 1)
    lstm_forward_cluster_kernel(const __grid_constant__ CUtensorMap wmap,
                                const float* __restrict__ x, const float* __restrict__ wx,
                                const float* __restrict__ wh, const float* __restrict__ b,
                                const float* __restrict__ w_out, const float* __restrict__ b_out,
                                float* __restrict__ y, int R, int L, int I, int H, int tma) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);  // kChunks chunk barriers
  uint64_t* hbar = bars + kChunks;                         // 2: h of each parity arrived
  float* sm = reinterpret_cast<float*>(smem_raw + kBarBytes);

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  if (KH > 0) H = KH;
  const Layout s = layout(H, I, C, T, KH > 0);
  float* w_s = sm + s.w;
  float* wx_s = sm + s.wx;
  float* b_s = sm + s.b;
  float* h_s = sm + s.h;
  float* c_s = sm + s.c;
  float* a_s = sm + s.z;

  const int tiles = (R + T - 1) / T;
  const int cid = blockIdx.x / C;
  const int g = cid / tiles;
  const int r0 = (cid % tiles) * T;
  const int u0 = rank * s.hc;
  const int units = max(0, min(H - u0, s.hc));
  const int H4 = 4 * H;
  const int tid = threadIdx.x;
  const int kc = chunk_rows(H);
  const float* whg = wh + static_cast<size_t>(g) * H * H4 + u0;
  const int jl = tid;
  const int gate = jl / s.hc;
  const bool owns = jl < s.nc && (jl % s.hc) < units;
  const bool solo = C == 1;  // no partner: h stays local, block barriers suffice

  if (tid == 0) {
    if (KH == 0)
      for (int q = 0; q < kChunks; ++q) hopper::mbar_init(&bars[q], tma ? 1 : blockDim.x);
    hopper::mbar_init(&hbar[0], 1);
    hopper::mbar_init(&hbar[1], 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  float wr[KH > 0 ? KH : 1];
  if (KH > 0) {  // straight into registers: coalesced across the warp
    if (owns) {
#pragma unroll
      for (int k = 0; k < KH; ++k)
        wr[k] = whg[static_cast<size_t>(k) * H4 + gate * H + jl % s.hc];
    }
  } else if (tma) {  // one box (units, 4 gates, kc rows) a chunk
    if (tid == 0)
      for (int q = 0; q < kChunks; ++q) {
        hopper::mbar_expect_tx(&bars[q], static_cast<uint32_t>(kc * s.nc * sizeof(float)));
        hopper::tma_load_4d(w_s + q * kc * s.nc, &wmap, &bars[q], u0, 0, q * kc, g);
      }
  } else {
    for (int q = 0; q < kChunks; ++q) {
      const int k0 = min(H, q * kc), k1 = min(H, (q + 1) * kc);
      for (int e = tid; e < (k1 - k0) * s.nc; e += blockDim.x) {
        const int k = k0 + e / s.nc, col = e % s.nc, u = col % s.hc;
        if (u < units)
          hopper::cp_async_4(w_s + k * s.nc + col,
                             whg + static_cast<size_t>(k) * H4 + (col / s.hc) * H + u);
      }
      hopper::cp_async_mbar_arrive(&bars[q]);
    }
  }
  for (int e = tid; e < (I + 1) * s.nc; e += blockDim.x) {  // wx rows, then b
    const int i = e / s.nc, col = e % s.nc, u = col % s.hc;
    const int j = (col / s.hc) * H + u0 + u;
    if (u < units)
      sm[s.wx + e] = i < I ? wx[(static_cast<size_t>(g) * I + i) * H4 + j]
                           : b[static_cast<size_t>(g) * H4 + j];
  }
  for (int e = tid; e < 2 * T * s.hp; e += blockDim.x) h_s[e] = 0.0f;
  for (int e = tid; e < T * s.hc; e += blockDim.x) c_s[e] = 0.0f;
  const uint32_t h_bytes = static_cast<uint32_t>(T * H * sizeof(float));  // h_t, all CTAs
  if (tid == 0 && !solo) hopper::mbar_expect_tx(&hbar[1], h_bytes);
  // every CTA of the cluster running, its barriers initialised, before
  // any write into its shared memory; also publishes the copies above
  if (solo)
    __syncthreads();
  else
    cluster.sync();

  const float* xg = x + static_cast<size_t>(g) * R * L * I;
  for (int t = 0; t < L; ++t) {
    const float* hcur = h_s + (t & 1) * T * s.hp;
    float* hnext = h_s + ((t + 1) & 1) * T * s.hp;
    if (t > 0 && !solo) {  // h_t from every CTA; then arm the barrier for h_(t+1)
      hopper::mbar_wait(&hbar[t & 1], ((t - 1) >> 1) & 1);
      if (tid == 0) hopper::mbar_expect_tx(&hbar[(t + 1) & 1], h_bytes);
    }
    if (owns) {
      float ax[T], ah[T], x0[T];
#pragma unroll
      for (int r = 0; r < T; ++r) {  // x of this step, fetched before the k-chain
        x0[r] = r0 + r < R ? xg[(static_cast<size_t>(r0 + r) * L + t) * I] : 0.0f;
        ah[r] = 0.0f;
      }
      if (KH > 0) {
#pragma unroll
        for (int k = 0; k < KH; k += 4) {
#pragma unroll
          for (int r = 0; r < T; ++r) {
            const float4 hv = *reinterpret_cast<const float4*>(hcur + r * s.hp + k);
            ah[r] = fmaf(hv.x, wr[k], ah[r]);
            ah[r] = fmaf(hv.y, wr[k + 1], ah[r]);
            ah[r] = fmaf(hv.z, wr[k + 2], ah[r]);
            ah[r] = fmaf(hv.w, wr[k + 3], ah[r]);
          }
        }
      } else {
        const float* wcol = w_s + jl;
        if (t == 0) {  // chunk by chunk, as each lands
          for (int q = 0; q < kChunks; ++q) {
            hopper::mbar_wait(&bars[q], 0);
            k_chain<T>(ah, hcur, s.hp, wcol, s.nc, min(H, q * kc), min(H, (q + 1) * kc));
          }
        } else {
          k_chain<T>(ah, hcur, s.hp, wcol, s.nc, 0, H);
        }
      }
      const float bj = b_s[jl];
#pragma unroll
      for (int r = 0; r < T; ++r) {
        ax[r] = 0.0f;
        if (r0 + r < R) {
          const float* xt = xg + (static_cast<size_t>(r0 + r) * L + t) * I;
          ax[r] = fmaf(x0[r], wx_s[jl], ax[r]);
          for (int i = 1; i < I; ++i) ax[r] = fmaf(xt[i], wx_s[i * s.nc + jl], ax[r]);
        }
        // the column's own activation: tanh for the g gate, else sigmoid
        const float z = ax[r] + ah[r] + bj;
        a_s[r * s.nc + jl] = gate == 2 ? tanhf(z) : sigmoid_f(z);
      }
    }
    __syncthreads();
    for (int p = tid; p < T * units; p += blockDim.x) {
      const int r = p / units, u = p % units;
      const float* ar = a_s + r * s.nc;
      const float ig = ar[u], fg = ar[s.hc + u], gg = ar[2 * s.hc + u], og = ar[3 * s.hc + u];
      const float c = fg * c_s[r * s.hc + u] + ig * gg;
      c_s[r * s.hc + u] = c;
      const float h = og * tanhf(c);
      float* dst = hnext + r * s.hp + u0 + u;
      if (solo) {
        *dst = h;
      } else {
        for (int cta = 0; cta < C; ++cta)  // into every CTA's buffer, counted on its barrier
          hopper::st_async_f32(hopper::cluster_map(dst, cta), h,
                               hopper::cluster_map(&hbar[(t + 1) & 1], cta));
      }
    }
    if (solo) __syncthreads();
  }
  if (!solo) hopper::mbar_wait(&hbar[L & 1], ((L - 1) >> 1) & 1);

  if (rank == 0 && tid < T && r0 + tid < R) {
    const float* hl = h_s + (L & 1) * T * s.hp + tid * s.hp;
    const float* wog = w_out + static_cast<size_t>(g) * H;
    float acc = 0.0f;
#pragma unroll 8
    for (int k = 0; k < H; ++k) acc = fmaf(hl[k], wog[k], acc);
    y[static_cast<size_t>(g) * R + r0 + tid] = acc + b_out[g];
  }
  // no CTA leaves while a partner may still write into its shared memory
  if (!solo) cluster.sync();
}

struct Checked {  // the last cluster shape found schedulable, per kernel instance
  int device = -1, cluster = 0, threads = 0;
  size_t bytes = 0;
};

template <int T, int KH>
int launch_cluster(const float* x, const float* wx, const float* wh, const float* b,
                   const float* w_out, const float* b_out, float* y, int G, int R, int L, int I,
                   int H, int C, cudaStream_t stream) {
  static Checked checked;
  const auto kernel = lstm_forward_cluster_kernel<T, KH>;
  const Layout s = layout(H, I, C, T, KH > 0);
  const int threads = (s.nc + 31) / 32 * 32;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(C) * G * ((R + T - 1) / T));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = s.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a failed query also sets the runtime's last error: clear it, so that
  // the next launch's cudaGetLastError does not report it again
  const auto fail = [](cudaError_t e) {
    (void)cudaGetLastError();
    return static_cast<int>(e);
  };
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return fail(err);
  if (checked.device != device || checked.cluster != C || checked.threads != threads ||
      checked.bytes != s.bytes) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(s.bytes));
    if (err != cudaSuccess) return fail(err);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return fail(err);
    if (clusters < 1) return kUnschedulable;
    checked = Checked{device, C, threads, s.bytes};
  }
  // TMA boxes need 16-byte rows (H, Hc multiples of 4) and base
  CUtensorMap map = {};
  int tma = 0;
  if (KH == 0 && H % 4 == 0 && s.hc % 4 == 0 && reinterpret_cast<uintptr_t>(wh) % 16 == 0) {
    const int res = hopper::f32_map_4d(&map, wh, H, 4, H, G, s.hc, 4, chunk_rows(H));
    if (res != 0) return res;
    tma = 1;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, map, x, wx, wh, b, w_out, b_out, y, R, L, I, H, tma);
  if (err != cudaSuccess) return fail(err);
  return static_cast<int>(cudaGetLastError());
}

int launch_tiled(const float* x, const float* wx, const float* wh, const float* b,
                 const float* w_out, const float* b_out, float* y, int G, int R, int L, int I,
                 int H, int C, int T, int regs, cudaStream_t st) {
#define LSTM_TILE(TT)                                                                            \
  if (T == TT)                                                                                   \
    return regs ? launch_cluster<TT, kRegHidden>(x, wx, wh, b, w_out, b_out, y, G, R, L, I, H, C, \
                                                 st)                                             \
                : launch_cluster<TT, 0>(x, wx, wh, b, w_out, b_out, y, G, R, L, I, H, C, st);
  LSTM_TILE(1) LSTM_TILE(2) LSTM_TILE(4) LSTM_TILE(8)
#undef LSTM_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C = 0: the streaming kernel (threads from H alone); else a cluster of
// C CTAs per tile of T rows (T in {1, 2, 4, 8}), wh in registers when
// `regs` (H must be 128) or in shared memory.  Returns the cudaError_t
// of the launch, or -1 when the cluster cannot be scheduled; nothing is
// launched then.
extern "C" int lstm_forward_launch(const float* x, const float* wx, const float* wh,
                                   const float* b, const float* w_out, const float* b_out,
                                   float* y, int G, int R, int L, int I, int H, int C, int T,
                                   int regs, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 0) {
    int threads = ((4 * H + 31) / 32) * 32;
    if (threads > 512) threads = 512;
    const size_t smem = static_cast<size_t>(6) * H * sizeof(float);
    lstm_forward_stream_kernel<<<G * R, threads, smem, st>>>(x, wx, wh, b, w_out, b_out, y, R,
                                                            L, I, H);
    return static_cast<int>(cudaGetLastError());
  }
  if (regs && H != kRegHidden) return static_cast<int>(cudaErrorInvalidValue);
  return launch_tiled(x, wx, wh, b, w_out, b_out, y, G, R, L, I, H, C, T, regs, st);
}
