// lstm_gates_fwd / lstm_gates_bwd: one step of the trainer's LSTM, the
// gate nonlinearities and the cell update, forward and backward, fused
// into one pass each.  CUDA C++ for sm_90a (Hopper).
//
// These replace no TPU kernel: the JAX package trains through its plain
// jnp cell (use_kernel=False in src/repro/models/lstm.py) and leaves the
// gradient to jax.grad, so it has no Pallas kernel on this path.  They
// were added because autograd, replaying the trainer's forward op by op,
// ran ~15 elementwise passes a step over (N, B, H) and summed the
// per-step weight gradients one add at a time.  The trainer's
// backpropagation through time (models/lstm.py:forward_for_grad) keeps
// the GEMMs in cuBLAS (torch.bmm) and does everything between them here,
// in one launch a step each way.
//
//   lstm_gates_fwd, step t:  z = (G_t + x_t wx) + b   (G_t = h_{t-1} wh,
//     or 0 at t = 0; x_t one input a row, I = 1), i, f, o = sigmoid,
//     g = tanh of z's four column blocks, c_t = f c_{t-1} + i g,
//     h_t = o tanh(c_t).  G_t is overwritten with the activated
//     (i, f, g, o); c_t and h_t are written to their buffers.
//   lstm_gates_bwd, step t:  from the saved gates, c_{t-1}, c_t (tanh(c_t)
//     recomputed), dh_t and dc_{t+1}: the four pre-activation gradients
//     dG_t, written over the gates, and dc_{t-1}, written over dc.  It
//     also sums dG_t over the B rows into db (N, 4H) and x_t^T dG_t into
//     dwx (N, 1, 4H), written at t = L-1 and added to at every other
//     step, so no pass re-reads dG for them.
//   I > 1 (no configuration of the port has it): the caller puts x_t wx
//     into every G_t with one product over all steps before the forward
//     and takes dwx with one product over all steps after the backward;
//     it passes x = wx = dwx = NULL, and the kernels skip that term.
//
// Operands are (N, B, cols) views with unit stride along cols and any
// row and batch strides (the trainer's step slices of its (N, L, B, .)
// buffers); wx, b, db and dwx are rows of the (N, D) parameter and
// gradient buffers.  fp32 throughout.
//
// Numerics.  Each elementwise operation is rounded once, in the order
// the autograd graph of models/lstm.py:lstm_cell runs them: __fadd_rn /
// __fmul_rn keep nvcc from contracting a product and a sum into one FMA,
// sigmoid is 1 / (1 + expf(-z)) and tanh is tanhf, IEEE division, no
// fast math.  x_t wx is a single product.  The row sums of db and dwx are taken per warp over rows
// w, w + W, ... and then over the W warps in order: fixed, so a result
// depends on B and the inputs alone, never on N or on another launch.
//
// What bounds it on an H100: bytes.  A step moves, per (n, b) row,
// 4H gate floats in and out and c, h (forward) or c_{t-1}, c_t, dh, dc
// in and dc out (backward): 11H and 13H floats, at ~1 flop a byte, so
// the least time is the bytes over 3.35 TB/s (1.22 and 1.44 GB a step at
// N = 3,390, B = 64, H = 128: ~0.36 and ~0.43 ms).  The design moves
// each byte once: a thread owns V = 4 adjacent hidden units (16-byte
// loads and stores of each gate block, c, h, dh and dc) when H % 4 == 0
// and the operands are 16-byte aligned, else one unit; a warp covers 32
// threads' units of one row n, the W = min(8, B) warps of a block walk
// the B rows, and a thread loads its b and wx columns once for all its
// rows.  The backward's per-row sums stay in registers and meet once a
// launch in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kMaxWarps = 8;

struct View {  // (N, B, cols) with unit stride along cols
  long long sn, sb;
};

template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

__device__ __forceinline__ float sigmoid(float z) { return 1.0f / __fadd_rn(1.0f, expf(-z)); }

// s (1 - s) as the sigmoid's backward rounds it: (grad (1 - s)) s
__device__ __forceinline__ float dsigmoid(float grad, float s) {
  return __fmul_rn(__fmul_rn(grad, __fsub_rn(1.0f, s)), s);
}

// tanh's backward from its output y: grad (1 - y y)
__device__ __forceinline__ float dtanh(float grad, float y) {
  return __fmul_rn(grad, __fsub_rn(1.0f, __fmul_rn(y, y)));
}

template <int V>
__global__ void __launch_bounds__(kLanes * kMaxWarps)
    lstm_gates_fwd_kernel(float* __restrict__ gates, View gv, const float* __restrict__ x,
                          View xv, const float* __restrict__ wx, long long wx_sn,
                          const float* __restrict__ b, long long b_sn,
                          const float* __restrict__ c_prev, float* __restrict__ c, View cv,
                          float* __restrict__ h, View hv, int B, int H) {
  const long long n = blockIdx.x;
  const int u = (blockIdx.y * kLanes + threadIdx.x) * V;
  if (u >= H) return;
  // G_t is read at every step but the first, and at the first too when
  // the caller has put x_t wx there (x == NULL)
  const bool read_gates = c_prev != nullptr || x == nullptr;
  float bias[4][V], w1[4][V];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      bias[q][v] = b[n * b_sn + q * H + u + v];
      w1[q][v] = x ? wx[n * wx_sn + q * H + u + v] : 0.0f;
    }
  for (int r = threadIdx.y; r < B; r += blockDim.y) {
    float* gp = gates + n * gv.sn + r * gv.sb + u;
    float z[4][V];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (read_gates) {
        load<V>(gp + q * H, z[q]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) z[q][v] = 0.0f;
      }
    }
    float cp[V];
    if (c_prev) {
      load<V>(c_prev + n * cv.sn + r * cv.sb + u, cp);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) cp[v] = 0.0f;
    }
    const float xr = x ? x[n * xv.sn + r * xv.sb] : 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int v = 0; v < V; ++v)
        z[q][v] = __fadd_rn(__fadd_rn(z[q][v], __fmul_rn(xr, w1[q][v])), bias[q][v]);
    float cn[V], hn[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      z[0][v] = sigmoid(z[0][v]);
      z[1][v] = sigmoid(z[1][v]);
      z[2][v] = tanhf(z[2][v]);
      z[3][v] = sigmoid(z[3][v]);
      cn[v] = __fadd_rn(__fmul_rn(z[1][v], cp[v]), __fmul_rn(z[0][v], z[2][v]));
      hn[v] = __fmul_rn(z[3][v], tanhf(cn[v]));
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) store<V>(gp + q * H, z[q]);
    store<V>(c + n * cv.sn + r * cv.sb + u, cn);
    store<V>(h + n * hv.sn + r * hv.sb + u, hn);
  }
}

// The block's sum of each thread's 4V partials over its warps, in warp
// order, written to (or added to) out[q H + u + v] by warp 0.
template <int V>
__device__ __forceinline__ void block_sum_store(const float (&acc)[4][V], float* red,
                                                float* out, int u, int H, bool accumulate) {
  const int lane = threadIdx.x, w = threadIdx.y, warps = blockDim.y;
  __syncthreads();  // the previous sum's reads of red are done
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int v = 0; v < V; ++v) red[((q * V + v) * warps + w) * kLanes + lane] = acc[q][v];
  __syncthreads();
  if (w != 0 || u >= H) return;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float* col = red + (q * V + v) * warps * kLanes + lane;
      float s = col[0];
      for (int k = 1; k < warps; ++k) s = __fadd_rn(s, col[k * kLanes]);
      float* o = out + q * H + u + v;
      *o = accumulate ? __fadd_rn(*o, s) : s;
    }
}

template <int V>
__global__ void __launch_bounds__(kLanes * kMaxWarps)
    lstm_gates_bwd_kernel(float* __restrict__ gates, View gv, const float* __restrict__ c_prev,
                          const float* __restrict__ c, View cv, const float* __restrict__ dh,
                          float* __restrict__ dc, View dv, const float* __restrict__ x, View xv,
                          float* __restrict__ db, long long db_sn, float* __restrict__ dwx,
                          long long dwx_sn, int B, int H, int accumulate) {
  __shared__ float red[4 * 4 * kMaxWarps * kLanes];
  const long long n = blockIdx.x;
  const int u = (blockIdx.y * kLanes + threadIdx.x) * V;
  const bool active = u < H;  // every thread reaches the block sums' barriers
  float acc_b[4][V], acc_x[4][V];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int v = 0; v < V; ++v) acc_b[q][v] = acc_x[q][v] = 0.0f;
  for (int r = threadIdx.y; active && r < B; r += blockDim.y) {
    float* gp = gates + n * gv.sn + r * gv.sb + u;
    float gi[V], gf[V], gg[V], go[V], cp[V], ct[V], dhv[V], dcv[V];
    load<V>(gp, gi);
    load<V>(gp + H, gf);
    load<V>(gp + 2 * H, gg);
    load<V>(gp + 3 * H, go);
    if (c_prev) {
      load<V>(c_prev + n * cv.sn + r * cv.sb + u, cp);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) cp[v] = 0.0f;
    }
    load<V>(c + n * cv.sn + r * cv.sb + u, ct);
    load<V>(dh + n * dv.sn + r * dv.sb + u, dhv);
    float* dcp = dc + n * dv.sn + r * dv.sb + u;
    load<V>(dcp, dcv);
    const float xr = x ? x[n * xv.sn + r * xv.sb] : 0.0f;
    float d[4][V], dcn[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float tc = tanhf(ct[v]);
      // h = o tanh(c): the gradients of o and of tanh(c)
      d[3][v] = dsigmoid(__fmul_rn(dhv[v], tc), go[v]);
      const float dct = __fadd_rn(dcv[v], dtanh(__fmul_rn(dhv[v], go[v]), tc));
      // c = f c_prev + i g
      d[0][v] = dsigmoid(__fmul_rn(dct, gg[v]), gi[v]);
      d[1][v] = dsigmoid(__fmul_rn(dct, cp[v]), gf[v]);
      d[2][v] = dtanh(__fmul_rn(dct, gi[v]), gg[v]);
      dcn[v] = __fmul_rn(dct, gf[v]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      store<V>(gp + q * H, d[q]);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        acc_b[q][v] = __fadd_rn(acc_b[q][v], d[q][v]);
        acc_x[q][v] = fmaf(xr, d[q][v], acc_x[q][v]);
      }
    }
    store<V>(dcp, dcn);
  }
  block_sum_store<V>(acc_b, red, db + n * db_sn, u, H, accumulate);
  if (dwx) block_sum_store<V>(acc_x, red, dwx + n * dwx_sn, u, H, accumulate);
}

dim3 grid_of(int N, int H, int V) {
  return dim3(static_cast<unsigned>(N), static_cast<unsigned>((H + kLanes * V - 1) / (kLanes * V)));
}

dim3 block_of(int B) { return dim3(kLanes, B < kMaxWarps ? B : kMaxWarps); }

}  // namespace

// vec = 1: four units a thread with 16-byte accesses (the wrapper checks
// H % 4 == 0 and the alignment of every (N, B, .) operand), else one.
// c_prev = NULL is step 0: the state is zero, and G_t is not read unless
// x = NULL too.  x = wx = NULL: G_t already holds x_t wx (I > 1, the
// caller's product over all steps).  Returns the launch's cudaError_t.
extern "C" int lstm_gates_fwd_launch(float* gates, long long g_sn, long long g_sb,
                                     const float* x, long long x_sn, long long x_sb,
                                     const float* wx, long long wx_sn, const float* b,
                                     long long b_sn, const float* c_prev, float* c,
                                     long long c_sn, long long c_sb, float* h, long long h_sn,
                                     long long h_sb, int N, int B, int H, int vec,
                                     void* stream) {
  if (N <= 0 || B <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const View gv{g_sn, g_sb}, xv{x_sn, x_sb}, cv{c_sn, c_sb}, hv{h_sn, h_sb};
#define LSTM_FWD(VV)                                                                        \
  lstm_gates_fwd_kernel<VV><<<grid_of(N, H, VV), block_of(B), 0, st>>>(                     \
      gates, gv, x, xv, wx, wx_sn, b, b_sn, c_prev, c, cv, h, hv, B, H)
  if (vec) LSTM_FWD(4);
  else LSTM_FWD(1);
#undef LSTM_FWD
  return static_cast<int>(cudaGetLastError());
}

// accumulate = 0 (step L-1) writes db and dwx, 1 adds to them.  x = dwx
// = NULL (I > 1): dwx is the caller's product over all steps.
extern "C" int lstm_gates_bwd_launch(float* gates, long long g_sn, long long g_sb,
                                     const float* c_prev, const float* c, long long c_sn,
                                     long long c_sb, const float* dh, float* dc, long long d_sn,
                                     long long d_sb, const float* x, long long x_sn,
                                     long long x_sb, float* db, long long db_sn, float* dwx,
                                     long long dwx_sn, int N, int B, int H, int accumulate,
                                     int vec, void* stream) {
  if (N <= 0 || B <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const View gv{g_sn, g_sb}, cv{c_sn, c_sb}, dv{d_sn, d_sb}, xv{x_sn, x_sb};
#define LSTM_BWD(VV)                                                                        \
  lstm_gates_bwd_kernel<VV><<<grid_of(N, H, VV), block_of(B), 0, st>>>(                     \
      gates, gv, c_prev, c, cv, dh, dc, dv, x, xv, db, db_sn, dwx, dwx_sn, B, H, accumulate)
  if (vec) LSTM_BWD(4);
  else LSTM_BWD(1);
#undef LSTM_BWD
  return static_cast<int>(cudaGetLastError());
}
