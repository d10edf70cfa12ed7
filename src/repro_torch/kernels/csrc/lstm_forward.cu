// lstm_forward: L LSTM steps from zero state plus the linear head, one
// weight set per group, in one launch.  CUDA C++ for sm_90a (Hopper).
//
// Replaces the Pallas TPU kernel src/repro/kernels/lstm_cell.py
// (lstm_cell_pallas, body _kernel): that kernel computes one LSTM step
// and leaves the time loop to a lax.scan; this one runs the whole time
// loop and the head inside the block, so h and c never leave it.
//
//   x (G, R, L, I), wx (G, I, 4H), wh (G, H, 4H), b (G, 4H),
//   w_out (G, H, 1), b_out (G, 1)  ->  y (G, R);   fp32 throughout.
//   Gates are ordered (i, f, g, o); the forget bias lives in b.
//
// Design.  One block per (g, r) row.  The 4H gate columns are strided
// over the block's threads; each thread sums its column in a fixed order
//   z_j = sum_i x_i wx[i, j]  +  sum_k h_k wh[k, j]  +  b_j
// reading wh column-coalesced (neighbouring threads, neighbouring j)
// while h is broadcast from shared memory.  After a barrier the
// threads update c and h in shared memory; after the last step thread 0
// takes the head's dot product in order k = 0..H-1.  Nothing in a
// row's arithmetic depends on G or R or on the other blocks, so a row's
// forecast is bitwise the same whatever else shares the launch: the
// serving contract that the servable's selfcheck enforces.  Any H, I
// and L >= 1 are taken; strided loops mask the ragged edges.
//
// What bounds it on an H100.  The work is a memory stream: at serving
// shapes (G=64, R=1, H=128, L=12) the weights are ~17 MB against
// ~0.1 GFLOP, so the least time is the bytes over 3.35 TB/s (~5 us).
// The kernel is further from that than the bound says because one row's
// wh (256 KB at H=128) does not fit in the 227 KB of shared memory a
// block can hold: it is re-read from L2 at every one of the L steps,
// and the 12 steps are a dependent chain of ~H-long FMA chains with
// one block per SM.  The redesign (a 2-block cluster holding half of wh
// each, exchanging h through distributed shared memory, or bf16 weights)
// is later work.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid_f(float v) { return 1.0f / (1.0f + expf(-v)); }

__global__ void lstm_forward_kernel(const float* __restrict__ x,
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

}  // namespace

// Threads per block depend on H only (never on G or R), which keeps each
// row's summation order fixed.  Returns the cudaError_t of the launch.
extern "C" int lstm_forward_launch(const float* x, const float* wx, const float* wh,
                                   const float* b, const float* w_out, const float* b_out,
                                   float* y, int G, int R, int L, int I, int H,
                                   void* stream) {
  const int cols = 4 * H;
  int threads = ((cols + 31) / 32) * 32;
  if (threads > 512) threads = 512;
  const size_t smem = static_cast<size_t>(6) * H * sizeof(float);
  lstm_forward_kernel<<<G * R, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, wx, wh, b, w_out, b_out, y, R, L, I, H);
  return static_cast<int>(cudaGetLastError());
}
