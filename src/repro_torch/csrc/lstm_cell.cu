// The HAR LSTM's cell, one timestep, fp32:
//
//     gates = x @ wx + h @ wh + b              split [i | f | g | o] along 4H
//     c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
//     h' = sigmoid(o) * tanh(c')
//
// x (B, F), h and c (B, H), wx (F, 4H), wh (H, 4H), b (4H,) -> h', c' (B, H).
//
// Replaces: src/repro/kernels/lstm_cell/kernel.py::lstm_cell_pallas.
//
// What bounds it on an H100: at the HAR shapes (B = 32 in fit, ~100 in
// scoring; F = 6, H = 64) the cell reads ~105 KB (mostly wh, 64 KB) and does
// ~1.2 MFLOP, ~0.03 us of memory time and less of fp32 time: one launch is
// bound by launch latency.  It is called T = 32 times per forward pass.
//
// Design: one thread per output (b, j), j fastest.  The thread computes the
// four gate dot products over F + H itself, then the cell update, so the
// (B, 4H) gate tensor never exists in memory, as in the TPU kernel.  For a
// fixed k the warp reads wx[k, g*H + j] and wh[k, g*H + j] at 32 consecutive
// j (coalesced), and x[b, k] and h[b, k] at one address (a broadcast).  The
// x-part and the h-part are summed apart and then added with the bias, in
// the order of the plain version.  expf and tanhf are the accurate ones (no
// --use_fast_math).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

__global__ void lstm_cell_kernel(const float* __restrict__ x,
                                 const float* __restrict__ h,
                                 const float* __restrict__ c,
                                 const float* __restrict__ wx,
                                 const float* __restrict__ wh,
                                 const float* __restrict__ b,
                                 float* __restrict__ h_out,
                                 float* __restrict__ c_out, int batch, int f,
                                 int hidden) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= batch * hidden) return;
  const int bi = idx / hidden;
  const int j = idx - bi * hidden;
  const int h4 = 4 * hidden;

  float xi = 0.f, xf = 0.f, xg = 0.f, xo = 0.f;
  const float* xr = x + static_cast<size_t>(bi) * f;
  for (int k = 0; k < f; ++k) {
    const float v = __ldg(xr + k);
    const float* wr = wx + static_cast<size_t>(k) * h4 + j;
    xi = fmaf(v, __ldg(wr), xi);
    xf = fmaf(v, __ldg(wr + hidden), xf);
    xg = fmaf(v, __ldg(wr + 2 * hidden), xg);
    xo = fmaf(v, __ldg(wr + 3 * hidden), xo);
  }
  float hi = 0.f, hf = 0.f, hg = 0.f, ho = 0.f;
  const float* hr = h + static_cast<size_t>(bi) * hidden;
  for (int k = 0; k < hidden; ++k) {
    const float v = __ldg(hr + k);
    const float* wr = wh + static_cast<size_t>(k) * h4 + j;
    hi = fmaf(v, __ldg(wr), hi);
    hf = fmaf(v, __ldg(wr + hidden), hf);
    hg = fmaf(v, __ldg(wr + 2 * hidden), hg);
    ho = fmaf(v, __ldg(wr + 3 * hidden), ho);
  }
  const float gi = sigmoid(xi + hi + __ldg(b + j));
  const float gf = sigmoid(xf + hf + __ldg(b + hidden + j));
  const float gg = tanhf(xg + hg + __ldg(b + 2 * hidden + j));
  const float go = sigmoid(xo + ho + __ldg(b + 3 * hidden + j));
  const float cn = gf * __ldg(c + idx) + gi * gg;
  c_out[idx] = cn;
  h_out[idx] = go * tanhf(cn);
}

}  // namespace

// All tensors fp32, contiguous, on the current device.  Returns
// cudaGetLastError() after the launch.
extern "C" int lstm_cell_launch(const void* x, const void* h, const void* c,
                                const void* wx, const void* wh, const void* b,
                                void* h_out, void* c_out, int batch, int f,
                                int hidden, void* stream) {
  const long long total = static_cast<long long>(batch) * hidden;
  if (total <= 0) return 0;
  const unsigned grid = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  lstm_cell_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(h),
      static_cast<const float*>(c), static_cast<const float*>(wx),
      static_cast<const float*>(wh), static_cast<const float*>(b),
      static_cast<float*>(h_out), static_cast<float*>(c_out), batch, f,
      hidden);
  return static_cast<int>(cudaGetLastError());
}
