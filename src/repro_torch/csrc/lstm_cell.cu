// The HAR LSTM's cell, one timestep, fp32, for L lanes at once:
//
//     gates = x @ wx + h @ wh + b              split [i | f | g | o] along 4H
//     c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
//     h' = sigmoid(o) * tanh(c')
//
// x (L, B, F), h and c (L, B, H), wx (L, F, 4H), wh (L, H, 4H), b (L, 4H)
// -> h', c' (L, B, H).  Each lane has its own params (the fleet engine trains
// R requesters, or V contributor rows, at once); the loop engine calls it
// with L = 1.  Every input is dense within a lane and is given its own lane
// stride, so the fleet passes views of its flat (L, P) parameter buffer with
// no copy.
//
// Replaces: src/repro/kernels/lstm_cell/kernel.py::lstm_cell_pallas.
//
// What bounds it on an H100: at the HAR shapes (B = 32 in fit, ~45 in
// scoring; F = 6, H = 64) one lane reads ~105 KB (mostly wh, 64 KB) and does
// ~1.2 MFLOP: ~0.03 us of memory time and less of fp32 time.  At the fleet's
// L = 64 lanes of B = 32 the bound is 64 x that, ~6.7 MB and ~78 MFLOP, about
// 2.0 us of memory time; one launch of the loop engine (L = 1) is bound by
// launch latency.  It is called T = 32 times per forward pass.
//
// Design: grid (ceil(B*H / 256), L), one thread per output (l, b, j), j
// fastest.  The thread computes the four gate dot products over F + H
// itself, then the cell update, so the (L, B, 4H) gate tensor never exists
// in memory, as in the TPU kernel.  For a fixed k the warp reads
// wx[l, k, g*H + j] and wh[l, k, g*H + j] at 32 consecutive j (coalesced),
// and x[l, b, k] and h[l, b, k] at one address (a broadcast).  The x-part and
// the h-part are summed apart and then added with the bias, in the order of
// the plain version.  expf and tanhf are the accurate ones (no
// --use_fast_math).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

struct LaneStrides {
  int x, h, c, wx, wh, b;
};

__global__ void lstm_cell_kernel(const float* __restrict__ x,
                                 const float* __restrict__ h,
                                 const float* __restrict__ c,
                                 const float* __restrict__ wx,
                                 const float* __restrict__ wh,
                                 const float* __restrict__ b,
                                 float* __restrict__ h_out,
                                 float* __restrict__ c_out, int batch, int f,
                                 int hidden, LaneStrides ls) {
  const int lane = blockIdx.y;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= batch * hidden) return;
  const int bi = idx / hidden;
  const int j = idx - bi * hidden;
  const int h4 = 4 * hidden;
  x += static_cast<size_t>(lane) * ls.x;
  h += static_cast<size_t>(lane) * ls.h;
  c += static_cast<size_t>(lane) * ls.c;
  wx += static_cast<size_t>(lane) * ls.wx;
  wh += static_cast<size_t>(lane) * ls.wh;
  b += static_cast<size_t>(lane) * ls.b;
  const size_t out = static_cast<size_t>(lane) * batch * hidden + idx;

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
  c_out[out] = cn;
  h_out[out] = go * tanhf(cn);
}

}  // namespace

// x, h, c, wx, wh, b fp32 on the current device, each dense within a lane,
// lane l at pointer + l * <its lane stride> (elements); h_out and c_out are
// contiguous (L, B, H).  Returns cudaGetLastError() after the launch.
extern "C" int lstm_cell_launch(const void* x, const void* h, const void* c,
                                const void* wx, const void* wh, const void* b,
                                void* h_out, void* c_out, int lanes, int batch,
                                int f, int hidden, int x_ls, int h_ls, int c_ls,
                                int wx_ls, int wh_ls, int b_ls, void* stream) {
  const long long total = static_cast<long long>(batch) * hidden;
  if (total <= 0 || lanes <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((total + kThreads - 1) / kThreads), lanes);
  const LaneStrides ls{x_ls, h_ls, c_ls, wx_ls, wh_ls, b_ls};
  lstm_cell_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(h),
      static_cast<const float*>(c), static_cast<const float*>(wx),
      static_cast<const float*>(wh), static_cast<const float*>(b),
      static_cast<float*>(h_out), static_cast<float*>(c_out), batch, f, hidden,
      ls);
  return static_cast<int>(cudaGetLastError());
}
