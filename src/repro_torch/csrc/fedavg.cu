// Eq. 14 of the paper, masked weighted FedAvg, for R sessions at once:
//
//     out[r, l] = sum_n w[r, n] * u[r, n, l] / max(sum_n w[r, n], 1e-9)
//
// Replaces: src/repro/kernels/fedavg/kernel.py::fedavg_pallas (N, L) -> (L,)
// and ::fedavg_batched_pallas (R, N, L) -> (R, L).  One kernel serves both:
// the loop engine calls it with R = 1.
//
// What bounds it on an H100: memory.  Every update element is read once and
// feeds one multiply-add, so the kernel moves 4*R*N*L + 4*R*L bytes for
// 2*R*N*L FLOPs, 0.5 FLOP per byte against the ~20 at which fp32 FMA would
// bind.  At the loop engine's shapes (R = 1, N = 5, L = 18,566 LSTM params)
// that is ~446 KB, ~0.13 us at 3.35 TB/s, so a single launch is bound by
// launch latency, not by the card.
//
// Design: grid (ceil(L / 256), R), one thread per column l.  The thread walks
// n in order with fp32 accumulators, so the 32 threads of a warp read 128
// consecutive bytes of each contributor row (coalesced) and no partial sums
// cross threads: no shared memory, no atomics, a deterministic order.  The
// weights of row r are the same address for every thread (a broadcast load).
// The sum is divided, not multiplied by a reciprocal, to round like the
// plain version; an all-zero weight row gives zeros (0 / 1e-9).
//
// fedavg_q8_kernel is the same eq. 14 read from the int8 wire format:
//
//     out[r, l] = sum_n w[r, n] * (q[r, n, l] * s[r, n, l / 1024])
//                 / max(sum_n w[r, n], 1e-9)
//
// Replaces: src/repro/kernels/fedavg/kernel.py::fedavg_batched_q8_pallas,
// (R, N, Lp) int8 + (R, N, Lp / 1024) fp32 scales -> (R, Lp) fp32.
//
// What bounds it on an H100: memory, at 1 byte per update element.  At the
// fleet's shapes (R = 64, N = 5, Lp = 19,456) it reads 6.23 MB of codes and
// 24 KB of scales and writes 4.98 MB, ~3.35 us at 3.35 TB/s, against the
// ~8.5 us the fp32 kernel needs for the same (R, N, P) state.
//
// Design: the layout of fedavg_kernel, one thread per column walking n in
// order.  The dequantized value q * s is rounded first and then enters the
// fma, as the plain version computes (q * s) before eq. 14, so the fp32
// (R, N, Lp) block never exists in memory.  A warp reads 32 consecutive
// code bytes per row and one scale (a broadcast within a tile).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void fedavg_kernel(const float* __restrict__ u,
                              const float* __restrict__ w,
                              float* __restrict__ out, int n, int l) {
  const int r = blockIdx.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= l) return;
  const float* ur = u + static_cast<size_t>(r) * n * l + col;
  const float* wr = w + static_cast<size_t>(r) * n;
  float num = 0.f;
  float den = 0.f;
  for (int j = 0; j < n; ++j) {
    const float wj = __ldg(wr + j);
    num = fmaf(wj, __ldg(ur + static_cast<size_t>(j) * l), num);
    den += wj;
  }
  out[static_cast<size_t>(r) * l + col] = num / fmaxf(den, 1e-9f);
}

__global__ void fedavg_q8_kernel(const signed char* __restrict__ q,
                                 const float* __restrict__ s,
                                 const float* __restrict__ w,
                                 float* __restrict__ out, int n, int lp) {
  const int r = blockIdx.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= lp) return;
  const int tiles = lp / 1024;
  const int tile = col / 1024;
  const signed char* qr = q + static_cast<size_t>(r) * n * lp + col;
  const float* sr = s + static_cast<size_t>(r) * n * tiles + tile;
  const float* wr = w + static_cast<size_t>(r) * n;
  float num = 0.f;
  float den = 0.f;
  for (int j = 0; j < n; ++j) {
    const float wj = __ldg(wr + j);
    const float u = static_cast<float>(__ldg(qr + static_cast<size_t>(j) * lp))
                    * __ldg(sr + static_cast<size_t>(j) * tiles);
    num = fmaf(wj, u, num);
    den += wj;
  }
  out[static_cast<size_t>(r) * lp + col] = num / fmaxf(den, 1e-9f);
}

}  // namespace

// u: (R, N, L) fp32, w: (R, N) fp32, out: (R, L) fp32, all contiguous on the
// current device.  Returns cudaGetLastError() after the launch.
extern "C" int fedavg_launch(const void* u, const void* w, void* out, int r,
                             int n, int l, void* stream) {
  if (r <= 0 || l <= 0) return 0;
  const dim3 grid((l + kThreads - 1) / kThreads, r);
  fedavg_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(w),
      static_cast<float*>(out), n, l);
  return static_cast<int>(cudaGetLastError());
}

// q: (R, N, Lp) int8 with Lp % 1024 == 0, s: (R, N, Lp / 1024) fp32,
// w: (R, N) fp32, out: (R, Lp) fp32, all contiguous on the current device.
// Returns cudaGetLastError() after the launch.
extern "C" int fedavg_q8_launch(const void* q, const void* s, const void* w,
                                void* out, int r, int n, int lp, void* stream) {
  if (r <= 0 || lp <= 0) return 0;
  const dim3 grid((lp + kThreads - 1) / kThreads, r);
  fedavg_q8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(q), static_cast<const float*>(s),
      static_cast<const float*>(w), static_cast<float*>(out), n, lp);
  return static_cast<int>(cudaGetLastError());
}
