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
