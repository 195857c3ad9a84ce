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
// ~8.5 us the fp32 kernel needs for the same (R, N, P) state.  Issued as
// one byte a thread and contributor (the first design, fedavg_kernel's
// layout), it was bound by latency instead: 1.25 M threads, each with
// three loads, index arithmetic and an IEEE division for every five fma,
// whose warps asked for 32 bytes of a contributor row at a time, and whose
// runtime-n loop (unrolled by 4) had two code loads in flight at once.
//
// Design: N is a template parameter (1 ... 16, dispatched by a switch in
// fedavg_q8_launch; N = 0 takes any n, in chunks of 16 contributors), so
// the loops over contributors unroll and nothing is guarded by a runtime
// n.  A thread owns 4 consecutive columns of one session, inside one
// 1024-element tile (Lp % 1024 == 0), so it needs one scale a contributor.
// It first issues every load it will use: each contributor's 4 codes as
// one 32-bit load (a row of codes is Lp bytes, a multiple of 1024, so the
// codes are as aligned as the buffer, which the launcher requires to start
// on a 4-byte boundary), then the N scales and the N weights, none of them
// guarded by a value.
// Only then does it convert the codes (I2F), round q * s (__fmul_rn, never
// contracted into the fma, as the plain version rounds its dequantized
// buffer) and run the first design's per-column arithmetic: the fma chain
// and the weight sum in n order, one IEEE division (an all-zero weight row
// gives 0 / 1e-9 = 0), and one float4 store.  The fp32 (R, N, Lp) block
// never exists in memory.  Which thread computes a column changes nothing
// in its arithmetic, so the outputs are bitwise those of the first design,
// and bitwise fedavg_kernel's on the dequantized buffer.
//
// What lost on an H100 80GB HBM3 at 700 W (device us warm / cold at the
// fleet's shapes): the first design 11.0 / 13.8; 8 columns a thread 5.8 /
// 7.1 and 16 columns 8.6 / 8.3; 64 or 256 threads a block in place of 128,
// 0.1-0.2 us slower.  This form: 4.3-4.4 / 5.2.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;
constexpr int kMaxN = 16;        // contributors whose loads a thread issues at once
constexpr int kQ8Threads = 128;
constexpr int kQ8Cols = 4;       // consecutive columns of a q8 thread: one 32-bit word of codes

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

// The 4 codes at p (4-byte aligned) as one little-endian 32-bit word.
__device__ __forceinline__ unsigned load_codes(const signed char* p) {
  return __ldg(reinterpret_cast<const unsigned*>(p));
}

// code c of the word (sign-extended byte c), as a float
__device__ __forceinline__ float code(unsigned word, int c) {
  return static_cast<float>(static_cast<signed char>(word >> (8 * c)));
}

// Contributors j0 ... j0 + K - 1 of the session whose first row of codes
// is row0 (all K when kExact, else those below rows), added in n order
// into num (the 4 columns at col) and den.
template <int K, bool kExact>
__device__ __forceinline__ void add_contributors(const signed char* __restrict__ q,
                                                 const float* __restrict__ s,
                                                 const float* __restrict__ w, size_t row0,
                                                 int j0, int rows, int col, int lp,
                                                 float (&num)[kQ8Cols], float& den) {
  const int tiles = lp / kTile;
  const int tile = col / kTile;
  // every load of the thread, before any of them is used
  unsigned codes[K];
  float sc[K], wv[K];
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (kExact || j0 + j < rows) codes[j] = load_codes(q + (row0 + j0 + j) * lp + col);
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (kExact || j0 + j < rows) sc[j] = __ldg(s + (row0 + j0 + j) * tiles + tile);
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (kExact || j0 + j < rows) wv[j] = __ldg(w + row0 + j0 + j);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (kExact || j0 + j < rows) {
#pragma unroll
      for (int c = 0; c < kQ8Cols; ++c)
        num[c] = fmaf(wv[j], __fmul_rn(code(codes[j], c), sc[j]), num[c]);
      den += wv[j];
    }
  }
}

template <int N>
__device__ __forceinline__ void add_session(const signed char* __restrict__ q,
                                            const float* __restrict__ s,
                                            const float* __restrict__ w, int n, int col,
                                            int lp, float (&num)[kQ8Cols], float& den) {
  const size_t row0 = static_cast<size_t>(blockIdx.y) * (N > 0 ? N : n);
  if constexpr (N > 0) {
    add_contributors<N, true>(q, s, w, row0, 0, N, col, lp, num, den);
  } else {
    for (int j0 = 0; j0 < n; j0 += kMaxN)
      add_contributors<kMaxN, false>(q, s, w, row0, j0, n, col, lp, num, den);
  }
}

// Session blockIdx.y, the 4 columns at 4 * (the thread's index in the
// row); N contributors (N = 0: n of them).
template <int N>
__global__ void __launch_bounds__(kQ8Threads)
    fedavg_q8_kernel(const signed char* __restrict__ q, const float* __restrict__ s,
                     const float* __restrict__ w, float* __restrict__ out, int n, int lp) {
  const int col = (blockIdx.x * kQ8Threads + threadIdx.x) * kQ8Cols;
  if (col >= lp) return;
  float num[kQ8Cols] = {0.f, 0.f, 0.f, 0.f};
  float den = 0.f;
  add_session<N>(q, s, w, n, col, lp, num, den);
  const float d = fmaxf(den, 1e-9f);
  *reinterpret_cast<float4*>(out + static_cast<size_t>(blockIdx.y) * lp + col) =
      make_float4(num[0] / d, num[1] / d, num[2] / d, num[3] / d);
}

template <int N>
int launch_q8(const void* q, const void* s, const void* w, void* out, int r, int n, int lp,
              cudaStream_t stream) {
  const dim3 grid((lp / kQ8Cols + kQ8Threads - 1) / kQ8Threads, r);
  fedavg_q8_kernel<N><<<grid, kQ8Threads, 0, stream>>>(
      static_cast<const signed char*>(q), static_cast<const float*>(s),
      static_cast<const float*>(w), static_cast<float*>(out), n, lp);
  return static_cast<int>(cudaGetLastError());
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

// q: (R, N, Lp) int8 with Lp % 1024 == 0 at a 4-byte boundary, s: (R, N,
// Lp / 1024) fp32, w: (R, N) fp32, out: (R, Lp) fp32 at a 16-byte boundary
// (the wrapper allocates it), all contiguous on the current device.
// Returns cudaErrorMisalignedAddress for codes off a 4-byte boundary, else
// cudaGetLastError() after the launch.
extern "C" int fedavg_q8_launch(const void* q, const void* s, const void* w,
                                void* out, int r, int n, int lp, void* stream) {
  if (r <= 0 || lp <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(q) & 3)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto st = static_cast<cudaStream_t>(stream);
  static_assert(kMaxN == 16, "fedavg_q8_launch instantiates N = 1 ... 16");
  switch (n) {
#define FEDAVG_Q8_N(K) \
  case K:              \
    return launch_q8<K>(q, s, w, out, r, n, lp, st);
    FEDAVG_Q8_N(1) FEDAVG_Q8_N(2) FEDAVG_Q8_N(3) FEDAVG_Q8_N(4) FEDAVG_Q8_N(5)
    FEDAVG_Q8_N(6) FEDAVG_Q8_N(7) FEDAVG_Q8_N(8) FEDAVG_Q8_N(9) FEDAVG_Q8_N(10)
    FEDAVG_Q8_N(11) FEDAVG_Q8_N(12) FEDAVG_Q8_N(13) FEDAVG_Q8_N(14) FEDAVG_Q8_N(15)
    FEDAVG_Q8_N(16)
#undef FEDAVG_Q8_N
  }
  return launch_q8<0>(q, s, w, out, r, n, lp, st);
}
