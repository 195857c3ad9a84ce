// Eq. 14 of the paper, masked weighted FedAvg, for R sessions at once, read
// from dense fp32 rows or from the int8 wire format:
//
//     out[r, l] = sum_n w[r, n] * u[r, n, l] / max(sum_n w[r, n], 1e-9)
//     u[r, n, l] = q[r, n, l] * s[r, n, l / 1024]        (int8 wire)
//
// Replaces: src/repro/kernels/fedavg/kernel.py::fedavg_pallas (N, L) -> (L,)
// and ::fedavg_batched_pallas (R, N, L) -> (R, L) (fedavg_launch; the loop
// engine calls it with R = 1), and ::fedavg_batched_q8_pallas, (R, N, Lp)
// int8 + (R, N, Lp / 1024) fp32 scales -> (R, Lp) fp32 (fedavg_q8_launch).
//
// What bounds it on an H100: memory.  Every update element is read once and
// feeds one multiply-add, so the dense form moves 4*R*N*L + 4*R*L bytes for
// 2*R*N*L FLOPs, 0.5 FLOP per byte against the ~20 at which fp32 FMA would
// bind.  At the fleet's shapes (R = 64, N = 5, L = 18,566) that is 28.5 MB,
// ~8.5 us at 3.35 TB/s, read from HBM; the int8 form reads 6.23 MB of codes
// and 24 KB of scales and writes 4.98 MB (Lp = 19,456), ~3.35 us.  At the
// loop engine's (1, 5, 18,566) the dense form moves ~446 KB, ~0.13 us, so a
// single launch there is bound by launch latency and by one thread's chain
// of dependent loads, not by the card.
//
// Design: one body, fedavg_kernel<N, Load>, for both forms; the loader
// (loaders.cuh, shared with robust.cu and quantize.cu) is LoadDensePairs or
// LoadQ8, and its group width C sets the columns of a thread.  N is a
// template parameter (1 ... 16, dispatched by a switch in launch; N = 0
// takes any n, in chunks of 16 contributors, with the same order of
// arithmetic), so the loops over contributors unroll and nothing is
// guarded by a runtime n.  A block of 128 threads covers 128 C consecutive
// columns of one session r, thread t the C at C t: dense C = 2, one float2
// a contributor (two scalars off an 8-byte boundary: rows of an odd
// length); int8 C = 4, one 32-bit word of codes and its tile's scale.  The
// thread first issues every load it will use, none of them guarded by a
// value: the N weights, then the N groups (int8: every word of codes, then
// every scale).  ptxas keeps that order, with every load of the thread
// before its first FFMA (dense N = 1 ... 16, int8 N = 1 ... 5; at N >= 6
// the int8 form holds 32 registers and issues some later); in other orders
// it let the fma chain wait on the first loads before it issued the rest.
// Only then does it run each column's arithmetic: the fma chain num =
// fma(w[j], u[j], num) and the weight sum den += w[j] in n order from 0,
// one IEEE division num / max(den, 1e-9) (no reciprocal, no
// --use_fast_math; an all-zero weight row gives 0 / 1e-9 = 0), and it
// stores its C results with the widest store the output row's address
// allows.  The int8 loader rounds q * s before the fma (__fmul_rn, never
// contracted), as the plain version rounds its dequantized buffer, so the
// int8 kernel is bitwise the dense kernel on the dequantized buffer.  Which
// thread computes a column changes nothing in its arithmetic, so the
// outputs are bitwise those of the one-column-a-thread kernel this design
// replaced.
//
// What lost on an H100 80GB HBM3 at 700 W (device us, warm / cold, at the
// loop engine's (1, 5, 18,566) and the fleet's (64, 5, 18,566)): the first
// dense design, one column a thread and a runtime-n loop (unrolled by 4,
// the 5th update load after the first round trip), 1.53 / 2.35 and 8.3 /
// 11.8; 4 columns a thread (LoadDense: float4, two float2 or four scalars
// as the row allows), 1.73-1.76 / 2.0 and 5.0-5.2 / 9.6-9.7, in blocks of
// 32, 64 or 128 threads alike at the loop's shape; 1 column, 1.22 / 1.7
// and 6.9 / 9.4.  For the int8 form (64, 5, 19,456): its first design, one
// code a thread and a runtime-n loop, 11.0 / 13.8; 8 columns a thread 5.8
// / 7.1 and 16 columns 8.6 / 8.3; blocks of 32 threads 7.4 / 7.7, of 64 or
// 256 threads 0.1-0.2 us slower than 128.
#include <cstdint>
#include <cuda_runtime.h>

#include "loaders.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxN = 16;  // contributors whose loads a thread issues at once

// Contributors j0 ... j0 + K - 1 of the session whose first row is row0
// (all K when kExact, else those below rows), added in n order into num
// (the Load::kCols columns at col) and den.
template <int K, bool kExact, class Load>
__device__ __forceinline__ void add_contributors(const Load& load, const float* __restrict__ w,
                                                 size_t row0, int j0, int rows, int col,
                                                 float (&num)[Load::kCols], float& den) {
  // every load of the thread, before any of them is used; the weights
  // first: issued after the groups, ptxas let the fma chain wait on the
  // first weights before it issued the rest
  float wv[K];
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (kExact || j0 + j < rows) wv[j] = __ldg(w + row0 + j0 + j);
  typename Load::Raw raw[K];
  load.template fetch_rows<K, kExact>(row0 + j0, rows - j0, col, raw);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (kExact || j0 + j < rows) {
      const auto v = Load::expand(raw[j]);
#pragma unroll
      for (int c = 0; c < Load::kCols; ++c) num[c] = fmaf(wv[j], component(v, c), num[c]);
      den += wv[j];
    }
  }
}

// Session blockIdx.y, the C = Load::kCols columns at C * threadIdx.x of
// the block's C * 128; N contributors (N = 0: n of them); rows of l
// columns.
template <int N, class Load>
__global__ void __launch_bounds__(kThreads)
    fedavg_kernel(Load load, const float* __restrict__ w, float* __restrict__ out, int n, int l) {
  constexpr int C = Load::kCols;
  const int col = C * (blockIdx.x * kThreads + threadIdx.x);
  if (col >= l) return;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * (N > 0 ? N : n);
  float num[C] = {};
  float den = 0.f;
  if constexpr (N > 0) {
    add_contributors<N, true>(load, w, row0, 0, N, col, num, den);
  } else {
    for (int j0 = 0; j0 < n; j0 += kMaxN)
      add_contributors<kMaxN, false>(load, w, row0, j0, n, col, num, den);
  }
  const float d = fmaxf(den, 1e-9f);
  float res[C];
#pragma unroll
  for (int c = 0; c < C; ++c) res[c] = num[c] / d;
  store_group(out + static_cast<size_t>(blockIdx.y) * l + col, col, l, res);
}

// Sessions past 65,535 go in further launches (over_grid_y).
template <int N, class Load>
int launch_n(Load load, const void* w, void* out, int r, int n, int l, cudaStream_t stream) {
  return over_grid_y(r, [&](int r0, int rs) {
    const size_t row0 = static_cast<size_t>(r0) * n;
    const dim3 grid((l - 1) / (kThreads * Load::kCols) + 1, rs);
    fedavg_kernel<N><<<grid, kThreads, 0, stream>>>(
        load.from_row(row0), static_cast<const float*>(w) + row0,
        static_cast<float*>(out) + static_cast<size_t>(r0) * l, n, l);
  });
}

static_assert(kMaxN == 16, "launch instantiates N = 1 ... 16");

template <class Load>
int launch(Load load, const void* w, void* out, int r, int n, int l, void* stream) {
  if (r <= 0 || l <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (n) {
#define FEDAVG_N(K) \
  case K:           \
    return launch_n<K>(load, w, out, r, n, l, st);
    FEDAVG_N(1) FEDAVG_N(2) FEDAVG_N(3) FEDAVG_N(4) FEDAVG_N(5) FEDAVG_N(6) FEDAVG_N(7)
    FEDAVG_N(8) FEDAVG_N(9) FEDAVG_N(10) FEDAVG_N(11) FEDAVG_N(12) FEDAVG_N(13)
    FEDAVG_N(14) FEDAVG_N(15) FEDAVG_N(16)
#undef FEDAVG_N
  }
  return launch_n<0>(load, w, out, r, n, l, st);
}

}  // namespace

// u: (R, N, L) fp32, w: (R, N) fp32, out: (R, L) fp32, all contiguous on the
// current device (at any 4-byte boundary).  Returns cudaGetLastError()
// after the launch.
extern "C" int fedavg_launch(const void* u, const void* w, void* out, int r,
                             int n, int l, void* stream) {
  return launch(LoadDensePairs{static_cast<const float*>(u), l}, w, out, r, n, l, stream);
}

// q: (R, N, Lp) int8 with Lp % 1024 == 0 at a 4-byte boundary, s: (R, N,
// Lp / 1024) fp32, w: (R, N) fp32, out: (R, Lp) fp32, all contiguous on the
// current device.  Returns cudaErrorMisalignedAddress for codes off a
// 4-byte boundary, else cudaGetLastError() after the launch.
extern "C" int fedavg_q8_launch(const void* q, const void* s, const void* w,
                                void* out, int r, int n, int lp, void* stream) {
  if (reinterpret_cast<uintptr_t>(q) & 3)
    return static_cast<int>(cudaErrorMisalignedAddress);
  return launch(LoadQ8<true>{static_cast<const signed char*>(q),
                             static_cast<const float*>(s), lp},
                w, out, r, n, lp, stream);
}
