// Byzantine-robust statistics over the flat round state, R sessions of N
// contributors with L coordinates each, dense fp32 or the int8 wire format:
//
//   trimmed mean, per (r, l): among the active (w > 0) contributors drop
//     the first-index maximum, then the first-index minimum of the rest,
//     and return sum w u / max(sum w, 1e-9) over the others; with <= 2
//     active the plain weighted mean; with 0 active 0.
//   median, per (r, l): the mean of ranks (m - 1) / 2 and m / 2 of the m
//     active values sorted ascending (inactive = +inf); 0 active gives 0.
//   squared norm, per (r, n): sum_l u^2.
//
// Replaces: src/repro/kernels/robust/kernel.py::trimmed_mean_batched_pallas,
// ::trimmed_mean_batched_q8_pallas, ::median_batched_pallas,
// ::median_batched_q8_pallas, ::sqnorm_batched_pallas and
// ::sqnorm_batched_q8_pallas.
//
// Three kernel bodies, each instantiated for two loaders (loaders.cuh,
// shared with fedavg.cu).  LoadDense reads u[row, l]; LoadQ8 reads
// q[row, l] * s[row, l / 1024], the product rounded (__fmul_rn, never
// contracted into a later fma) as the plain version rounds its
// dequantized buffer.  The rest of each body is shared, so the
// q8 kernel on (q, s) is bitwise the dense kernel on the dequantized
// buffer, which keeps the loop engine (dense, dequantized) and the fleet
// (fused q8) in agreement.
//
// What bounds them on an H100.  Their bytes: at the fleet's shapes (R =
// 64, N = 5, L = 18,566) the dense column kernels move 28.5 MB (8.5 us at
// 3.35 TB/s) and the q8 ones 11.2 MB (3.35 us), from HBM, since the
// fleet's round state has left the 50 MB L2 by the time it is aggregated;
// the squared norm reads 23.8 MB dense (7.1 us) or 6.25 MB of codes (1.9
// us) for one fma per element.  And the column kernels' instructions: each
// column takes a trimmed mean's two index-tracking scans, its selects and
// an IEEE division, or a median's N-phase network, over 1.2 M columns.
// Once every load of a thread is in flight, the dense median is bound by
// bytes and the trimmed mean and both q8 forms by instructions.
//
// Design of the column kernels.  N is a template parameter (1 ... 16,
// dispatched by a switch in launch_columns), so every array is indexed by
// unrolled counters and nothing is guarded by a runtime n.  A block of 128
// threads covers 512 consecutive columns of one session r, thread t the 4
// at 4t, so a warp's request to a contributor row is 512 bytes dense or
// 128 bytes of codes, neighbours on neighbours.  The thread first issues
// every load it will use: its N contributor groups (one float4, two float2
// or four scalars as the row's address allows: a row of L = 18,566 floats
// starts only 8-byte aligned; or one char4 of codes with its tile's
// scale) and then the N weights, none of them guarded by a value, so all
// of them are in flight before the first compare.  Only then does it
// dequantize, mask the inactive rows and compute each column with the
// plain version's arithmetic: the trimmed mean's strict > and < scans in n
// order (the first index wins a tie, like argmax), its fma chain in n
// order and an IEEE division; the median's odd-even transposition network
// of the reference (N phases over neighbours) and its two middle ranks.
// When all N contributors of the session are active (one branch for the
// whole block), a specialised form of the same arithmetic skips the
// masks, the activity tests of the scans and the run-time rank selection:
// 66 instructions a column of the trimmed mean at N = 5, not 116.  It
// stores its 4 results with the widest store the output row's address
// allows.  Which thread computes a column changes nothing in its
// arithmetic, so the outputs are bitwise those of the one-column-a-thread
// kernels this design replaced, NaN, infinities and signed zeros included.
//
// What lost on an H100 80GB HBM3 at 700 W (device us, warm / cold, at the
// fleet's shapes): four 4-column groups a thread in the q8 forms (128
// registers, 1.5 waves: trimmed mean 12.9 / 15.3, median 11.2 / 18.2);
// int8 -> float by PRMT and FADD in place of I2F (q8 trimmed mean 11.2 /
// 11.5 and median 6.9 / 7.7 against 11.0 / 10.9 and 6.5 / 6.7: the I2F
// pipe runs beside the ALU that the column arithmetic fills); blocks of
// 256 threads (0.2-0.6 us slower on every form); and a persistent grid of
// 4 blocks an SM staging each tile's N rows in shared memory, double
// buffered, by cp.async of 16, 8 or 4 bytes (dense rows) or one
// cp.async.bulk a row on an mbarrier (codes): 11.5 / 14.4 (trimmed mean),
// 8.5 / 11.7 (median), 12.2 / 13.5 and 8.1 / 9.5 (q8), against 10.3 /
// 12.8, 6.9 / 10.5, 11.2 / 11.5 and 6.9 / 7.7 for the same arithmetic fed
// straight into registers, before the all-active form: with every load of
// a thread in flight, the shared-memory pass and its barriers only add
// work.
//
// Any N.  Past N = 16 (and for any N when the caller forces it, as the
// tests do to hold the two forms against each other) each statistic runs a
// body whose N is a run-time argument, with the same arithmetic.  The
// trimmed mean keeps the templated body's 4 columns a thread and its scans
// (the strict > scan, then the strict < scan, in n order, the first index
// winning a tie; the fma chain in n order, inactive rows adding fmaf(0, 0):
// the sign of a zero sum is the templated body's) but re-reads each row from
// global memory or L2 in each of its three passes instead of holding N
// groups in registers.  The median stages one column a thread, value n of
// thread t at n * blockDim.x + t of shared memory (no bank conflicts), with
// as many columns a block as the N values fit (128 at N <= 453, one warp at
// N = 1,816); past that the caller gives a scratch buffer of R x N x L
// floats in global memory, value n of column c at n * L + c.  There it runs
// the same odd-even network and picks the same two ranks.  Both read
// through the same loaders (LoadQ8's at() rounds as expand() does), so the
// q8 forms stay bitwise the dense forms on the dequantized buffer.
// Sessions past 65,535 go in further launches (loaders.cuh's over_grid_y).
//
// Squared norm: one block of 512 threads per (r, n) row, which it walks
// in chunks of 8,192 elements.  In a chunk, thread t loads the four
// 4-element groups t, t + 512, t + 1024 and t + 1536 (64 bytes of a
// thread's loads in flight at once, ~10 MB over the fleet's 320 rows), as
// one float4, two float2 or four scalars as the row's address allows, or
// as one char4 of codes and the group's scale, read once per 1024-element
// tile; it squares them into four accumulators, one per position in the
// group.  Then a fixed shuffle tree and a fixed sum over the 16 warps: no
// atomics, the same result in every run.  Two other shapes lost on an
// H100: a cluster of 4 blocks per row, adding its partials through
// distributed shared memory, took twice as long with the buffer in L2,
// and 384 threads of 8 groups (128 bytes in flight each) gained 0.2 us on
// the dense form and lost 0.8 us on the int8 one, cold.  Which thread,
// accumulator and order an element goes to depends on its index alone,
// never on L or on the load path, and the two loaders share the body, so
// the q8 sum over the padded Lp adds exact +0.0 to the dense sum over P and
// equals it bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

#include "loaders.cuh"

namespace {

constexpr int kMaxN = 16;                               // the largest templated N
constexpr int kMaxShared = 232448;                      // dynamic shared memory of a block
constexpr int kMedianSharedN = kMaxShared / (4 * 32);   // N a one-warp median tile holds: 1,816
constexpr int kColThreads = 128;
constexpr int kColSpan = kColThreads * kVec;            // columns of a column block: 512
constexpr int kSqThreads = 512;
constexpr int kSqWarps = kSqThreads / 32;
constexpr int kSqGroups = 4;                            // groups a thread loads at once
constexpr int kSqChunk = kSqThreads * kVec * kSqGroups; // 8,192 elements

// One column's trimmed mean over v[0 .. N-1]; wb is w where active, else 0.
struct TrimmedMean {
  template <int N>
  __device__ __forceinline__ static float column(const float (&v)[N], const float (&wb)[N],
                                                 const bool (&act)[N], int m) {
    int amax = N;
    float vmax = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (act[j] && (amax == N || v[j] > vmax)) {
        amax = j;
        vmax = v[j];
      }
    }
    int amin = N;
    float vmin = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (act[j] && j != amax && (amin == N || v[j] < vmin)) {
        amin = j;
        vmin = v[j];
      }
    }
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float wu = (m > 2 && (j == amax || j == amin)) ? 0.f : wb[j];
      num = fmaf(wu, act[j] ? v[j] : 0.f, num);
      den += wu;
    }
    return num / fmaxf(den, 1e-9f);
  }
  // column() with every contributor active (m == N, wb == w), in fewer
  // instructions: the max scan starts at v[0], the min scan at the first
  // index other than amax, where column()'s amax == N and amin == N tests
  // put them
  template <int N>
  __device__ __forceinline__ static float full(const float (&v)[N], const float (&w)[N]) {
    int amax = 0;
    float vmax = v[0];
#pragma unroll
    for (int j = 1; j < N; ++j) {
      if (v[j] > vmax) {
        amax = j;
        vmax = v[j];
      }
    }
    int amin = amax == 0 ? 1 : 0;
    if constexpr (N > 1) {
      float vmin = amax == 0 ? v[1] : v[0];
#pragma unroll
      for (int j = 1; j < N; ++j) {
        if (j != amax && v[j] < vmin) {
          amin = j;
          vmin = v[j];
        }
      }
    }
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float wu = (N > 2 && (j == amax || j == amin)) ? 0.f : w[j];
      num = fmaf(wu, v[j], num);
      den += wu;
    }
    return num / fmaxf(den, 1e-9f);
  }
};

// The reference's odd-even transposition network: N phases of min/max on
// neighbours (j, j + 1), j even in even phases, odd in odd ones.
template <int N>
__device__ __forceinline__ void sort_network(float (&x)[N]) {
#pragma unroll
  for (int phase = 0; phase < N; ++phase) {
#pragma unroll
    for (int j = phase % 2; j + 1 < N; j += 2) {
      const float a = x[j], b = x[j + 1];
      x[j] = fminf(a, b);
      x[j + 1] = fmaxf(a, b);
    }
  }
}

// One column's median: sort_network over v with the inactive entries at
// +inf, then ranks (m - 1) / 2 and m / 2.
struct Median {
  template <int N>
  __device__ __forceinline__ static float column(const float (&v)[N], const float (&)[N],
                                                 const bool (&act)[N], int m) {
    float x[N];
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = act[j] ? v[j] : INFINITY;
    sort_network<N>(x);
    const int lo = m > 0 ? (m - 1) / 2 : 0;
    const int hi = m / 2;
    float vlo = 0.f, vhi = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j == lo) vlo = x[j];
      if (j == hi) vhi = x[j];
    }
    return m > 0 ? 0.5f * (vlo + vhi) : 0.f;
  }
  // column() with every contributor active: no +inf entries, and the two
  // middle ranks known at compile time
  template <int N>
  __device__ __forceinline__ static float full(const float (&v)[N], const float (&)[N]) {
    float x[N];
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = v[j];
    sort_network<N>(x);
    return 0.5f * (x[(N - 1) / 2] + x[N / 2]);
  }
};

// The body both column kernels share: session blockIdx.y, the 4 columns
// at 4 * threadIdx.x of the block's 512.
template <class Stat, int N, class Load>
__device__ __forceinline__ void columns(const Load& load, const float* __restrict__ w,
                                        float* __restrict__ out, int l) {
  const int col = blockIdx.x * kColSpan + kVec * threadIdx.x;
  if (col >= l) return;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * N;
  // every load of the thread, before any of them is used
  typename Load::Raw raw[N];
#pragma unroll
  for (int j = 0; j < N; ++j) raw[j] = load.fetch(row0 + j, col);
  float wv[N];
#pragma unroll
  for (int j = 0; j < N; ++j) wv[j] = __ldg(w + row0 + j);
  float wb[N];
  bool act[N];
  int m = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    act[j] = wv[j] > 0.f;
    wb[j] = act[j] ? wv[j] : 0.f;
    m += act[j];
  }
  float4 v4[N];
#pragma unroll
  for (int j = 0; j < N; ++j) v4[j] = Load::expand(raw[j]);
  float res[kVec];
  // m is the session's, so the branch is the same for the whole block
  if (m == N) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      float v[N];
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = component(v4[j], k);
      res[k] = Stat::template full<N>(v, wv);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      float v[N];
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = component(v4[j], k);
      res[k] = Stat::template column<N>(v, wb, act, m);
    }
  }
  store_group(out + static_cast<size_t>(blockIdx.y) * l + col, col, l, res);
}

template <int N, class Load>
__global__ void __launch_bounds__(kColThreads)
    trimmed_mean_kernel(Load load, const float* __restrict__ w, float* __restrict__ out, int l) {
  columns<TrimmedMean, N>(load, w, out, l);
}

template <int N, class Load>
__global__ void __launch_bounds__(kColThreads)
    median_kernel(Load load, const float* __restrict__ w, float* __restrict__ out, int l) {
  columns<Median, N>(load, w, out, l);
}

// The trimmed mean for a run-time n: session blockIdx.y, the 4 columns at
// 4 * threadIdx.x of the block's 512, as TrimmedMean::column() computes
// each, in three passes over the session's rows.
template <class Load>
__global__ void __launch_bounds__(kColThreads)
    trimmed_mean_any_kernel(Load load, const float* __restrict__ w, float* __restrict__ out,
                            int n, int l) {
  const int col = blockIdx.x * kColSpan + kVec * threadIdx.x;
  if (col >= l) return;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * n;
  const float* ws = w + row0;
  // the first-index maximum of the active values, and their count m
  int amax[kVec], m = 0;
  float vmax[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    amax[k] = n;
    vmax[k] = 0.f;
  }
  for (int j = 0; j < n; ++j) {
    if (!(__ldg(ws + j) > 0.f)) continue;
    ++m;
    const float4 v = Load::expand(load.fetch(row0 + j, col));
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float x = component(v, k);
      if (amax[k] == n || x > vmax[k]) {
        amax[k] = j;
        vmax[k] = x;
      }
    }
  }
  // the first-index minimum of the rest
  int amin[kVec];
  float vmin[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    amin[k] = n;
    vmin[k] = 0.f;
  }
  for (int j = 0; j < n; ++j) {
    if (!(__ldg(ws + j) > 0.f)) continue;
    const float4 v = Load::expand(load.fetch(row0 + j, col));
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float x = component(v, k);
      if (j != amax[k] && (amin[k] == n || x < vmin[k])) {
        amin[k] = j;
        vmin[k] = x;
      }
    }
  }
  // the weighted sum of the others, in n order
  float num[kVec] = {0.f, 0.f, 0.f, 0.f}, den[kVec] = {0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < n; ++j) {
    const float wv = __ldg(ws + j);
    const bool act = wv > 0.f;
    const float wb = act ? wv : 0.f;
    const float4 v =
        act ? Load::expand(load.fetch(row0 + j, col)) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float wu = (m > 2 && (j == amax[k] || j == amin[k])) ? 0.f : wb;
      num[k] = fmaf(wu, component(v, k), num[k]);
      den[k] += wu;
    }
  }
  float res[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) res[k] = num[k] / fmaxf(den[k], 1e-9f);
  store_group(out + static_cast<size_t>(blockIdx.y) * l + col, col, l, res);
}

// The median for a run-time n: session blockIdx.y, column blockIdx.x *
// blockDim.x + threadIdx.x.  Its n values (inactive at +inf) lie in shared
// memory at j * blockDim.x + threadIdx.x, or with a scratch buffer at
// its session's j * l + col; sort_network's phases on them, then
// Median::column()'s two ranks.
template <class Load>
__global__ void median_any_kernel(Load load, const float* __restrict__ w,
                                  float* __restrict__ out, int n, int l, float* scratch) {
  extern __shared__ float vals[];
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= l) return;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * n;
  const size_t stride = scratch ? static_cast<size_t>(l) : blockDim.x;
  float* x = scratch ? scratch + row0 * l + col : vals + threadIdx.x;
  int m = 0;
  for (int j = 0; j < n; ++j) {
    const bool act = __ldg(w + row0 + j) > 0.f;
    m += act;
    x[j * stride] = act ? load.at(row0 + j, col) : INFINITY;
  }
  for (int phase = 0; phase < n; ++phase) {
    for (int j = phase % 2; j + 1 < n; j += 2) {
      const float a = x[j * stride], b = x[(j + 1) * stride];
      x[j * stride] = fminf(a, b);
      x[(j + 1) * stride] = fmaxf(a, b);
    }
  }
  const int lo = m > 0 ? (m - 1) / 2 : 0;
  const int hi = m / 2;
  out[static_cast<size_t>(blockIdx.y) * l + col] =
      m > 0 ? 0.5f * (x[lo * stride] + x[hi * stride]) : 0.f;
}

__device__ __forceinline__ void add_squares(const float4 v, float (&acc)[kVec]) {
  acc[0] = fmaf(v.x, v.x, acc[0]);
  acc[1] = fmaf(v.y, v.y, acc[1]);
  acc[2] = fmaf(v.z, v.z, acc[2]);
  acc[3] = fmaf(v.w, v.w, acc[3]);
}

template <class Load>
__global__ void __launch_bounds__(kSqThreads)
    sqnorm_kernel(Load load, float* __restrict__ out, int l) {
  const size_t row = blockIdx.x;
  float acc[kVec] = {0.f, 0.f, 0.f, 0.f};
  for (long long chunk = 0; chunk < l; chunk += kSqChunk) {
    float4 v[kSqGroups];
#pragma unroll
    for (int j = 0; j < kSqGroups; ++j) {
      const long long col = chunk + kVec * (threadIdx.x + j * kSqThreads);
      v[j] = col < l ? load.group(row, static_cast<int>(col)) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kSqGroups; ++j) add_squares(v[j], acc);
  }
  float sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_down_sync(0xffffffffu, sum, off);
  __shared__ float warp_sum[kSqWarps];
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = warp_sum[0];
#pragma unroll
    for (int k = 1; k < kSqWarps; ++k) t += warp_sum[k];
    out[row] = t;
  }
}

template <int N, class Load>
int launch_n(bool median, Load load, const float* w, float* out, int r, int l,
             cudaStream_t stream) {
  return over_grid_y(r, [&](int r0, int rs) {
    const dim3 grid((l - 1) / kColSpan + 1, rs);
    const Load ld = load.from_row(static_cast<size_t>(r0) * N);
    const float* wr = w + static_cast<size_t>(r0) * N;
    float* o = out + static_cast<size_t>(r0) * l;
    if (median)
      median_kernel<N><<<grid, kColThreads, 0, stream>>>(ld, wr, o, l);
    else
      trimmed_mean_kernel<N><<<grid, kColThreads, 0, stream>>>(ld, wr, o, l);
  });
}

// Columns of a run-time-n median block: 128, or as many warps as the n
// values of a column fit in shared memory; 0 where one warp's do not.
int median_threads(int n) {
  if (n > kMedianSharedN) return 0;
  const int warps = kMaxShared / (4 * 32 * n);
  return warps >= kColThreads / 32 ? kColThreads : 32 * warps;
}

template <class Load>
int launch_any(bool median, Load load, const float* w, float* out, int r, int n, int l,
               float* scratch, cudaStream_t stream) {
  const int threads = median ? (scratch ? kColThreads : median_threads(n)) : kColThreads;
  if (threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = median && !scratch ? 4 * n * threads : 0;
  if (median) {
    const int err = static_cast<int>(cudaFuncSetAttribute(
        median_any_kernel<Load>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (err != 0) return err;
  }
  return over_grid_y(r, [&](int r0, int rs) {
    const Load ld = load.from_row(static_cast<size_t>(r0) * n);
    const float* wr = w + static_cast<size_t>(r0) * n;
    float* o = out + static_cast<size_t>(r0) * l;
    if (median)
      median_any_kernel<<<dim3((l - 1) / threads + 1, rs), threads, smem, stream>>>(
          ld, wr, o, n, l, scratch ? scratch + static_cast<size_t>(r0) * n * l : nullptr);
    else
      trimmed_mean_any_kernel<<<dim3((l - 1) / kColSpan + 1, rs), kColThreads, 0, stream>>>(
          ld, wr, o, n, l);
  });
}

static_assert(kMaxN == 16, "launch_columns instantiates N = 1 ... 16");

// The templated body for N <= 16 unless any_n, else the run-time-n body.
template <class Load>
int launch_columns(bool median, Load load, const void* w, void* out, void* scratch, int r,
                   int n, int l, int any_n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (r <= 0 || l <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* wf = static_cast<const float*>(w);
  auto* of = static_cast<float*>(out);
  if (any_n || n > kMaxN)
    return launch_any(median, load, wf, of, r, n, l, static_cast<float*>(scratch), st);
  switch (n) {
#define ROBUST_N(K) \
  case K:           \
    return launch_n<K>(median, load, wf, of, r, l, st);
    ROBUST_N(1) ROBUST_N(2) ROBUST_N(3) ROBUST_N(4) ROBUST_N(5) ROBUST_N(6) ROBUST_N(7)
    ROBUST_N(8) ROBUST_N(9) ROBUST_N(10) ROBUST_N(11) ROBUST_N(12) ROBUST_N(13)
    ROBUST_N(14) ROBUST_N(15) ROBUST_N(16)
#undef ROBUST_N
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class Load>
int launch_rows(Load load, void* out, int rows, int l, void* stream) {
  if (rows <= 0) return 0;
  if (l < 0) return static_cast<int>(cudaErrorInvalidValue);
  sqnorm_kernel<<<rows, kSqThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      load, static_cast<float*>(out), l);
  return static_cast<int>(cudaGetLastError());
}

LoadDense dense(const void* u, int l) {
  return LoadDense{static_cast<const float*>(u), l};
}

// codes at any byte: robust_*_q8_launch takes views that start anywhere
LoadQ8<false> q8(const void* q, const void* s, int lp) {
  return LoadQ8<false>{static_cast<const signed char*>(q), static_cast<const float*>(s), lp};
}

}  // namespace

// u: (R, N, L) fp32, w: (R, N) fp32, out: (R, L) fp32, contiguous on the
// current device, N >= 1.  any_n runs the run-time-N body at N <= 16 too.
// scratch: null, or (the median past a one-warp shared tile, N > 1,816) R x
// N x L fp32.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for N < 1, or a median past the tile without
// scratch).
extern "C" int robust_trimmed_mean_launch(const void* u, const void* w, void* out,
                                          void* scratch, int r, int n, int l, int any_n,
                                          void* stream) {
  return launch_columns(false, dense(u, l), w, out, scratch, r, n, l, any_n, stream);
}

extern "C" int robust_median_launch(const void* u, const void* w, void* out, void* scratch,
                                    int r, int n, int l, int any_n, void* stream) {
  return launch_columns(true, dense(u, l), w, out, scratch, r, n, l, any_n, stream);
}

// q: (R, N, Lp) int8 with Lp % 1024 == 0, s: (R, N, Lp / 1024) fp32,
// w: (R, N) fp32, out: (R, Lp) fp32; scratch and any_n as above.
extern "C" int robust_trimmed_mean_q8_launch(const void* q, const void* s, const void* w,
                                             void* out, void* scratch, int r, int n, int lp,
                                             int any_n, void* stream) {
  return launch_columns(false, q8(q, s, lp), w, out, scratch, r, n, lp, any_n, stream);
}

extern "C" int robust_median_q8_launch(const void* q, const void* s, const void* w,
                                       void* out, void* scratch, int r, int n, int lp,
                                       int any_n, void* stream) {
  return launch_columns(true, q8(q, s, lp), w, out, scratch, r, n, lp, any_n, stream);
}

// u: (rows, L) fp32 (rows = R * N), out: (rows,) fp32.
extern "C" int robust_sqnorm_launch(const void* u, void* out, int rows, int l,
                                    void* stream) {
  return launch_rows(dense(u, l), out, rows, l, stream);
}

// q: (rows, Lp) int8, s: (rows, Lp / 1024) fp32, out: (rows,) fp32.
extern "C" int robust_sqnorm_q8_launch(const void* q, const void* s, void* out,
                                       int rows, int lp, void* stream) {
  return launch_rows(q8(q, s, lp), out, rows, lp, stream);
}
