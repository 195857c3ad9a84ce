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
// Three kernel bodies, each instantiated for two loaders.  LoadDense reads
// u[row, l]; LoadQ8 reads q[row, l] * s[row, l / 1024], the product rounded
// (__fmul_rn, never contracted into a later fma) as the plain version
// rounds its dequantized buffer.  The rest of each body is shared, so the
// q8 kernel on (q, s) is bitwise the dense kernel on the dequantized
// buffer, which keeps the loop engine (dense, dequantized) and the fleet
// (fused q8) in agreement.
//
// What bounds them on an H100: memory.  The trimmed mean and the median
// read N values per output and do O(N) (scan) or O(N^2) (sorting network)
// compares and selects in registers: at the fleet's shapes (R = 64, N = 5,
// L = 18,566) the dense kernels move 28.5 MB (~8.5 us at 3.35 TB/s) and the
// q8 kernels 11.2 MB (~3.35 us).  The squared norm reads 23.8 MB dense
// (~7.1 us) or 6.25 MB of codes (~1.9 us) for one fma per element, from
// HBM when the caller's buffer has left the 50 MB L2.
//
// Design.  Trimmed mean and median: grid (ceil(L / 256), R), one thread
// per column l, so a warp reads 32 consecutive columns of each contributor
// row (128 bytes dense, 32 bytes of codes).  The thread keeps the N values
// and weights in registers: arrays of the compile-time bound kMaxN = 16,
// indexed only by unrolled loop counters and guarded by the runtime n, so
// they never spill to local memory.  The trimmed mean finds its two
// extremes with strict > / < scans in n order (the first index wins a
// tie, like argmax), and divides (no reciprocal).  The median sorts with
// the odd-even transposition network of the reference (n phases of
// min/max on neighbours) and selects the two middle ranks.
// Squared norm: one block of 512 threads per (r, n) row, which it walks
// in chunks of 8,192 elements.  In a chunk, thread t loads the four
// 4-element groups t, t + 512, t + 1024 and t + 1536 (64 bytes of a
// thread's loads in flight at once, ~10 MB over the fleet's 320 rows), as
// one float4, two float2 or four scalars as the row's address allows (a
// row of L = 18,566 floats starts 8-byte aligned), or as one char4 of
// codes and the group's scale, read once per 1024-element tile; it squares
// them into four accumulators, one per position in the group.  Then a
// fixed shuffle tree and a fixed sum over the 16 warps: no atomics, the
// same result in every run.  Two other shapes lost on an H100: a cluster
// of 4 blocks per row, adding its partials through distributed shared
// memory, took twice as long with the buffer in L2, and 384 threads of 8
// groups (128 bytes in flight each) gained 0.2 us on the dense form and
// lost 0.8 us on the int8 one, cold.  Which thread, accumulator and order
// an element goes to depends on its index alone, never on L or on the
// load path, and the two loaders share the body, so the q8 sum over the
// padded Lp adds exact +0.0 to the dense sum over P and equals it bit for
// bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 16;
constexpr int kTile = 1024;
constexpr int kSqThreads = 512;
constexpr int kSqWarps = kSqThreads / 32;
constexpr int kSqVec = 4;                                  // elements in a group
constexpr int kSqGroups = 4;                               // groups a thread loads at once
constexpr int kSqChunk = kSqThreads * kSqVec * kSqGroups;  // 8,192 elements

struct LoadDense {
  const float* u;
  int l;
  __device__ __forceinline__ float operator()(size_t row, int col) const {
    return __ldg(u + row * l + col);
  }
  // the group of 4 elements at col (col % 4 == 0, col < l) of row; 0.0
  // past the end of a ragged row
  __device__ __forceinline__ float4 group(size_t row, int col) const {
    const float* p = u + row * l + col;
    if (col + kSqVec <= l) {
      const auto a = reinterpret_cast<uintptr_t>(p);
      if ((a & 15) == 0) return __ldg(reinterpret_cast<const float4*>(p));
      if ((a & 7) == 0) {
        const float2 lo = __ldg(reinterpret_cast<const float2*>(p));
        const float2 hi = __ldg(reinterpret_cast<const float2*>(p + 2));
        return make_float4(lo.x, lo.y, hi.x, hi.y);
      }
      return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
    }
    return make_float4(__ldg(p), col + 1 < l ? __ldg(p + 1) : 0.f,
                       col + 2 < l ? __ldg(p + 2) : 0.f, 0.f);
  }
};

struct LoadQ8 {
  const signed char* q;
  const float* s;
  int lp;
  __device__ __forceinline__ float operator()(size_t row, int col) const {
    const float code = static_cast<float>(__ldg(q + row * lp + col));
    return __fmul_rn(code, __ldg(s + row * (lp / kTile) + col / kTile));
  }
  // the group of 4 elements at col (col % 4 == 0, col < lp): one char4 of
  // codes (lp % 1024 == 0, so a group never leaves its tile or the row)
  __device__ __forceinline__ float4 group(size_t row, int col) const {
    const signed char* p = q + row * lp + col;
    const float sc = __ldg(s + row * (lp / kTile) + col / kTile);
    const char4 c = (reinterpret_cast<uintptr_t>(p) & 3) == 0
                        ? __ldg(reinterpret_cast<const char4*>(p))
                        : make_char4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
    return make_float4(__fmul_rn(static_cast<float>(c.x), sc),
                       __fmul_rn(static_cast<float>(c.y), sc),
                       __fmul_rn(static_cast<float>(c.z), sc),
                       __fmul_rn(static_cast<float>(c.w), sc));
  }
};

template <class Load>
__global__ void trimmed_mean_kernel(Load load, const float* __restrict__ w,
                                    float* __restrict__ out, int n, int l) {
  const int r = blockIdx.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= l) return;
  const size_t row0 = static_cast<size_t>(r) * n;
  float v[kMaxN], wb[kMaxN];
  bool act[kMaxN];
  int m = 0;
  int amax = n;
  float vmax = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxN; ++j) {
    if (j < n) {
      const float wj = __ldg(w + row0 + j);
      act[j] = wj > 0.f;
      wb[j] = act[j] ? wj : 0.f;
      v[j] = load(row0 + j, col);
      m += act[j];
      if (act[j] && (amax == n || v[j] > vmax)) {
        amax = j;
        vmax = v[j];
      }
    }
  }
  int amin = n;
  float vmin = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxN; ++j) {
    if (j < n && act[j] && j != amax && (amin == n || v[j] < vmin)) {
      amin = j;
      vmin = v[j];
    }
  }
  float num = 0.f, den = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxN; ++j) {
    if (j < n) {
      const float wu = (m > 2 && (j == amax || j == amin)) ? 0.f : wb[j];
      num = fmaf(wu, act[j] ? v[j] : 0.f, num);
      den += wu;
    }
  }
  out[static_cast<size_t>(r) * l + col] = num / fmaxf(den, 1e-9f);
}

template <class Load>
__global__ void median_kernel(Load load, const float* __restrict__ w,
                              float* __restrict__ out, int n, int l) {
  const int r = blockIdx.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= l) return;
  const size_t row0 = static_cast<size_t>(r) * n;
  float x[kMaxN];
  int m = 0;
#pragma unroll
  for (int j = 0; j < kMaxN; ++j) {
    x[j] = INFINITY;
    if (j < n) {
      const bool a = __ldg(w + row0 + j) > 0.f;
      m += a;
      if (a) x[j] = load(row0 + j, col);
    }
  }
  // odd-even transposition: n phases over neighbours (j, j + 1), j + 1 < n
#pragma unroll
  for (int phase = 0; phase < kMaxN; ++phase) {
    if (phase < n) {
#pragma unroll
      for (int j = phase % 2; j + 1 < kMaxN; j += 2) {
        if (j + 1 < n) {
          const float a = x[j], b = x[j + 1];
          x[j] = fminf(a, b);
          x[j + 1] = fmaxf(a, b);
        }
      }
    }
  }
  const int lo = m > 0 ? (m - 1) / 2 : 0;
  const int hi = m / 2;
  float vlo = 0.f, vhi = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxN; ++j) {
    if (j == lo) vlo = x[j];
    if (j == hi) vhi = x[j];
  }
  out[static_cast<size_t>(r) * l + col] = m > 0 ? 0.5f * (vlo + vhi) : 0.f;
}

__device__ __forceinline__ void add_squares(const float4 v, float (&acc)[kSqVec]) {
  acc[0] = fmaf(v.x, v.x, acc[0]);
  acc[1] = fmaf(v.y, v.y, acc[1]);
  acc[2] = fmaf(v.z, v.z, acc[2]);
  acc[3] = fmaf(v.w, v.w, acc[3]);
}

template <class Load>
__global__ void __launch_bounds__(kSqThreads)
    sqnorm_kernel(Load load, float* __restrict__ out, int l) {
  const size_t row = blockIdx.x;
  float acc[kSqVec] = {0.f, 0.f, 0.f, 0.f};
  for (long long chunk = 0; chunk < l; chunk += kSqChunk) {
    float4 v[kSqGroups];
#pragma unroll
    for (int j = 0; j < kSqGroups; ++j) {
      const long long col = chunk + kSqVec * (threadIdx.x + j * kSqThreads);
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

template <class Load>
int launch_columns(bool median, Load load, const void* w, void* out, int r,
                   int n, int l, void* stream) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (r <= 0 || l <= 0) return 0;
  const dim3 grid((l + kThreads - 1) / kThreads, r);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* wf = static_cast<const float*>(w);
  auto* of = static_cast<float*>(out);
  if (median)
    median_kernel<<<grid, kThreads, 0, st>>>(load, wf, of, n, l);
  else
    trimmed_mean_kernel<<<grid, kThreads, 0, st>>>(load, wf, of, n, l);
  return static_cast<int>(cudaGetLastError());
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

LoadQ8 q8(const void* q, const void* s, int lp) {
  return LoadQ8{static_cast<const signed char*>(q), static_cast<const float*>(s), lp};
}

}  // namespace

// u: (R, N, L) fp32, w: (R, N) fp32, out: (R, L) fp32, contiguous on the
// current device, 1 <= N <= 16.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for N outside [1, 16]).
extern "C" int robust_trimmed_mean_launch(const void* u, const void* w, void* out,
                                          int r, int n, int l, void* stream) {
  return launch_columns(false, dense(u, l), w, out, r, n, l, stream);
}

extern "C" int robust_median_launch(const void* u, const void* w, void* out,
                                    int r, int n, int l, void* stream) {
  return launch_columns(true, dense(u, l), w, out, r, n, l, stream);
}

// q: (R, N, Lp) int8 with Lp % 1024 == 0, s: (R, N, Lp / 1024) fp32,
// w: (R, N) fp32, out: (R, Lp) fp32.
extern "C" int robust_trimmed_mean_q8_launch(const void* q, const void* s,
                                             const void* w, void* out, int r,
                                             int n, int lp, void* stream) {
  return launch_columns(false, q8(q, s, lp), w, out, r, n, lp, stream);
}

extern "C" int robust_median_q8_launch(const void* q, const void* s,
                                       const void* w, void* out, int r, int n,
                                       int lp, void* stream) {
  return launch_columns(true, q8(q, s, lp), w, out, r, n, lp, stream);
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
