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
// (~7.1 us) or 6.25 MB of codes (~1.9 us) for one fma per element.
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
// Squared norm: one block per (r, n) row; thread t sums elements t,
// t + 256, ... in order with fmaf, then a fixed shuffle tree and a fixed
// sum over the 8 warps: no atomics, the same result in every run.  An
// element's thread does not depend on L, so the q8 sum over the padded Lp
// adds exact +0.0 after the dense sum over P and equals it bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 16;
constexpr int kTile = 1024;

struct LoadDense {
  const float* u;
  int l;
  __device__ __forceinline__ float operator()(size_t row, int col) const {
    return __ldg(u + row * l + col);
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

template <class Load>
__global__ void sqnorm_kernel(Load load, float* __restrict__ out, int l) {
  const size_t row = blockIdx.x;
  float acc = 0.f;
  for (int i = threadIdx.x; i < l; i += kThreads) {
    const float v = load(row, i);
    acc = fmaf(v, v, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  __shared__ float warp_sum[kWarps];
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = warp_sum[0];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) t += warp_sum[k];
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
  sqnorm_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
