// Per-tile symmetric int8 quantization of a model update, the int8 wire
// format of the EnFed transport and of the fleet's round state:
//
//     per 1024-element tile:  s = max(absmax, 1e-12) * fp32(1 / 127)
//                             q = clip(round_half_even(x / s), -127, 127)
//     dequantize:             x' = q * s
//
// quantize_kernel: x (B, L) fp32 -> q (B, Lp) int8, s (B, Lp / 1024) fp32,
// Lp = L rounded up to 1024 (the ragged tail quantizes as zeros).
// dequantize_kernel: q (Lp,) int8, s (Lp / 1024,) fp32 -> x' (n,) fp32.
//
// Replaces: src/repro/kernels/quantize/kernel.py::quantize_pallas (one row),
// ::quantize_batched_pallas (B rows) and ::dequantize_pallas.
//
// What bounds them on an H100: memory.  Quantize reads 4 bytes and writes
// ~1 per element for one compare, one division and one rounding; dequantize
// reads ~1 and writes 4 for one multiply.  At the fleet's staging (320 rows
// of Lp = 19,456) quantize moves ~31 MB, ~9.3 us at 3.35 TB/s; at one LSTM
// update (L = 18,566) either kernel moves ~94 KB, ~0.03 us, so a single call
// there is bound by launch latency.
//
// Design: one block of 256 threads per (row, tile); each thread owns 4
// consecutive elements (four bounded scalar loads: a model update's length,
// P = 18,566 for the HAR LSTM, is rarely a multiple of 4, so rows are not
// 16-byte aligned) and stores its 4 codes as one char4.  The tile's
// absmax is a warp-shuffle max, then a max over the 8 warps in shared
// memory: a max is exact in any order, so the scale is bit-equal to the
// plain version's.  The scale multiplies by the fp32 reciprocal of 127, as
// XLA compiles the reference's absmax / 127 (an exact division differs by
// one ulp on some tiles).  The code divides by the scale (never multiplies
// by its reciprocal; IEEE division without --use_fast_math) and rounds with
// rintf, which is round-half-to-even like jnp.round.  Dequantize is one
// thread per output element.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;
constexpr int kThreads = 256;   // x 4 elements = one tile
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ signed char to_code(float v, float s) {
  const float r = rintf(v / s);
  return static_cast<signed char>(fminf(fmaxf(r, -127.f), 127.f));
}

__global__ void quantize_kernel(const float* __restrict__ x,
                                signed char* __restrict__ q,
                                float* __restrict__ s, int l, int lp) {
  const int tile = blockIdx.x;
  const int row = blockIdx.y;
  const int tiles = lp / kTile;
  const int col = tile * kTile + threadIdx.x * 4;
  const float* xr = x + static_cast<size_t>(row) * l;

  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = col + k < l ? __ldg(xr + col + k) : 0.f;
  float m = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));

  __shared__ float warp_max[kWarps];
  __shared__ float tile_scale;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = warp_max[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t = fmaxf(t, warp_max[w]);
    const float sc = fmaxf(t, 1e-12f) * (1.0f / 127.0f);
    tile_scale = sc;
    s[static_cast<size_t>(row) * tiles + tile] = sc;
  }
  __syncthreads();
  const float sc = tile_scale;
  char4 out;
  out.x = to_code(v[0], sc);
  out.y = to_code(v[1], sc);
  out.z = to_code(v[2], sc);
  out.w = to_code(v[3], sc);
  *reinterpret_cast<char4*>(q + static_cast<size_t>(row) * lp + col) = out;
}

__global__ void dequantize_kernel(const signed char* __restrict__ q,
                                  const float* __restrict__ s,
                                  float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = static_cast<float>(__ldg(q + i)) * __ldg(s + i / kTile);
}

}  // namespace

// x: (b, l) fp32, q: (b, lp) int8, s: (b, lp / 1024) fp32, contiguous on the
// current device; lp = l rounded up to 1024.  Returns cudaGetLastError()
// after the launch.
extern "C" int quantize_launch(const void* x, void* q, void* s, int b, int l,
                               int lp, void* stream) {
  if (b <= 0 || lp <= 0) return 0;
  const dim3 grid(lp / kTile, b);
  quantize_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<signed char*>(q),
      static_cast<float*>(s), l, lp);
  return static_cast<int>(cudaGetLastError());
}

// q: (>= n) int8, s: per-1024-tile fp32 scales, out: (n,) fp32.
extern "C" int dequantize_launch(const void* q, const void* s, void* out,
                                 int n, void* stream) {
  if (n <= 0) return 0;
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  dequantize_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(q), static_cast<const float*>(s),
      static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
