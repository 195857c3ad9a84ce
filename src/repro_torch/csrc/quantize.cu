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
// there is bound by launch latency and by the chain of one tile: its loads,
// its absmax, then its divisions and stores.  The IEEE division is a dozen
// instructions and a branch to its slow path, for every element.
//
// Design of quantize_kernel: one block of 128 threads per (row, tile), a
// 1-D grid.  Thread t owns the groups of 4 elements at 4 t and 512 + 4 t,
// so each warp request is 512 consecutive bytes, and issues both loads
// before the first fabsf: one float4, two float2 or four scalars a group,
// as the row's address allows (a model update's length, P = 18,566 for the
// HAR LSTM, is rarely a multiple of 4, so rows are not all 16-byte
// aligned), and 0.0 past L.  The tile's absmax is a warp-shuffle max, then
// one barrier, after which every thread takes the max of the 4 warps'
// words itself: a max is exact in any order, so the scale is bit-equal to
// the plain version's.  The scale multiplies by the fp32 reciprocal of
// 127, as XLA compiles the reference's absmax / 127 (an exact division
// differs by one ulp on some tiles).  The codes are rintf(x / s), the IEEE
// division (no --use_fast_math) rounded half to even like jnp.round, but
// computed as rint_by_reciprocal says: a multiply by RN(1 / s) decides
// almost every element exactly, and the rest take the division.  Each
// group's 4 codes leave as one char4.
//
// What lost on an H100 80GB HBM3 at 700 W (device us: one update; the
// fleet's staging warm / cold): the first design (256 threads a tile,
// scalar loads, two barriers around a serial 8-way max, a division per
// element) 1.89 / 10.6 / 12.1; one warp a tile, no barrier, a division
// per element 5.7 / 13.3 / 16.4, and with the reciprocal 3.1 / 9.1 /
// 13.0 (its lanes' 32-element chains, alone on their schedulers, set the
// time of one update, and a single wave leaves no memory-compute
// overlap); two warps a tile joined by a 64-thread named barrier 2.1 /
// 11.2 / 14.0; 256 threads a tile with one barrier 1.47 / 11.2 / 12.3;
// this form with a division per element 2.4 / 11.0 / 12.4.  This form:
// 1.55-1.62 / 8.6 / 10.5.
//
// Dequantize is one thread per output element.  One update (n = 18,566)
// is bound by the launch: 1.117 us against 1.05-1.07 for the same launch
// at n = 1.  4 elements a thread (one char4 of codes, one scale, a float4
// or float2 store) read 1.127-1.141 on the same card, and lost.
#include <cstdint>
#include <cuda_runtime.h>

#include "loaders.cuh"

namespace {

constexpr int kThreads = 256;                                // dequantize
constexpr int kTileThreads = 128;                            // a quantize block: one tile
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kThreadGroups = kTile / (kVec * kTileThreads); // groups of a thread: 2

// rintf(v / s) without the division where a multiply by r = RN(1 / s)
// decides it.  s = RN(absmax * fp32(1/127)), so |v / s| < 127.0001, and
// t = RN(v * r) lies within |v / s| * 2^-23 < 2^-16 of v / s, RN(v / s)
// within 2^-18 of it (half an ulp below 128).  Where t is at least
// 2^-14 away from the nearest half-integer, t and RN(v / s) therefore lie
// strictly inside the same unit interval around rintf(t) and round to
// the same integer; a subnormal or zero quotient rounds to 0 on both
// sides.  `undecided` is set for the rest (a distance below the margin,
// NaN), which take the IEEE division: exact_rint.
constexpr float kDecided = 0.5f - 1.0f / 16384.0f;

__device__ __forceinline__ float rint_by_reciprocal(float v, float r, bool& undecided) {
  const float t = __fmul_rn(v, r);
  const float k = rintf(t);
  undecided |= !(fabsf(t - k) < kDecided);
  return k;
}

__device__ __forceinline__ float exact_rint(float v, float s, float r, float k) {
  const float t = __fmul_rn(v, r);
  if (!(fabsf(t - k) < kDecided)) k = rintf(v / s);
  return k;
}

__device__ __forceinline__ signed char to_code(float k) {
  return static_cast<signed char>(fminf(fmaxf(k, -127.f), 127.f));
}

__device__ __forceinline__ float absmax4(const float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// block blockIdx.x quantizes tile (blockIdx.x mod tiles) of row
// (blockIdx.x / tiles); thread t its groups at 4 t and 512 + 4 t
__global__ void __launch_bounds__(kTileThreads)
    quantize_kernel(const float* __restrict__ x, signed char* __restrict__ q,
                    float* __restrict__ s, int l, int lp) {
  const int tiles = lp / kTile;
  const int row = static_cast<int>(blockIdx.x / tiles);
  const int tile = static_cast<int>(blockIdx.x % tiles);
  const int col0 = tile * kTile + kVec * threadIdx.x;
  const LoadDense rows{x, l};

  // every load of the thread, before any of them is used
  float4 v[kThreadGroups];
#pragma unroll
  for (int g = 0; g < kThreadGroups; ++g) {
    const int col = col0 + kVec * kTileThreads * g;
    v[g] = col < l ? rows.group(row, col) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = absmax4(v[0]);
#pragma unroll
  for (int g = 1; g < kThreadGroups; ++g) m = fmaxf(m, absmax4(v[g]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float warp_max[kTileWarps];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = warp_max[0];
#pragma unroll
  for (int w = 1; w < kTileWarps; ++w) m = fmaxf(m, warp_max[w]);
  const float sc = fmaxf(m, 1e-12f) * (1.0f / 127.0f);
  if (threadIdx.x == 0) s[static_cast<size_t>(row) * tiles + tile] = sc;

  const float r = __frcp_rn(sc);
  bool undecided = false;
  float4 k[kThreadGroups];
#pragma unroll
  for (int g = 0; g < kThreadGroups; ++g)
    k[g] = make_float4(rint_by_reciprocal(v[g].x, r, undecided),
                       rint_by_reciprocal(v[g].y, r, undecided),
                       rint_by_reciprocal(v[g].z, r, undecided),
                       rint_by_reciprocal(v[g].w, r, undecided));
  if (undecided) {
#pragma unroll
    for (int g = 0; g < kThreadGroups; ++g)
      k[g] = make_float4(exact_rint(v[g].x, sc, r, k[g].x), exact_rint(v[g].y, sc, r, k[g].y),
                         exact_rint(v[g].z, sc, r, k[g].z), exact_rint(v[g].w, sc, r, k[g].w));
  }
  signed char* qr = q + static_cast<size_t>(row) * lp + col0;
#pragma unroll
  for (int g = 0; g < kThreadGroups; ++g)
    *reinterpret_cast<char4*>(qr + kVec * kTileThreads * g) =
        make_char4(to_code(k[g].x), to_code(k[g].y), to_code(k[g].z), to_code(k[g].w));
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
  const unsigned grid = static_cast<unsigned>(static_cast<long long>(b) * (lp / kTile));
  quantize_kernel<<<grid, kTileThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
