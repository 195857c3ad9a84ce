// Loads and stores of 4-element groups, shared by the kernels that read the
// round state as dense fp32 rows or as the int8 wire format (fedavg.cu,
// robust.cu, quantize.cu).
//
// A loader reads the group of kCols elements at column col (a multiple of
// the group's width) of a row in two steps, so that a kernel can issue
// every load of a thread before the first use: fetch issues the loads (Raw
// holds what they return), expand turns that into floats.  fetch_rows
// issues the loads of K consecutive rows in the order that keeps all of
// them in flight once compiled (read from the SASS for sm_90a: the int8
// loader's code words first, then its scales).  LoadDense (4 columns) and
// LoadDensePairs (2) read u[row, col]; LoadQ8 (4) reads q[row, col] *
// s[row, col / 1024], the product rounded (__fmul_rn, never contracted into
// a later fma) as the plain versions round their dequantized buffer.  A
// kernel body written once for a dense and the int8 loader therefore gives,
// on (q, s), bitwise what it gives on the dequantized buffer.
//
// Rows of fp32 are only as aligned as their length allows: a model update
// of P = 18,566 floats (the HAR LSTM) puts every other row of an (N, P)
// block on an 8-byte boundary.  So a dense group is one float4, two float2
// or four scalars, as its address allows, and the same holds for the
// stores.  The address depends on the row alone, so all the threads of a
// warp that share a row take the same branch.
//
// over_grid_y launches a kernel whose sessions or lanes lie on gridDim.y
// in launches of at most 65,535 of them (the axis's limit), each from its
// first row's pointers; every launch of up to 65,535 is the one launch it
// was before.  over_lanes does the same in launches of at most `per` rows
// (a cooperative launch holds only as many blocks as the card keeps
// resident at once).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kVec = 4;      // elements in a group
constexpr int kTile = 1024;  // int8 wire tile: one fp32 scale a tile
constexpr int kMaxGridY = 65535;

// launch(first, count) launches count rows from row first, count <= per;
// returns the first launch's error, else 0.
template <typename Launch>
int over_lanes(int rows, int per, Launch launch) {
  for (int r0 = 0; r0 < rows; r0 += per) {
    launch(r0, rows - r0 < per ? rows - r0 : per);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return 0;
}

template <typename Launch>
int over_grid_y(int rows, Launch launch) {
  return over_lanes(rows, kMaxGridY, launch);
}

struct LoadDense {
  using Raw = float4;
  const float* u;
  int l;
  // the group of 4 elements at col (col % 4 == 0, col < l) of row; 0.0
  // past the end of a ragged row
  __device__ __forceinline__ float4 group(size_t row, int col) const {
    const float* p = u + row * l + col;
    if (col + kVec <= l) {
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
  __device__ __forceinline__ Raw fetch(size_t row, int col) const { return group(row, col); }
  __device__ __forceinline__ static float4 expand(const Raw& raw) { return raw; }
  // the one element at col of row, as group() gives it
  __device__ __forceinline__ float at(size_t row, int col) const {
    return __ldg(u + row * l + col);
  }
  // the loader of the rows from row0 on (a later launch of a kernel whose
  // sessions pass gridDim.y)
  LoadDense from_row(size_t row0) const { return LoadDense{u + row0 * l, l}; }
};

// Dense rows 2 columns a group: one float2 where the row's address allows
// (every row of an even length, at an 8-byte boundary), else two scalars.
// Eq. 14 reads its rows so: on an H100 80GB HBM3 it beat LoadDense's 4
// columns at both engines' shapes, 1.30 against 1.73 us at (1, 5, 18,566)
// and 9.5 against 9.7 us cold at (64, 5, 18,566).
struct LoadDensePairs {
  static constexpr int kCols = 2;
  using Raw = float2;
  const float* u;
  int l;
  // the 2 elements at col (col % 2 == 0, col < l) of row; 0.0 past the end
  // of an odd row
  __device__ __forceinline__ float2 group(size_t row, int col) const {
    const float* p = u + row * l + col;
    if (col + kCols <= l && (reinterpret_cast<uintptr_t>(p) & 7) == 0)
      return __ldg(reinterpret_cast<const float2*>(p));
    return make_float2(__ldg(p), col + 1 < l ? __ldg(p + 1) : 0.f);
  }
  // rows row0 ... row0 + K - 1 (those below `rows` unless kExact)
  template <int K, bool kExact>
  __device__ __forceinline__ void fetch_rows(size_t row0, int rows, int col, Raw (&raw)[K]) const {
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (kExact || j < rows) raw[j] = group(row0 + j, col);
  }
  __device__ __forceinline__ static float2 expand(const Raw& raw) { return raw; }
  LoadDensePairs from_row(size_t row0) const { return LoadDensePairs{u + row0 * l, l}; }
};

// The 4 codes at p: one char4 where p is on a 4-byte boundary (always,
// when kWords), else four bytes.
template <bool kWords>
__device__ __forceinline__ char4 load_codes(const signed char* p) {
  if (kWords || (reinterpret_cast<uintptr_t>(p) & 3) == 0)
    return __ldg(reinterpret_cast<const char4*>(p));
  return make_char4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// kWords: the codes start on a 4-byte boundary (the launcher refuses any
// other start), so every group of codes is one 32-bit load.
template <bool kWords>
struct LoadQ8 {
  static constexpr int kCols = kVec;
  struct Raw {
    char4 c;
    float s;
  };
  const signed char* q;
  const float* s;
  int lp;
  // the codes of the group of 4 elements at col (col % 4 == 0, col < lp)
  // and their tile's scale (lp % 1024 == 0, so a group never leaves its
  // tile or the row)
  __device__ __forceinline__ Raw fetch(size_t row, int col) const {
    const float sc = __ldg(s + row * (lp / kTile) + col / kTile);
    return Raw{load_codes<kWords>(q + row * lp + col), sc};
  }
  // rows row0 ... row0 + K - 1 (those below `rows` unless kExact): every
  // word of codes, then every scale
  template <int K, bool kExact>
  __device__ __forceinline__ void fetch_rows(size_t row0, int rows, int col, Raw (&raw)[K]) const {
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (kExact || j < rows) raw[j].c = load_codes<kWords>(q + (row0 + j) * lp + col);
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (kExact || j < rows) raw[j].s = __ldg(s + (row0 + j) * (lp / kTile) + col / kTile);
  }
  __device__ __forceinline__ static float4 expand(const Raw& raw) {
    return make_float4(__fmul_rn(static_cast<float>(raw.c.x), raw.s),
                       __fmul_rn(static_cast<float>(raw.c.y), raw.s),
                       __fmul_rn(static_cast<float>(raw.c.z), raw.s),
                       __fmul_rn(static_cast<float>(raw.c.w), raw.s));
  }
  __device__ __forceinline__ float4 group(size_t row, int col) const {
    return expand(fetch(row, col));
  }
  // the one element at col of row, as expand() rounds it
  __device__ __forceinline__ float at(size_t row, int col) const {
    return __fmul_rn(static_cast<float>(__ldg(q + row * lp + col)),
                     __ldg(s + row * (lp / kTile) + col / kTile));
  }
  LoadQ8 from_row(size_t row0) const {
    return LoadQ8{q + row0 * lp, s + row0 * (lp / kTile), lp};
  }
};

// element k of a group
__device__ __forceinline__ float component(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
__device__ __forceinline__ float component(const float2& v, int k) { return k == 0 ? v.x : v.y; }

// res[0 .. C - 1] into p = out_row + col, the last group of a row cut at l:
// the widest store p's address allows (float4, float2, scalars)
template <int C>
__device__ __forceinline__ void store_group(float* p, int col, int l, const float (&res)[C]) {
  if (col + C <= l) {
    const auto a = reinterpret_cast<uintptr_t>(p);
    if constexpr (C == 4) {
      if ((a & 15) == 0) {
        *reinterpret_cast<float4*>(p) = make_float4(res[0], res[1], res[2], res[3]);
        return;
      }
    }
    if ((a & 7) == 0) {
#pragma unroll
      for (int k = 0; k < C; k += 2)
        reinterpret_cast<float2*>(p)[k / 2] = make_float2(res[k], res[k + 1]);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < C; ++k)
    if (col + k < l) p[k] = res[k];
}

}  // namespace
