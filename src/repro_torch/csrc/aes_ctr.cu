// AES-128 in CTR mode over a byte payload: the transport cipher of every
// model update.  Encryption and decryption are the same call.
//
//     counter block k = nonce[0..8) || k as 8 big-endian bytes
//     out[16k + i]    = in[16k + i] ^ AES128(round_keys, counter block k)[i]
//
// Replaces: src/repro/kernels/aes_ctr/kernel.py::aes_ctr_pallas.
//
// What bounds it on an H100: integer work.  The payload is read once and
// written once (2n bytes), but each 16-byte block costs ~1,100 byte-table
// lookups and XORs over its 10 rounds, so ~70 operations per byte moved.
// At the loop engine's payload (74,264 B = 4,642 blocks) a launch is also
// far shorter than its launch latency.
//
// Design: one thread per 16-byte block, so the 16-byte state lives in
// registers (every index below is a compile-time constant after unrolling).
// The S-box, the GF(2^8) x2 and x3 tables (built on the host from the field
// arithmetic, 768 B) and the 11 round keys (176 B) are staged in shared
// memory once per block of 256 threads.  The counter block is built in the
// kernel from the block index.  A full, 16-byte-aligned block is read and
// written as one 16-byte vector; the ragged tail (n % 16 != 0) and unaligned
// buffers go byte by byte.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// SubBytes then ShiftRows on the column-major state (byte i = row + 4*col):
// output (row r, col c) comes from input (row r, col (c + r) mod 4).
__device__ __forceinline__ void sub_shift(uint8_t s[16], const uint8_t* sbox) {
  uint8_t t[16];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int r = 0; r < 4; ++r) t[r + 4 * c] = sbox[s[r + 4 * ((c + r) & 3)]];
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = t[i];
}

__device__ __forceinline__ void mix_columns(uint8_t s[16], const uint8_t* mul2,
                                            const uint8_t* mul3) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint8_t a0 = s[4 * c], a1 = s[4 * c + 1], a2 = s[4 * c + 2],
                  a3 = s[4 * c + 3];
    s[4 * c] = mul2[a0] ^ mul3[a1] ^ a2 ^ a3;
    s[4 * c + 1] = a0 ^ mul2[a1] ^ mul3[a2] ^ a3;
    s[4 * c + 2] = a0 ^ a1 ^ mul2[a2] ^ mul3[a3];
    s[4 * c + 3] = mul3[a0] ^ a1 ^ a2 ^ mul2[a3];
  }
}

__device__ __forceinline__ void add_key(uint8_t s[16], const uint8_t* k) {
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] ^= k[i];
}

__device__ __forceinline__ uint32_t word(const uint8_t s[16], int w) {
  return static_cast<uint32_t>(s[4 * w]) |
         (static_cast<uint32_t>(s[4 * w + 1]) << 8) |
         (static_cast<uint32_t>(s[4 * w + 2]) << 16) |
         (static_cast<uint32_t>(s[4 * w + 3]) << 24);
}

__global__ void aes_ctr_kernel(const uint8_t* __restrict__ in,
                               uint8_t* __restrict__ out, long long n,
                               const uint8_t* __restrict__ tables,
                               const uint8_t* __restrict__ round_keys,
                               const uint8_t* __restrict__ nonce) {
  __shared__ uint8_t s_tab[768];  // sbox | x2 | x3
  __shared__ uint8_t s_rk[176];
  __shared__ uint8_t s_nonce[8];
  for (int i = threadIdx.x; i < 768; i += blockDim.x) s_tab[i] = tables[i];
  for (int i = threadIdx.x; i < 176; i += blockDim.x) s_rk[i] = round_keys[i];
  if (threadIdx.x < 8) s_nonce[threadIdx.x] = nonce[threadIdx.x];
  __syncthreads();

  const long long blk = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long base = blk * 16;
  if (base >= n) return;

  uint8_t s[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = s_nonce[i];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    s[8 + i] = static_cast<uint8_t>(static_cast<unsigned long long>(blk) >> (56 - 8 * i));

  add_key(s, s_rk);
  for (int rnd = 1; rnd < 10; ++rnd) {
    sub_shift(s, s_tab);
    mix_columns(s, s_tab + 256, s_tab + 512);
    add_key(s, s_rk + 16 * rnd);
  }
  sub_shift(s, s_tab);
  add_key(s, s_rk + 160);

  const bool aligned =
      ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (aligned && base + 16 <= n) {
    uint4 v = *reinterpret_cast<const uint4*>(in + base);
    v.x ^= word(s, 0);
    v.y ^= word(s, 1);
    v.z ^= word(s, 2);
    v.w ^= word(s, 3);
    *reinterpret_cast<uint4*>(out + base) = v;
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (base + i < n) out[base + i] = in[base + i] ^ s[i];
  }
}

}  // namespace

// in/out: (n,) uint8; tables: (768,) uint8 = sbox | x2 | x3; round_keys:
// (11, 16) uint8; nonce: (8,) uint8; all on the current device.  Returns
// cudaGetLastError() after the launch.
extern "C" int aes_ctr_launch(const void* in, void* out, int n,
                              const void* tables, const void* round_keys,
                              const void* nonce, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (static_cast<long long>(n) + 15) / 16;
  const unsigned grid = static_cast<unsigned>((blocks + kThreads - 1) / kThreads);
  aes_ctr_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), n,
      static_cast<const uint8_t*>(tables),
      static_cast<const uint8_t*>(round_keys),
      static_cast<const uint8_t*>(nonce));
  return static_cast<int>(cudaGetLastError());
}
