// AES-128 in CTR mode over a byte payload: the transport cipher of every
// model update.  Encryption and decryption are the same call.
//
//     counter block k = nonce[0..8) || k as 8 big-endian bytes
//     out[16k + i]    = in[16k + i] ^ AES128(round_keys, counter block k)[i]
//
// Replaces: src/repro/kernels/aes_ctr/kernel.py::aes_ctr_pallas.
//
// What bounds it on an H100: table lookups in shared memory.  The payload
// is read once and written once (2n bytes), but each 16-byte block costs
// 160 word lookups (16 in each of the 9 full rounds, 16 S-box bytes in the
// last) and ~500 integer operations around them.  At the loop engine's
// payload (74,264 B = 4,642 blocks) a launch is also far shorter than its
// launch latency, which is the floor of the device time there.
//
// Design: 32-bit T-table rounds, one thread per 16-byte block.  The state
// is 4 column words in registers (byte r of word c is row r, column c:
// the FIPS-197 byte order, little-endian), so a full round is, per output
// column c,
//
//     Te0[b0(w_c)] ^ rotl8(Te0[b1(w_c+1)]) ^ rotl16(Te0[b2(w_c+2)])
//                  ^ rotl24(Te0[b3(w_c+3)]) ^ rk[c]
//
// with Te0[x] = (2 S[x], S[x], S[x], 3 S[x]): SubBytes, ShiftRows and
// MixColumns in 4 word lookups, 3 rotations and 4 XORs.  Te1-Te3 are the
// rotations of Te0 (one funnel shift each), so one 1 KB table serves all
// four, and the last round reads S[x], byte 1 of Te0[x].  Each block of 64
// threads builds Te0 in shared memory from the `tables` argument (S-box,
// x2, x3, 768 B) and stages the 44 round-key words and the nonce, while
// its threads' payload loads are already in flight; the small blocks
// spread the 4,642 blocks of an fp32 update over 73 SMs (the int8 wire's
// 1,221 over 20).  A full, 16-byte-aligned block is read and written as
// one 16-byte vector; the ragged tail (n % 16 != 0) and unaligned buffers
// go byte by byte.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int bits) {
  return __funnelshift_l(x, x, bits);
}

__device__ __forceinline__ uint32_t byte_at(uint32_t w, int r) {
  return (w >> (8 * r)) & 0xffu;
}

// bytes 4i..4i+3 of p as a little-endian word
__device__ __forceinline__ uint32_t le_word(const uint8_t* p, int i) {
  return static_cast<uint32_t>(p[4 * i]) | (static_cast<uint32_t>(p[4 * i + 1]) << 8) |
         (static_cast<uint32_t>(p[4 * i + 2]) << 16) |
         (static_cast<uint32_t>(p[4 * i + 3]) << 24);
}

__device__ __forceinline__ uint32_t full_round(const uint32_t* te, uint32_t a, uint32_t b,
                                               uint32_t c, uint32_t d, uint32_t key) {
  return te[byte_at(a, 0)] ^ rotl(te[byte_at(b, 1)], 8) ^ rotl(te[byte_at(c, 2)], 16) ^
         rotl(te[byte_at(d, 3)], 24) ^ key;
}

// the last round: SubBytes and ShiftRows only; S[x] is byte 1 of Te0[x]
__device__ __forceinline__ uint32_t last_round(const uint32_t* te, uint32_t a, uint32_t b,
                                               uint32_t c, uint32_t d, uint32_t key) {
  return (((te[byte_at(a, 0)] >> 8) & 0x000000ffu) | (te[byte_at(b, 1)] & 0x0000ff00u) |
          ((te[byte_at(c, 2)] << 8) & 0x00ff0000u) | ((te[byte_at(d, 3)] << 16) & 0xff000000u)) ^
         key;
}

__global__ void aes_ctr_kernel(const uint8_t* __restrict__ in,
                               uint8_t* __restrict__ out, long long n,
                               const uint8_t* __restrict__ tables,
                               const uint8_t* __restrict__ round_keys,
                               const uint8_t* __restrict__ nonce) {
  __shared__ uint32_t s_te[256];
  __shared__ uint32_t s_key[46];  // 44 round-key words, then the 2 nonce words

  const long long blk = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long base = blk * 16;
  const bool vector =
      base + 16 <= n &&
      ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (vector) v = __ldg(reinterpret_cast<const uint4*>(in + base));

  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    const uint32_t s = __ldg(tables + i);
    const uint32_t x2 = __ldg(tables + 256 + s), x3 = __ldg(tables + 512 + s);
    s_te[i] = x2 | (s << 8) | (s << 16) | (x3 << 24);
  }
  for (int i = threadIdx.x; i < 46; i += blockDim.x)
    s_key[i] = i < 44 ? le_word(round_keys, i) : le_word(nonce, i - 44);
  __syncthreads();
  if (base >= n) return;

  const uint32_t* rk = s_key;
  const auto hi = static_cast<uint32_t>(static_cast<unsigned long long>(blk) >> 32);
  const auto lo = static_cast<uint32_t>(blk);
  uint32_t w0 = s_key[44] ^ rk[0];
  uint32_t w1 = s_key[45] ^ rk[1];
  uint32_t w2 = __byte_perm(hi, 0, 0x0123) ^ rk[2];  // counter bytes, big-endian
  uint32_t w3 = __byte_perm(lo, 0, 0x0123) ^ rk[3];
#pragma unroll
  for (int rnd = 1; rnd < 10; ++rnd) {
    const uint32_t* k = rk + 4 * rnd;
    const uint32_t t0 = full_round(s_te, w0, w1, w2, w3, k[0]);
    const uint32_t t1 = full_round(s_te, w1, w2, w3, w0, k[1]);
    const uint32_t t2 = full_round(s_te, w2, w3, w0, w1, k[2]);
    const uint32_t t3 = full_round(s_te, w3, w0, w1, w2, k[3]);
    w0 = t0;
    w1 = t1;
    w2 = t2;
    w3 = t3;
  }
  const uint32_t o0 = last_round(s_te, w0, w1, w2, w3, rk[40]);
  const uint32_t o1 = last_round(s_te, w1, w2, w3, w0, rk[41]);
  const uint32_t o2 = last_round(s_te, w2, w3, w0, w1, rk[42]);
  const uint32_t o3 = last_round(s_te, w3, w0, w1, w2, rk[43]);

  if (vector) {
    v.x ^= o0;
    v.y ^= o1;
    v.z ^= o2;
    v.w ^= o3;
    *reinterpret_cast<uint4*>(out + base) = v;
  } else {
    const uint32_t ks[4] = {o0, o1, o2, o3};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (base + i < n) out[base + i] = in[base + i] ^ static_cast<uint8_t>(byte_at(ks[i / 4], i % 4));
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
