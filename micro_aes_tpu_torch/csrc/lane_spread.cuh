// The lane-spread layout of the chain kernels (K13 chain_packed.cu, K11/K12
// aead_chain.cu): a word of 32 messages spread over the 16 lanes of a
// half-warp, lane p holding the 8 bit planes of byte p of the 32 messages
// (bit j = message j).  Here: the byte fetch and store with their 8x8 bit
// transposes, and one AES encryption of a word with ShiftRows and MixColumns
// as shuffles inside the 16-lane group.
#pragma once

#include <cstddef>
#include <cstdint>

#include "aes_bitslice.cuh"

namespace spread {

constexpr unsigned kFull = 0xFFFFFFFFu;
// Words of key planes per word of messages, padded so that the two words of a
// warp read other banks.
constexpr int kKeyStride = uaes::kMaxKeyPlaneWords + 16;

// The 8x8 bit transpose in every byte lane of a[0..7]: afterwards bit k of
// byte i of a[b] is bit b of byte i of the old a[k] (the last three stages of
// uaes::transpose32).
__device__ __forceinline__ void transpose_bytes8(uint32_t (&a)[8]) {
#pragma unroll
  for (int stage = 0; stage < 3; ++stage) {
    const int j = 4 >> stage;
    const uint32_t m = stage == 0 ? 0x0F0F0F0Fu : stage == 1 ? 0x33333333u : 0x55555555u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = ((i & ~(j - 1)) << 1) | (i & (j - 1));  // bit j of k clear
      const uint32_t t = ((a[k] >> j) ^ a[k + j]) & m;
      a[k] ^= t << j;
      a[k + j] ^= t;
    }
  }
}

// Byte p of one block of each of the 32 messages of a word: `at` points at
// the byte of message 0, `stride` bytes lie between messages.
__device__ __forceinline__ void fetch(uint32_t (&raw)[32], const uint8_t* __restrict__ at,
                                      size_t stride) {
#pragma unroll
  for (int j = 0; j < 32; ++j) raw[j] = __ldg(at + j * stride);
}

// raw[j] = byte of message j -> planes s[b], bit j = bit b of raw[j].
__device__ __forceinline__ void to_planes(const uint32_t (&raw)[32], uint32_t (&s)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k)
    s[k] = raw[k] | (raw[k + 8] << 8) | (raw[k + 16] << 16) | (raw[k + 24] << 24);
  transpose_bytes8(s);
}

// The inverse of fetch and to_planes: byte j of the planes to message j.
__device__ __forceinline__ void store_planes(const uint32_t (&s)[8], uint8_t* __restrict__ at,
                                             size_t stride) {
  uint32_t x[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = s[k];
  transpose_bytes8(x);  // byte i of x[k] = the byte of message k + 8i
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) at[(k + 8 * i) * stride] = static_cast<uint8_t>(x[k] >> (8 * i));
}

// E_K of a word spread over a half-warp: lane p holds the planes s of byte
// p; kp points at the lane's column of the staged key planes (round r, bit b
// at kp[r*128 + b*16]).  Per round, in three levels of 8 shuffles: t = the
// byte ShiftRows brings to p (from lane `src`), u = t ^ t of the next row of
// the column (lane `row1`), v = u of the row after that (lane `row2`); then
// MixColumns 2 t_r ^ 3 t_{r+1} ^ t_{r+2} ^ t_{r+3} = xtime(u) ^ u ^ t ^ v.
// (The first design, four shuffles of the state per plane at one level, ran
// 6-7 % slower on an H100: PERF.md.)
__device__ __forceinline__ void encrypt_spread(uint32_t (&s)[8], const uint32_t* kp, int rounds,
                                               int src, int row1, int row2) {
#pragma unroll
  for (int b = 0; b < 8; ++b) s[b] ^= kp[b * 16];
#pragma unroll 1
  for (int r = 1; r < rounds; ++r) {
    uaes::sbox_fwd(s);
    uint32_t t[8], u[8], v[8], x[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) t[b] = __shfl_sync(kFull, s[b], src, 16);
#pragma unroll
    for (int b = 0; b < 8; ++b) u[b] = t[b] ^ __shfl_sync(kFull, t[b], row1, 16);
#pragma unroll
    for (int b = 0; b < 8; ++b) v[b] = __shfl_sync(kFull, u[b], row2, 16);
    uaes::xtime(u, x);
    const uint32_t* k = kp + r * 128;
#pragma unroll
    for (int b = 0; b < 8; ++b) s[b] = x[b] ^ u[b] ^ t[b] ^ v[b] ^ k[b * 16];
  }
  uaes::sbox_fwd(s);
  const uint32_t* k = kp + rounds * 128;
#pragma unroll
  for (int b = 0; b < 8; ++b) s[b] = __shfl_sync(kFull, s[b], src, 16) ^ k[b * 16];
}

}  // namespace spread
