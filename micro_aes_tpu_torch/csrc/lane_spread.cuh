// The lane-spread layout of the serial chain kernels (K13/K14
// chain_packed.cu, K16 kw_wheel.cu): a word of 32 messages spread over the
// 16 lanes of a half-warp, lane p holding the 8 bit planes of byte p of the
// 32 messages (bit j = message j of the word).  Here: which messages a word
// holds, the staged rows with their 8x8 bit transposes, and one AES
// encryption or decryption of a word with (Inv)ShiftRows and (Inv)MixColumns
// as shuffles inside the 16-lane group.
//
// The form of the round and the step here was built from a count of the
// first form's SASS on an H100 (tools/spread_ab.py sass, PERF.md): its round
// loop was 152 instructions (116 LOP3, 24 SHFL, 8 LDS, 4 of loop overhead),
// and the rest of a step, 560-760 instructions, mostly the 64-bit address
// arithmetic of one-byte global loads and stores (73-239 IMAD and 30-95
// IADD3 a step).  This form moves each message's block as one 16-byte (KW:
// 8-byte) row a step, loaded by one lane of the warp one step ahead and
// exchanged through shared memory, so a lane's byte reads and writes are
// shared-memory accesses at fixed offsets; it reads the key planes as two
// 16-byte words a round, and unrolls the rounds of a key size (one instance
// each) while the step stays under ~2,150 instructions, so the step is one
// block of straight code.  That cut a step by 10-18 % (AES-256 CBC 2,535 ->
// 2,224, AES-128 KW wrap 2,125 -> 1,733); the round itself stays ~150 (nvcc
// already folds its ~166 two-input gates into 116 LOP3s).  Longer unrolled
// steps (AES-256 CBC/CFB and KW) ran 4-17 % slower than the rolled loop on
// an H100, so those keep it rolled (PERF.md).  K15 (aead_chain.cu), the one
// kernel of this family with no chain, left the layout for a bitsliced
// thread group per (word, step).
#pragma once

#include <cstddef>
#include <cstdint>

#include "aes_bitslice.cuh"

namespace spread {

constexpr unsigned kFull = 0xFFFFFFFFu;

// The messages of a word: bit j of word w holds message msg0 + j * step.  The
// natural map (key_planes_packed's lane order) has msg0 = 32w and step 1.  The
// wide map of a tile of T words (the JAX package's wide_perm) has msg0 =
// (w / T) * 32T + w % T and step T: the 32 messages of a word lie T apart.
// The natural map is the wide one with T = 1.
struct Lanes {
  size_t msg0, step;
};

__device__ __forceinline__ Lanes lanes_of(int word, int tile) {
  const size_t t = static_cast<size_t>(tile);
  return {static_cast<size_t>(word / tile) * 32 * t + static_cast<size_t>(word % tile), t};
}

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

// A warp's staging area: one 16-byte row per message slot of its two words,
// word h's row j at byte h * kStageWord + 16 j.  The 16-byte pad puts the two
// words' rows in different banks when each half-warp reads byte p of row j.
constexpr int kStageWord = 32 * 16 + 16;
constexpr int kStageRows = 2 * kStageWord / 16;  // in uint4

// A word's key planes laid out for 16-byte reads: planes 4c..4c+3 of round r
// for lane p at uint4 (2r + c) * 16 + p.
constexpr int kKeyRows = (uaes::kMaxRounds + 1) * 2 * 16;

// Stage a word's key planes: kpw holds plane q = r*128 + b*16 + p of word w
// at kpw[q * w_count + w] (core/bitslice.key_planes_packed, [R+1,8,16,W]).
__device__ __forceinline__ void stage_keys(uint4* mine, const uint32_t* __restrict__ kpw,
                                           size_t w_count, size_t word, int rounds, bool live,
                                           int p) {
  uint32_t* m = reinterpret_cast<uint32_t*>(mine);
  for (int q = p; q < (rounds + 1) * 128; q += 16) {
    const int r = q >> 7, b = (q >> 4) & 7, lane = q & 15;
    m[(((2 * r + (b >> 2)) * 16 + lane) << 2) + (b & 3)] =
        live ? __ldg(kpw + static_cast<size_t>(q) * w_count + word) : 0u;
  }
}

// Planes of byte p of the 32 rows of a word: `rows` = stage + h * kStageWord
// + p (row j's byte at rows[16 j]).
__device__ __forceinline__ void planes_from_stage(const uint8_t* rows, uint32_t (&s)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k)
    s[k] = static_cast<uint32_t>(rows[16 * k]) | static_cast<uint32_t>(rows[16 * (k + 8)]) << 8 |
           static_cast<uint32_t>(rows[16 * (k + 16)]) << 16 |
           static_cast<uint32_t>(rows[16 * (k + 24)]) << 24;
  transpose_bytes8(s);  // bit j of s[b] = bit b of row j's byte
}

// The inverse: byte j of the planes to byte p of row j.
__device__ __forceinline__ void stage_from_planes(const uint32_t (&s)[8], uint8_t* rows) {
  uint32_t x[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = s[k];
  transpose_bytes8(x);  // byte i of x[k] = the byte of message k + 8i
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) rows[16 * (k + 8 * i)] = static_cast<uint8_t>(x[k] >> (8 * i));
}

// One middle round of a word spread over a half-warp (lane p holds the planes
// s of byte p): SubBytes, then in three levels of 8 shuffles t = the byte
// ShiftRows brings to p (from lane `src`), u = t ^ t of the next row of the
// column (lane `row1`), v = u of the row after that (lane `row2`), and
// MixColumns 2 t_r ^ 3 t_{r+1} ^ t_{r+2} ^ t_{r+3} = xtime(u) ^ u ^ t ^ v,
// with AddRoundKey from the two 16-byte key words k0, k1 folded into the
// sum.  (Four shuffles of the state per plane at one level ran 6-7 % slower
// on an H100: PERF.md.)
__device__ __forceinline__ void round_fwd(uint32_t (&s)[8], uint4 k0, uint4 k1, int src,
                                          int row1, int row2) {
  uaes::sbox_fwd(s);
  uint32_t t[8], u[8], v[8], x[8];
#pragma unroll
  for (int b = 0; b < 8; ++b) t[b] = __shfl_sync(kFull, s[b], src, 16);
#pragma unroll
  for (int b = 0; b < 8; ++b) u[b] = t[b] ^ __shfl_sync(kFull, t[b], row1, 16);
#pragma unroll
  for (int b = 0; b < 8; ++b) v[b] = __shfl_sync(kFull, u[b], row2, 16);
  uaes::xtime(u, x);
  const uint32_t k[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
  for (int b = 0; b < 8; ++b) s[b] = x[b] ^ u[b] ^ t[b] ^ v[b] ^ k[b];
}

__device__ __forceinline__ void add_key(uint32_t (&s)[8], const uint4* kq, int r) {
  const uint4 k0 = kq[(2 * r) * 16], k1 = kq[(2 * r + 1) * 16];
  s[0] ^= k0.x; s[1] ^= k0.y; s[2] ^= k0.z; s[3] ^= k0.w;
  s[4] ^= k1.x; s[5] ^= k1.y; s[6] ^= k1.z; s[7] ^= k1.w;
}

// E_K of a word spread over a half-warp, with kq = the staged key rows of
// the word + p (kKeyRows layout).  ROUNDS > 0 unrolls the
// rounds of that key size; ROUNDS = 0 runs `rounds` in a rolled loop.
template <int ROUNDS>
__device__ __forceinline__ void encrypt_rounds(uint32_t (&s)[8], const uint4* kq, int rounds,
                                               int src, int row1, int row2) {
  add_key(s, kq, 0);
  if constexpr (ROUNDS > 0) {
#pragma unroll
    for (int r = 1; r < ROUNDS; ++r)
      round_fwd(s, kq[(2 * r) * 16], kq[(2 * r + 1) * 16], src, row1, row2);
  } else {
#pragma unroll 1
    for (int r = 1; r < rounds; ++r)
      round_fwd(s, kq[(2 * r) * 16], kq[(2 * r + 1) * 16], src, row1, row2);
  }
  const int last = ROUNDS > 0 ? ROUNDS : rounds;
  uaes::sbox_fwd(s);
#pragma unroll
  for (int b = 0; b < 8; ++b) s[b] = __shfl_sync(kFull, s[b], src, 16);
  add_key(s, kq, last);
}

// One middle round of D_K: InvShiftRows, InvSubBytes, AddRoundKey,
// InvMixColumns.
__device__ __forceinline__ void round_inv(uint32_t (&s)[8], uint4 k0, uint4 k1, int isrc,
                                          int row1, int row2) {
  uint32_t t[8], u[8], v[8], x[8];
#pragma unroll
  for (int b = 0; b < 8; ++b) t[b] = __shfl_sync(kFull, s[b], isrc, 16);
  uaes::sbox_inv(t);
  const uint32_t k[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
  for (int b = 0; b < 8; ++b) u[b] = t[b] ^ k[b];
#pragma unroll
  for (int b = 0; b < 8; ++b) t[b] = u[b] ^ __shfl_sync(kFull, u[b], row2, 16);
  uaes::xtime(t, x);
  uaes::xtime(x, v);
#pragma unroll
  for (int b = 0; b < 8; ++b) t[b] = u[b] ^ v[b];  // t = the column times d(z)
#pragma unroll
  for (int b = 0; b < 8; ++b) u[b] = t[b] ^ __shfl_sync(kFull, t[b], row1, 16);
#pragma unroll
  for (int b = 0; b < 8; ++b) v[b] = __shfl_sync(kFull, u[b], row2, 16);
  uaes::xtime(u, x);
#pragma unroll
  for (int b = 0; b < 8; ++b) s[b] = x[b] ^ u[b] ^ t[b] ^ v[b];
}

// D_K of a word, the inverse of encrypt_rounds.
template <int ROUNDS>
__device__ __forceinline__ void decrypt_rounds(uint32_t (&s)[8], const uint4* kq, int rounds,
                                               int isrc, int row1, int row2) {
  const int last = ROUNDS > 0 ? ROUNDS : rounds;
  add_key(s, kq, last);
  if constexpr (ROUNDS > 0) {
#pragma unroll
    for (int r = ROUNDS - 1; r > 0; --r)
      round_inv(s, kq[(2 * r) * 16], kq[(2 * r + 1) * 16], isrc, row1, row2);
  } else {
#pragma unroll 1
    for (int r = rounds - 1; r > 0; --r)
      round_inv(s, kq[(2 * r) * 16], kq[(2 * r + 1) * 16], isrc, row1, row2);
  }
#pragma unroll
  for (int b = 0; b < 8; ++b) s[b] = __shfl_sync(kFull, s[b], isrc, 16);
  uaes::sbox_inv(s);
  add_key(s, kq, 0);
}

}  // namespace spread
