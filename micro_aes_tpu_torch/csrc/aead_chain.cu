// K11 and K12: the one-pass AEAD chains over B = 32W independent messages,
// and K15, the counter half of K11 alone (at the end of the file),
// each under its own key, 32 messages per 32-bit plane word.  Per message,
// with ks_t = E_ctr(c0 + t) on the 56-bit big-endian counter of bytes 9..15
// (the carry stops at byte 9, incBlock, micro_aes.c:421-428) and the masked
// CBC-MAC m = E_mac(m ^ in_t) while t < nvalid, from m = init:
//   CCM seal   out_t = x_t ^ ks_{t+1}, in_t = x_t,   tag = ks_0 ^ m
//   CCM open   out_t = x_t ^ ks_{t+1}, in_t = out_t, tag = ks_0 ^ m
//   EAX seal   out_t = x_t ^ ks_t,     in_t = out_t, tag = m
//   EAX open   out_t = x_t ^ ks_t,     in_t = x_t,   tag = m
//   SIV seal   iv = m over in_t = x_t, then out_t = x_t ^ E_ctr(iv' + t), with
//              iv' = iv with bit 7 of bytes 8 and 12 cleared (c:931-934)
//   SIV open   out_t = x_t ^ ks_t (c0 arrives cleared), in_t = out_t, tag = m
// At a message's last valid step the MAC input is (in & tail) ^ lastadd, and
// SIV also XORs prevadd in at the step before it (the S2V last-block
// constants).  CCM and EAX have one key; SIV a MAC key K1 and a CTR key K2.
// Replaces micro_aes_tpu/ops/pallas_chain.py: aead_chain_fused (_aead_kernel),
// siv_seal_chain_fused (_siv_seal_kernel) and siv_open_chain_fused
// (_siv_open_kernel).
//
// Contract (ops/aead_kernels.py): kpw_mac / kpw_ctr uint32[(R+1)*128, W]
// lane-packed key planes (as K13's); c0, init, tail, lastadd, prevadd
// uint8[B, 16]; blocks uint8[B, nb, 16]; nvalid int32[B]; out uint8[B, nb,
// 16] (every step, also past nvalid) and tag uint8[B, 16].
//
// What bounds it on the card: the MAC chain, as in K13.  Step t of the MAC
// needs step t-1, and a batch has only W = B/32 words of work (64 at 2048
// messages), so the layout is K13's (csrc/lane_spread.cuh): a word spread
// over the 16 lanes of a half-warp, one lane per byte position, a warp alone
// on an SM sub-partition, where a step costs its lane's logic instructions.
// Each step here runs two ciphers in the same lanes, the keystream's and the
// MAC's, so a step costs about twice K13's; the keystream is off the chain
// (SIV seal runs it as a second phase with no chain at all), and the lever
// left is to make it in warps of their own (PERF.md section 7).
//
// The counter: lane p needs byte p of the counter block of all 32 messages
// at every step, but the 56-bit add carries across bytes, that is across
// lanes.  So every lane keeps each message's counter as a 64-bit z_j = C_j
// << (8p - 64) for p >= 9 (C_j = the BE value of bytes 9..15), whose top
// byte is byte p and whose overflow past bit 63 is the carry out of byte 9;
// a step adds 1 << (8p - 64).  Lanes p <= 8 hold their constant byte in the
// top byte and add 0.  The 32 top bytes are transposed into 8 planes as the
// data are.  No address depends on key or data; the step masks come from
// the public lengths by ballots, and a warp skips the MAC cipher once no
// message of its two words has a step left.
#include <cuda_runtime.h>

#include "lane_spread.cuh"

namespace {

enum Op { kCcmSeal = 0, kCcmOpen = 1, kEaxSeal = 2, kEaxOpen = 3, kSivSeal = 4, kSivOpen = 5 };

using spread::encrypt_spread;
using spread::fetch;
using spread::kFull;
using spread::kKeyStride;
using spread::store_planes;
using spread::to_planes;

// Each lane's counters of the 32 messages of a word: `at` points at byte 0
// of message 0's base block, 16 bytes apart (global or shared memory).
__device__ __forceinline__ void counter_init(uint64_t (&z)[32], const uint8_t* at, int p) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const uint8_t* blk = at + 16 * j;
    uint64_t c = 0;
#pragma unroll
    for (int q = 9; q < 16; ++q) c = (c << 8) | blk[q];
    z[j] = p >= 9 ? c << (8 * p - 64) : static_cast<uint64_t>(blk[p]) << 56;
  }
}

// The planes of this step's counter blocks, then one step on.
__device__ __forceinline__ void counter_step(uint64_t (&z)[32], uint64_t inc, uint32_t (&s)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t lo = __byte_perm(static_cast<uint32_t>(z[k] >> 32),
                                    static_cast<uint32_t>(z[k + 8] >> 32), 0x0073);
    const uint32_t hi = __byte_perm(static_cast<uint32_t>(z[k + 16] >> 32),
                                    static_cast<uint32_t>(z[k + 24] >> 32), 0x0073);
    s[k] = __byte_perm(lo, hi, 0x5410);  // top bytes of messages k, k+8, k+16, k+24
  }
  spread::transpose_bytes8(s);
#pragma unroll
  for (int j = 0; j < 32; ++j) z[j] += inc;
}

// The lanes' 32-bit mask of the half-warp's word from two ballots of the
// lanes' messages p (b0) and 16 + p (b1) of both words.
__device__ __forceinline__ uint32_t word_mask(bool c0, bool c1, int half) {
  const uint32_t b0 = __ballot_sync(kFull, c0), b1 = __ballot_sync(kFull, c1);
  return __byte_perm(b0, b1, half ? 0x7632 : 0x5410);
}

template <int OP>
__global__ void __launch_bounds__(32)
aead_chain_kernel(const uint32_t* __restrict__ kpw_mac, const uint32_t* __restrict__ kpw_ctr,
                  const uint8_t* __restrict__ c0, const uint8_t* __restrict__ init,
                  const uint8_t* __restrict__ blocks, const int* __restrict__ nvalid,
                  const uint8_t* __restrict__ tail, const uint8_t* __restrict__ lastadd,
                  const uint8_t* __restrict__ prevadd, uint8_t* __restrict__ out,
                  uint8_t* __restrict__ tag, int rounds, int w, int nb) {
  constexpr bool kSiv = OP == kSivSeal || OP == kSivOpen;
  constexpr bool kWhiten = OP == kCcmSeal || OP == kCcmOpen;
  constexpr bool kMacIn = OP == kCcmSeal || OP == kEaxOpen || OP == kSivSeal;
  __shared__ uint32_t kps[(kSiv ? 4 : 2) * kKeyStride];
  __shared__ uint8_t base_s[kSiv ? 2 * 32 * 16 : 1];  // SIV seal's counter bases
  const int half = threadIdx.x >> 4, p = threadIdx.x & 15;
  const int word = 2 * blockIdx.x + half;
  const bool live = word < w;  // an odd W leaves the last half-warp idle

  uint32_t* mine = kps + half * kKeyStride;
  for (int q = p; q < (rounds + 1) * 128; q += 16)
    mine[q] = live ? __ldg(kpw_mac + static_cast<size_t>(q) * w + word) : 0u;
  const uint32_t* kp_mac = mine + p;
  const uint32_t* kp_ctr = kp_mac;
  if constexpr (kSiv) {
    uint32_t* ctr = kps + (2 + half) * kKeyStride;
    for (int q = p; q < (rounds + 1) * 128; q += 16)
      ctr[q] = live ? __ldg(kpw_ctr + static_cast<size_t>(q) * w + word) : 0u;
    kp_ctr = ctr + p;
  }
  __syncwarp();
  const int src = uaes::shift_src(p);  // ShiftRows: the byte that moves to p
  const int row1 = 4 * (p / 4) + (p + 1) % 4, row2 = 4 * (p / 4) + (p + 2) % 4;
  const uint64_t inc = p >= 9 ? 1ull << (8 * p - 64) : 0ull;

  const size_t msg0 = 32 * static_cast<size_t>(live ? word : 0);
  const size_t stride = static_cast<size_t>(nb) * 16;  // bytes between two messages
  uint32_t raw[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) raw[j] = 0u;
  uint32_t carry[8], tl[8], la[8], pa[8] = {};
  if (live) fetch(raw, init + msg0 * 16 + p, 16);
  to_planes(raw, carry);
  if (live) fetch(raw, tail + msg0 * 16 + p, 16);
  to_planes(raw, tl);
  if (live) fetch(raw, lastadd + msg0 * 16 + p, 16);
  to_planes(raw, la);
  if constexpr (kSiv) {
    if (live) fetch(raw, prevadd + msg0 * 16 + p, 16);
    to_planes(raw, pa);
  }
  int nv0 = 0, nv1 = 0;
  if (live) {
    nv0 = nvalid[msg0 + p];
    nv1 = nvalid[msg0 + 16 + p];
  }
  const uint8_t* in = blocks + msg0 * stride + p;
  uint8_t* dst = out + msg0 * stride + p;

  // One MAC step over the input planes x: m = E_mac(m ^ in) where step t
  // counts, in = (x & tail) ^ lastadd at the last step, ^ prevadd before it.
  auto mac_step = [&](const uint32_t (&x)[8], int t) {
    const uint32_t mask = word_mask(t < nv0, t < nv1, half);
    if (__any_sync(kFull, mask != 0u)) {  // the same in every lane of the warp
      const uint32_t last = word_mask(t == nv0 - 1, t == nv1 - 1, half);
      uint32_t prev = 0u;
      if constexpr (kSiv) prev = word_mask(t == nv0 - 2, t == nv1 - 2, half);
      uint32_t s[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const uint32_t fin = (x[b] & tl[b]) ^ la[b];
        s[b] = carry[b] ^ x[b] ^ (last & (x[b] ^ fin)) ^ (prev & pa[b]);
      }
      encrypt_spread(s, kp_mac, rounds, src, row1, row2);
#pragma unroll
      for (int b = 0; b < 8; ++b) carry[b] ^= mask & (s[b] ^ carry[b]);
    }
  };

  uint64_t z[32];
  if constexpr (OP == kSivSeal) {
    if (live && nb > 0) fetch(raw, in, stride);
    for (int t = 0; t < nb; ++t) {
      if (__all_sync(kFull, t >= nv0 && t >= nv1)) break;
      uint32_t x[8];
      to_planes(raw, x);
      if (live && t + 1 < nb) fetch(raw, in + static_cast<size_t>(t + 1) * 16, stride);
      mac_step(x, t);
    }
    if (live) store_planes(carry, tag + msg0 * 16 + p, 16);  // the raw synthetic IV
    uint32_t cb[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) cb[b] = carry[b];
    if (p == 8 || p == 12) cb[7] = 0u;  // bit 7 of bytes 8 and 12
    uint8_t* mine_base = base_s + half * 32 * 16;
    store_planes(cb, mine_base + p, 16);
    __syncwarp();
    counter_init(z, mine_base, p);
    if (live && nb > 0) fetch(raw, in, stride);
    for (int t = 0; t < nb; ++t) {
      uint32_t x[8], ks[8];
      to_planes(raw, x);
      if (live && t + 1 < nb) fetch(raw, in + static_cast<size_t>(t + 1) * 16, stride);
      counter_step(z, inc, ks);
      encrypt_spread(ks, kp_ctr, rounds, src, row1, row2);
#pragma unroll
      for (int b = 0; b < 8; ++b) ks[b] ^= x[b];
      if (live) store_planes(ks, dst + static_cast<size_t>(t) * 16, stride);
    }
  } else {
    counter_init(z, c0 + msg0 * 16, p);
    uint32_t wh[8] = {};  // CCM's tag whitener E(A0)
    if constexpr (kWhiten) {
      counter_step(z, inc, wh);
      encrypt_spread(wh, kp_ctr, rounds, src, row1, row2);
    }
    if (live && nb > 0) fetch(raw, in, stride);
    for (int t = 0; t < nb; ++t) {
      uint32_t x[8], ks[8];
      to_planes(raw, x);
      if (live && t + 1 < nb) fetch(raw, in + static_cast<size_t>(t + 1) * 16, stride);
      counter_step(z, inc, ks);
      encrypt_spread(ks, kp_ctr, rounds, src, row1, row2);
#pragma unroll
      for (int b = 0; b < 8; ++b) ks[b] ^= x[b];
      if (live) store_planes(ks, dst + static_cast<size_t>(t) * 16, stride);
      if constexpr (kMacIn) {
        mac_step(x, t);
      } else {
        mac_step(ks, t);
      }
    }
#pragma unroll
    for (int b = 0; b < 8; ++b) carry[b] ^= wh[b];
    if (live) store_planes(carry, tag + msg0 * 16 + p, 16);
  }
}

// K15: lane-packed multi-message CTR, out_t = x_t ^ E(c0 + t) per message on
// K11's 56-bit counter, a key per message.  Replaces micro_aes_tpu/ops/
// pallas_chain.py: ctr_packed_fused (_ctr_chain_kernel).  Contract
// (ops/aead_kernels.py): kpw as K13's (natural map), c0 uint8[B, 16], blocks
// and out uint8[B, nb, 16].
//
// No step needs another, so unlike K11 a word is not walked through its nb
// steps by one half-warp: a block of kCtrHalfWarps half-warps takes one word
// (its key planes and counter bases staged once in shared memory), each
// half-warp kCtrChunk consecutive steps, and the grid's second dimension
// covers the steps: W x nb / 32 half-warps in all (4096 at 4096 x 256), so
// the kernel scales with the card's sub-partitions, not with the chain.  A
// half-warp starts its counters at c0 + t0 (the shifted 64-bit form adds
// t0 << (8p - 64) in one multiply-add per message) and steps them as K11 does.
constexpr int kCtrHalfWarps = 8;
constexpr int kCtrChunk = 4;

__global__ void __launch_bounds__(16 * kCtrHalfWarps)
ctr_packed_kernel(const uint32_t* __restrict__ kpw, const uint8_t* __restrict__ c0,
                  const uint8_t* __restrict__ blocks, uint8_t* __restrict__ out, int rounds,
                  int w, int nb) {
  __shared__ uint32_t kps[kKeyStride];
  __shared__ uint8_t base_s[32 * 16];
  const int word = blockIdx.x;
  const int hw = threadIdx.x >> 4, p = threadIdx.x & 15;
  for (int q = threadIdx.x; q < (rounds + 1) * 128; q += blockDim.x)
    kps[q] = __ldg(kpw + static_cast<size_t>(q) * w + word);
  const size_t msg0 = 32 * static_cast<size_t>(word);
  for (int q = threadIdx.x; q < 32 * 16; q += blockDim.x) base_s[q] = c0[msg0 * 16 + q];
  __syncthreads();
  const uint32_t* kp = kps + p;
  const int src = uaes::shift_src(p);
  const int row1 = 4 * (p / 4) + (p + 1) % 4, row2 = 4 * (p / 4) + (p + 2) % 4;
  const uint64_t inc = p >= 9 ? 1ull << (8 * p - 64) : 0ull;

  const int t0 = (blockIdx.y * kCtrHalfWarps + hw) * kCtrChunk;
  uint64_t z[32];
  counter_init(z, base_s, p);
#pragma unroll
  for (int j = 0; j < 32; ++j) z[j] += static_cast<uint64_t>(t0) * inc;
  const size_t stride = static_cast<size_t>(nb) * 16;  // bytes between two messages
  const uint8_t* in = blocks + msg0 * stride + p;
  uint8_t* dst = out + msg0 * stride + p;
  uint32_t raw[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) raw[j] = 0u;
  if (t0 < nb) fetch(raw, in + static_cast<size_t>(t0) * 16, stride);
  for (int k = 0; k < kCtrChunk; ++k) {
    const int t = t0 + k;
    if (__all_sync(kFull, t >= nb)) break;  // both half-warps of the warp are done
    uint32_t x[8], ks[8];
    to_planes(raw, x);
    if (t + 1 < nb && k + 1 < kCtrChunk) fetch(raw, in + static_cast<size_t>(t + 1) * 16, stride);
    counter_step(z, inc, ks);
    encrypt_spread(ks, kp, rounds, src, row1, row2);
#pragma unroll
    for (int b = 0; b < 8; ++b) ks[b] ^= x[b];
    if (t < nb) store_planes(ks, dst + static_cast<size_t>(t) * 16, stride);
  }
}

template <int OP>
void launch(const uint32_t* kpw_mac, const uint32_t* kpw_ctr, const uint8_t* c0,
            const uint8_t* init, const uint8_t* blocks, const int* nvalid, const uint8_t* tail,
            const uint8_t* lastadd, const uint8_t* prevadd, uint8_t* out, uint8_t* tag,
            int rounds, int w, int nb, cudaStream_t stream) {
  aead_chain_kernel<OP><<<(w + 1) / 2, 32, 0, stream>>>(
      kpw_mac, kpw_ctr, c0, init, blocks, nvalid, tail, lastadd, prevadd, out, tag, rounds, w,
      nb);
}

}  // namespace

extern "C" int micro_aes_aead_chain(const uint32_t* kpw_mac, const uint32_t* kpw_ctr,
                                    const uint8_t* c0, const uint8_t* init,
                                    const uint8_t* blocks, const int* nvalid,
                                    const uint8_t* tail, const uint8_t* lastadd,
                                    const uint8_t* prevadd, uint8_t* out, uint8_t* tag, int op,
                                    int rounds, int w, int nb, cudaStream_t stream) {
#define MICRO_AES_AEAD_CASE(OP)                                                              \
  case OP:                                                                                   \
    launch<OP>(kpw_mac, kpw_ctr, c0, init, blocks, nvalid, tail, lastadd, prevadd, out, tag, \
               rounds, w, nb, stream);                                                       \
    break;
  switch (op) {
    MICRO_AES_AEAD_CASE(kCcmSeal)
    MICRO_AES_AEAD_CASE(kCcmOpen)
    MICRO_AES_AEAD_CASE(kEaxSeal)
    MICRO_AES_AEAD_CASE(kEaxOpen)
    MICRO_AES_AEAD_CASE(kSivSeal)
    MICRO_AES_AEAD_CASE(kSivOpen)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MICRO_AES_AEAD_CASE
  return static_cast<int>(cudaGetLastError());
}

extern "C" int micro_aes_ctr_packed(const uint32_t* kpw, const uint8_t* c0, const uint8_t* blocks,
                                    uint8_t* out, int rounds, int w, int nb,
                                    cudaStream_t stream) {
  const int per_block = kCtrHalfWarps * kCtrChunk;
  const dim3 grid(w, (nb + per_block - 1) / per_block);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  ctr_packed_kernel<<<grid, 16 * kCtrHalfWarps, 0, stream>>>(kpw, c0, blocks, out, rounds, w, nb);
  return static_cast<int>(cudaGetLastError());
}
