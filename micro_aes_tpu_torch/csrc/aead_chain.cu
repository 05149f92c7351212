// K15: the lane-packed multi-message CTR keystream over B = 32W independent
// messages, each under its own key, 32 messages per 32-bit plane word, on the
// 56-bit big-endian counter of bytes 9..15 (the carry stops at byte 9,
// incBlock, micro_aes.c:421-428):
//   out_t = x_t ^ E(c0 + t)
// and the keystream pass of the one-pass AEAD chains K11 and K12
// (ops/aead_kernels), which run it beside K13's masked CBC-MAC
// (chain_packed.cu, with the last-step constants), two launches per call:
//   whiten (CCM)  wh = E(c0) to its own row, out_t = x_t ^ E(c0 + 1 + t)
// Replaces micro_aes_tpu/ops/pallas_chain.py: ctr_packed_fused
// (_ctr_chain_kernel), and the keystream halves of aead_chain_fused
// (_aead_kernel), siv_seal_chain_fused (_siv_seal_kernel) and
// siv_open_chain_fused (_siv_open_kernel).
//
// Contract (ops/aead_kernels.py): kpw uint32[(R+1)*128, W] lane-packed key
// planes (as K13's, natural map); c0 uint8[B, 16]; blocks and out uint8[B,
// nb, 16]; wh null or uint8[B, 16].
//
// The first design (PRs 7-9) ran each AEAD step's two ciphers, the
// keystream's and the MAC's, one after the other in the same half-warp, so
// a step cost about twice K13's although only the MAC is a chain; counted
// on an H100 (tools/mk_ab.py sass, PERF.md): 3,766 instructions a CCM step
// at AES-128 (two rolled round loops of 152 and ~1,030 more, among them 32
// one-byte loads and 32 one-byte stores per lane), 1.06-1.17 ms at 2048 x
// 256.  Split, the MAC runs K13's second form of the step (1,546) and the
// keystream this kernel, spread over the card.
//
// The counter: lane p needs byte p of the counter block of all 32 messages
// at every step, but the 56-bit add carries across bytes, that is across
// lanes.  So every lane keeps each message's counter as a 64-bit z_j = C_j
// << (8p - 64) for p >= 9 (C_j = the BE value of bytes 9..15), whose top
// byte is byte p and whose overflow past bit 63 is the carry out of byte 9;
// a step adds 1 << (8p - 64).  Lanes p <= 8 hold their constant byte in the
// top byte and add 0.  The 32 top bytes are transposed into 8 planes as the
// data are.  No address depends on key or data.
#include <cuda_runtime.h>

#include "lane_spread.cuh"

namespace {

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

// No step needs another, so a word is not walked through its nb steps by
// one half-warp: a block of kCtrHalfWarps half-warps takes one word (its key
// planes and counter bases staged once in shared memory), each half-warp
// kCtrChunk consecutive steps, and the grid's second dimension covers the
// steps: W x nb / 32 half-warps in all (4096 at 4096 x 256), so the kernel
// scales with the card's sub-partitions, not with the chain.  A half-warp
// starts its counters at c0 + t0 (the shifted 64-bit form adds t0 << (8p -
// 64) in one multiply-add per message); CCM's whitener is one more step,
// made by the first warp of the word's first block.
constexpr int kCtrHalfWarps = 8;
constexpr int kCtrChunk = 4;

__global__ void __launch_bounds__(16 * kCtrHalfWarps)
ctr_packed_kernel(const uint32_t* __restrict__ kpw, const uint8_t* __restrict__ c0,
                  const uint8_t* __restrict__ blocks, uint8_t* __restrict__ out,
                  uint8_t* __restrict__ wh, int rounds, int w, int nb) {
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

  uint64_t z[32];
  counter_init(z, base_s, p);
  if (wh != nullptr && blockIdx.y == 0 && threadIdx.x < 32) {  // E(c0): a whole warp shuffles
    uint32_t e[8];
    counter_step(z, 0ull, e);
    encrypt_spread(e, kp, rounds, src, row1, row2);
    if (hw == 0) store_planes(e, wh + msg0 * 16 + p, 16);
  }
  const int t0 = (blockIdx.y * kCtrHalfWarps + hw) * kCtrChunk;
  const uint64_t start = static_cast<uint64_t>(t0) + (wh != nullptr ? 1u : 0u);
#pragma unroll
  for (int j = 0; j < 32; ++j) z[j] += start * inc;
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

}  // namespace

// wh non-null: CCM's whitener E(c0) there, the payload from c0 + 1.
extern "C" int micro_aes_ctr_packed(const uint32_t* kpw, const uint8_t* c0, const uint8_t* blocks,
                                    uint8_t* out, uint8_t* wh, int rounds, int w, int nb,
                                    cudaStream_t stream) {
  const int per_block = kCtrHalfWarps * kCtrChunk;
  const int steps = (nb + per_block - 1) / per_block;
  const dim3 grid(w, wh != nullptr && steps == 0 ? 1 : steps);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  ctr_packed_kernel<<<grid, 16 * kCtrHalfWarps, 0, stream>>>(kpw, c0, blocks, out, wh, rounds, w,
                                                             nb);
  return static_cast<int>(cudaGetLastError());
}
