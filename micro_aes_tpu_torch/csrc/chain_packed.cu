// K13 and K14: the lane-packed serial chains over B = 32W independent
// messages, each under its own key, 32 messages per 32-bit plane word:
//   CBC      y_t = E(y_{t-1} ^ x_t)              (micro_aes.c:712-717)
//   CFB      y_t = E(y_{t-1}) ^ x_t              (micro_aes.c:808-814)
//   OFB      y_t = E(y_{t-1}), no data operand   (micro_aes.c:872-876)
//   CBC-MAC  m = E(m ^ x_t) while t < nvalid of the message, only the final
//            m is written (xMac, micro_aes.c:551-571)
// with y_{-1} the message's iv (or init).  Replaces
// micro_aes_tpu/ops/pallas_chain.py: chain_packed_fused (_chain_kernel),
// ofb_packed_fused (_ofb_kernel) and cbcmac_packed_fused (_cbcmac_kernel)
// (K13, the natural message map, tile 1), and chain_packed_fused_wide
// (_chain_kernel_w) and ofb_packed_fused_wide (_ofb_kernel_w) (K14, the same
// bodies in the wide message map of lane_spread.cuh, tile = wide_tile(W): bit j
// of word w is message (w / T) * 32T + j * T + w % T).  On the TPU the wide map
// saved two interleaving transposes around the kernel; here a lane fetches its
// bytes by address either way, so the map changes the first message and the
// stride between two of a word's messages, nothing else.  The natural map is
// its own instance (WIDE false, tile 1 at compile time), so K13 keeps constant
// strides.
//
// Contract (ops/chain_kernels.py): kpw uint32[(R+1)*128, W] lane-packed key
// planes (row r*128 + b*16 + p; bit j of word w = bit b of byte p of round
// key r of the message in bit j of word w under the map); ivs uint8[B, 16];
// blocks uint8[B, nb, 16] (none for OFB); nvalid int32[B] (the MAC only); out
// uint8[B, nb, 16], or uint8[B, 16] for the MAC; all in natural message
// order.
//
// What bounds it on the card: the chain.  Step t of a message needs step t-1,
// so the nb ciphers of a word run one after another, and a batch has only W
// words of independent work: 128 words at 4096 messages, against 132 SMs.
// The layout of K1-K10 (one thread owns a 32-block row in 128 registers)
// would run 128 threads that each issue a whole bitsliced cipher per step.
// Here a word is spread over the 16 lanes of a half-warp, one per byte
// position p: lane p holds the 8 bit planes of byte p of the 32 messages.
// SubBytes is local (the Boyar-Peralta circuit on 8 planes); ShiftRows and
// MixColumns read the other bytes of the column with __shfl_sync inside the
// 16-lane group (24 shuffles per round, encrypt_spread); AddRoundKey reads
// the word's key planes, staged once in shared memory.  A warp holds two
// words, a block one warp.  Each warp runs alone on an SM sub-partition,
// whose 16 INT32 lanes take two cycles per warp instruction, so a step costs
// one lane's ~150 instructions per round, and nb such steps in a row bound
// the kernel: its time does not grow with B up to 16,384 messages
// (tools/chain_probe.py), far from the card's issue rate (PERF.md gives the
// operations bound and a latency floor).
//
// Data: lane p reads byte p of block t of the 32 messages (for one message,
// the 16 lanes read 16 consecutive bytes), one step ahead of the cipher,
// packs them as x[k] = bytes of messages k, k+8, k+16 and k+24, and three
// masked-swap stages turn those 8 words into its 8 planes with bit j =
// message j, the lane order of kpw.  The output leaves the same way.  The
// MAC's step mask comes from nvalid by two ballots per step, and a warp
// stops once no message of its two words has a step left (the lengths are
// public).  No address depends on key or data.
#include <cuda_runtime.h>

#include "lane_spread.cuh"

namespace {

enum Kind { kCbc = 0, kCfb = 1, kOfb = 2, kMac = 3 };

using spread::encrypt_spread;
using spread::fetch;
using spread::kFull;
using spread::kKeyStride;
using spread::store_planes;
using spread::to_planes;

template <int KIND, bool WIDE>
__global__ void __launch_bounds__(32)
chain_packed_kernel(const uint32_t* __restrict__ kpw, const uint8_t* __restrict__ ivs,
                    const uint8_t* __restrict__ blocks, const int* __restrict__ nvalid,
                    uint8_t* __restrict__ out, int rounds, int w, int nb, int tile) {
  __shared__ uint32_t kps[2 * kKeyStride];
  const int half = threadIdx.x >> 4, p = threadIdx.x & 15;
  const int word = 2 * blockIdx.x + half;
  const bool live = word < w;  // an odd W leaves the last half-warp idle

  uint32_t* mine = kps + half * kKeyStride;
  for (int q = p; q < (rounds + 1) * 128; q += 16)
    mine[q] = live ? __ldg(kpw + static_cast<size_t>(q) * w + word) : 0u;
  __syncwarp();
  const uint32_t* kp = mine + p;
  const int src = uaes::shift_src(p);  // ShiftRows: the byte that moves to p
  const int row1 = 4 * (p / 4) + (p + 1) % 4, row2 = 4 * (p / 4) + (p + 2) % 4;

  const spread::Lanes lanes = spread::lanes_of(live ? word : 0, WIDE ? tile : 1);
  const size_t msg0 = lanes.msg0;
  const size_t row = static_cast<size_t>(nb) * 16;  // bytes of a message
  const size_t stride = row * lanes.step;            // bytes between two of the word's messages
  uint32_t raw[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) raw[j] = 0u;
  uint32_t carry[8];
  if (live) fetch(raw, ivs + msg0 * 16 + p, 16 * lanes.step);
  to_planes(raw, carry);

  const uint8_t* in = nullptr;
  if constexpr (KIND != kOfb) {
    in = blocks + msg0 * row + p;
    if (live && nb > 0) fetch(raw, in, stride);
  }
  int nv0 = 0, nv1 = 0;
  if constexpr (KIND == kMac) {
    if (live) {
      nv0 = nvalid[msg0 + p * lanes.step];
      nv1 = nvalid[msg0 + (16 + p) * lanes.step];
    }
  }
  uint8_t* dst = out + msg0 * (KIND == kMac ? 16 : row) + p;

  for (int t = 0; t < nb; ++t) {
    uint32_t mask = 0u;
    if constexpr (KIND == kMac) {
      const uint32_t b0 = __ballot_sync(kFull, t < nv0);  // lanes' messages p of both words
      const uint32_t b1 = __ballot_sync(kFull, t < nv1);  // and 16 + p
      if ((b0 | b1) == 0u) break;  // the same in every lane of the warp
      mask = __byte_perm(b0, b1, half ? 0x7632 : 0x5410);
    }
    uint32_t x[8] = {};  // the data planes (none for OFB)
    if constexpr (KIND != kOfb) {
      to_planes(raw, x);
      if (live && t + 1 < nb) fetch(raw, in + static_cast<size_t>(t + 1) * 16, stride);
    }
    uint32_t s[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) s[b] = (KIND == kCbc || KIND == kMac) ? carry[b] ^ x[b] : carry[b];
    encrypt_spread(s, kp, rounds, src, row1, row2);
    if constexpr (KIND == kCfb) {
#pragma unroll
      for (int b = 0; b < 8; ++b) s[b] ^= x[b];
    }
    if constexpr (KIND == kMac) {
#pragma unroll
      for (int b = 0; b < 8; ++b) carry[b] ^= mask & (s[b] ^ carry[b]);
    } else {
#pragma unroll
      for (int b = 0; b < 8; ++b) carry[b] = s[b];
      if (live) store_planes(s, dst + static_cast<size_t>(t) * 16, stride);
    }
  }
  if constexpr (KIND == kMac) {
    if (live) store_planes(carry, dst, 16 * lanes.step);
  }
}

template <int KIND>
void launch(const uint32_t* kpw, const uint8_t* ivs, const uint8_t* blocks, const int* nvalid,
            uint8_t* out, int rounds, int w, int nb, int tile, cudaStream_t stream) {
  const int grid = (w + 1) / 2;
  if constexpr (KIND != kMac) {  // K14: CBC, CFB and OFB in the wide map
    if (tile > 1) {
      chain_packed_kernel<KIND, true><<<grid, 32, 0, stream>>>(kpw, ivs, blocks, nvalid, out,
                                                               rounds, w, nb, tile);
      return;
    }
  }
  chain_packed_kernel<KIND, false><<<grid, 32, 0, stream>>>(kpw, ivs, blocks, nvalid, out,
                                                            rounds, w, nb, 1);
}

}  // namespace

extern "C" int micro_aes_chain_packed(const uint32_t* kpw, const uint8_t* ivs,
                                      const uint8_t* blocks, const int* nvalid, uint8_t* out,
                                      int kind, int rounds, int w, int nb, int tile,
                                      cudaStream_t stream) {
  if (tile < 1 || w % tile || (kind == kMac && tile != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (kind) {
    case kCbc: launch<kCbc>(kpw, ivs, blocks, nvalid, out, rounds, w, nb, tile, stream); break;
    case kCfb: launch<kCfb>(kpw, ivs, blocks, nvalid, out, rounds, w, nb, tile, stream); break;
    case kOfb: launch<kOfb>(kpw, ivs, blocks, nvalid, out, rounds, w, nb, tile, stream); break;
    case kMac: launch<kMac>(kpw, ivs, blocks, nvalid, out, rounds, w, nb, tile, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
