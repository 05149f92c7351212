// K13 and K14: the lane-packed serial chains over B = 32W independent
// messages, each under its own key, 32 messages per 32-bit plane word:
//   CBC      y_t = E(y_{t-1} ^ x_t)              (micro_aes.c:712-717)
//   CFB      y_t = E(y_{t-1}) ^ x_t              (micro_aes.c:808-814)
//   OFB      y_t = E(y_{t-1}), no data operand   (micro_aes.c:872-876)
//   CBC-MAC  m = E(m ^ x_t) while t < nvalid of the message, only the final
//            m is written (xMac, micro_aes.c:551-571)
// with y_{-1} the message's iv (or init).  The MAC optionally takes the
// one-pass AEAD chains' last-step constants (K11 and K12 run their MAC here,
// ops/aead_kernels): at a message's last valid step its block becomes
// (x & tail) ^ lastadd, and at the step before it x ^ prevadd (S2V's
// xorend).  Replaces
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
// blocks uint8[B, nb, 16] (none for OFB); nvalid int32[B], and optionally
// tail and lastadd, and prevadd, uint8[B, 16] (the MAC only); out
// uint8[B, nb, 16], or uint8[B, 16] for the MAC; all in natural message
// order.
//
// The ragged entry (micro_aes_chain_ragged, CBC, CFB and OFB) runs words of
// different lengths and key sizes in one launch: kpw uint32[15*128, W] (the
// round keys padded to 15), and per word a descriptor int64[4] = (steps,
// rounds | live << 8, msg0, off): slot j < live of the word is message msg0 +
// j of ivs, and its block t lies at off + 16 (j * steps + t) of blocks and of
// out.  The two words of a warp share steps and rounds (the shuffles need the
// whole warp, and no loop count may differ within it); an idle word (live 0)
// pads a run with an odd number of words.  The uniform entry is the same
// kernel with the descriptor of every word computed from (nb, rounds, tile).
//
// What bounds it on the card: the chain.  Step t of a message needs step
// t-1, so the nb ciphers of a word run one after another, and a batch has
// only W words of independent work: 128 words at 4096 messages, against 132
// SMs.  A word is spread over the 16 lanes of a half-warp, one per byte
// position p: lane p holds the 8 bit planes of byte p of the 32 messages.
// SubBytes is local (the Boyar-Peralta circuit on 8 planes); ShiftRows and
// MixColumns read the other bytes of the column with __shfl_sync inside the
// 16-lane group (24 shuffles per round); AddRoundKey reads the word's key
// planes, staged once in shared memory.  A warp holds two words, a block one
// warp, and each warp runs alone on an SM sub-partition, whose 16 INT32
// lanes take two cycles per warp instruction: a step costs one warp's
// instruction stream, so the time does not grow with B up to 16,384
// messages (tools/chain_probe.py).
//
// The first design (PRs 6-8) counted on an H100 (tools/spread_ab.py sass):
// a round loop of 152 instructions (116 LOP3, 24 SHFL, 8 LDS), and 510-740
// more a step, mostly the address arithmetic of 32 one-byte loads and 32
// one-byte stores per lane; at AES-256 CBC a step was ~2,540 instructions,
// ~2,000 of them on the INT32 lanes.  This design (lane_spread.cuh's second
// form) moves the data as rows: lane q of the warp loads the 16-byte block
// of slot q of both words one step ahead (two 16-byte loads), puts them in
// shared memory at the step, and each lane reads its byte of the 32 rows at
// fixed offsets; the output goes back the same way (two 16-byte stores per
// lane).  The key planes are read as two 16-byte words a round, and the
// rounds are unrolled per key size (instance() below): AES-256 CBC and CFB
// keep the rolled loop, which timed 4 % faster than their 2,224-instruction
// unrolled step.  One kernel per kind picks the instance per warp from its
// words' rounds, for uniform and ragged launches alike.  Counted: a step of
// 1,656 instructions at AES-128 CBC (1,927 before), 2,321 at AES-256
// (2,535); OFB 2,095 (2,331).  Timed and not kept (PERF.md): the next
// step's data planes made beside the cipher (a software pipeline), a
// kernel per unrolled instance for uniform launches, the round keys of the
// unrolled instances in registers, and the rows staged by cp.async.
//
// The MAC's step mask comes from nvalid by two ballots per step (two more
// each for the last and the next-to-last step where the constants are
// given), and a warp stops once no message of its two words has a step left
// (the lengths are public).  No address depends on key or data.
#include <cuda_runtime.h>

#include "lane_spread.cuh"

namespace {

enum Kind { kCbc = 0, kCfb = 1, kOfb = 2, kMac = 3 };

using spread::kFull;
using spread::kKeyRows;
using spread::kStageRows;
using spread::kStageWord;
using spread::planes_from_stage;
using spread::stage_from_planes;

struct Args {
  const uint32_t* kpw;   // key plane q of word v at kpw[q * w + v]
  const int64_t* desc;   // ragged: int64[W, 4] per word; null: uniform
  const uint8_t* ivs;
  const uint8_t* blocks;
  const int* nvalid;
  const uint8_t* tail;     // the MAC's last-step constants: null, or uint8[B, 16]
  const uint8_t* lastadd;  // (tail and lastadd together)
  const uint8_t* prevadd;
  uint8_t* out;
  int rounds, w, nb, tile;
};

// A word: `live` message slots; slot j is message msg0 + j * mstep (ivs,
// nvalid, the MAC's out), and its block t lies at off + j * stride + 16 t of
// blocks and out.
struct Word {
  int steps, rounds, live;
  size_t msg0, mstep, off, stride;
};

__device__ __forceinline__ Word word_of(const Args& a, int word) {
  Word d;
  if (a.desc != nullptr) {
    const int64_t* e = a.desc + 4 * static_cast<size_t>(word);
    d.steps = static_cast<int>(e[0]);
    d.rounds = static_cast<int>(e[1] & 0xFF);
    d.live = static_cast<int>(e[1] >> 8);
    d.msg0 = static_cast<size_t>(e[2]);
    d.mstep = 1;
    d.off = static_cast<size_t>(e[3]);
    d.stride = static_cast<size_t>(d.steps) * 16;
  } else {
    const bool live = word < a.w;  // an odd W leaves the last half-warp idle
    const spread::Lanes l = spread::lanes_of(live ? word : 0, a.tile);
    const size_t row = static_cast<size_t>(a.nb) * 16;
    d.steps = a.nb;
    d.rounds = a.rounds;
    d.live = live ? 32 : 0;
    d.msg0 = l.msg0;
    d.mstep = l.step;
    d.off = l.msg0 * row;
    d.stride = row * l.step;
  }
  return d;
}

__device__ __forceinline__ uint4 load_row(const uint8_t* at) {
  return __ldg(reinterpret_cast<const uint4*>(at));
}

// The steps of the warp's two words.  Lane q moves the rows of slot q of
// both words (r[h] holds the next block's), lane p = q & 15 of half h
// computes byte p of word h.
template <int KIND, int ROUNDS>
__device__ __forceinline__ void chain_steps(const Args& a, const Word (&wd)[2], const uint4* kq,
                                            uint4* in_st, uint4* out_st) {
  const int lane = threadIdx.x, half = lane >> 4, p = lane & 15;
  const int nb = wd[0].steps, rounds = wd[0].rounds;
  const int src = uaes::shift_src(p);  // ShiftRows: the byte that moves to p
  const int row1 = 4 * (p / 4) + (p + 1) % 4, row2 = 4 * (p / 4) + (p + 2) % 4;
  const uint8_t* my_in = reinterpret_cast<const uint8_t*>(in_st) + half * kStageWord + p;
  uint8_t* my_out = reinterpret_cast<uint8_t*>(out_st) + half * kStageWord + p;
  const bool mine[2] = {lane < wd[0].live, lane < wd[1].live};  // slot `lane` holds a message

  uint4 r[2] = {};
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (mine[h]) r[h] = load_row(a.ivs + (wd[h].msg0 + lane * wd[h].mstep) * 16);
  in_st[lane] = r[0];
  in_st[kStageWord / 16 + lane] = r[1];
  __syncwarp();
  uint32_t carry[8];
  planes_from_stage(my_in, carry);
  if constexpr (KIND != kOfb) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (mine[h] && nb > 0) r[h] = load_row(a.blocks + wd[h].off + lane * wd[h].stride);
  }
  int nv0 = 0, nv1 = 0;
  // The planes of a per-message row operand of both words (all zero where
  // the operand is null), through the input stage.
  auto row_planes = [&](const uint8_t* src, uint32_t (&pl)[8]) {
    uint4 v[2] = {};
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (mine[h] && src != nullptr) v[h] = load_row(src + (wd[h].msg0 + lane * wd[h].mstep) * 16);
    __syncwarp();  // the stage's last reads are done
    in_st[lane] = v[0];
    in_st[kStageWord / 16 + lane] = v[1];
    __syncwarp();
    planes_from_stage(my_in, pl);
  };
  const bool consts = KIND == kMac && a.lastadd != nullptr;
  uint32_t tl[8] = {}, la[8] = {}, pa[8] = {};
  if constexpr (KIND == kMac) {
    const Word me = half ? wd[1] : wd[0];
    if (p < me.live) nv0 = a.nvalid[me.msg0 + p * me.mstep];
    if (16 + p < me.live) nv1 = a.nvalid[me.msg0 + (16 + p) * me.mstep];
    if (consts) {
      row_planes(a.tail, tl);
      row_planes(a.lastadd, la);
      row_planes(a.prevadd, pa);
    }
  }

  for (int t = 0; t < nb; ++t) {
    uint32_t mask = 0u;
    if constexpr (KIND == kMac) {
      const uint32_t b0 = __ballot_sync(kFull, t < nv0);  // lanes' messages p of both words
      const uint32_t b1 = __ballot_sync(kFull, t < nv1);  // and 16 + p
      if ((b0 | b1) == 0u) break;  // the same in every lane of the warp
      mask = __byte_perm(b0, b1, half ? 0x7632 : 0x5410);
    }
    __syncwarp();  // the previous step's stage reads are done
    uint32_t x[8] = {};  // the data planes (none for OFB)
    if constexpr (KIND != kOfb) {
      in_st[lane] = r[0];
      in_st[kStageWord / 16 + lane] = r[1];
      __syncwarp();
      planes_from_stage(my_in, x);
      if (t + 1 < nb) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (mine[h])
            r[h] = load_row(a.blocks + wd[h].off + lane * wd[h].stride +
                            static_cast<size_t>(t + 1) * 16);
      }
    }
    if (consts) {  // the same in every lane of the warp
      const uint32_t l0 = __ballot_sync(kFull, t == nv0 - 1);
      const uint32_t l1 = __ballot_sync(kFull, t == nv1 - 1);
      const uint32_t p0 = __ballot_sync(kFull, t == nv0 - 2);
      const uint32_t p1 = __ballot_sync(kFull, t == nv1 - 2);
      const uint32_t last = __byte_perm(l0, l1, half ? 0x7632 : 0x5410);
      const uint32_t prev = __byte_perm(p0, p1, half ? 0x7632 : 0x5410);
#pragma unroll
      for (int b = 0; b < 8; ++b)
        x[b] ^= (last & ((x[b] & ~tl[b]) ^ la[b])) ^ (prev & pa[b]);
    }
    uint32_t s[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) s[b] = (KIND == kCbc || KIND == kMac) ? carry[b] ^ x[b] : carry[b];
    spread::encrypt_rounds<ROUNDS>(s, kq, rounds, src, row1, row2);
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
      stage_from_planes(s, my_out);
      __syncwarp();
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (mine[h])
          *reinterpret_cast<uint4*>(a.out + wd[h].off + lane * wd[h].stride +
                                    static_cast<size_t>(t) * 16) =
              out_st[h * (kStageWord / 16) + lane];
    }
  }
  if constexpr (KIND == kMac) {
    __syncwarp();
    stage_from_planes(carry, my_out);
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (mine[h])
        *reinterpret_cast<uint4*>(a.out + (wd[h].msg0 + lane * wd[h].mstep) * 16) =
            out_st[h * (kStageWord / 16) + lane];
  }
}

// The instance of the rounds a key size runs: unrolled while a step stays
// under ~2,150 instructions; a longer unrolled step ran slower than the
// rolled loop (0) on an H100 (AES-256 CBC/CFB, PERF.md).
template <int KIND>
__host__ __device__ constexpr int instance(int rounds) {
  return rounds == 14 && KIND != kOfb && KIND != kMac ? 0 : rounds;
}

template <int KIND>
__global__ void __launch_bounds__(32) chain_packed_kernel(Args a) {
  __shared__ uint4 keys[2 * kKeyRows];
  __shared__ uint4 in_st[kStageRows], out_st[kStageRows];
  const int half = threadIdx.x >> 4, p = threadIdx.x & 15;
  const Word wd[2] = {word_of(a, 2 * blockIdx.x), word_of(a, 2 * blockIdx.x + 1)};
  uint4* mine = keys + half * kKeyRows;
  const Word me = half ? wd[1] : wd[0];  // a select, not a local-memory index
  spread::stage_keys(mine, a.kpw, a.w, 2 * blockIdx.x + half, me.rounds, me.live > 0, p);
  __syncwarp();
  const uint4* kq = mine + p;
  if (wd[0].rounds == 10)  // the same in both words of the warp
    chain_steps<KIND, 10>(a, wd, kq, in_st, out_st);
  else if (wd[0].rounds == 12)
    chain_steps<KIND, 12>(a, wd, kq, in_st, out_st);
  else
    chain_steps<KIND, instance<KIND>(14)>(a, wd, kq, in_st, out_st);
}

int launch(const Args& a, int kind, int grid, cudaStream_t stream) {
  switch (kind) {
    case kCbc: chain_packed_kernel<kCbc><<<grid, 32, 0, stream>>>(a); break;
    case kCfb: chain_packed_kernel<kCfb><<<grid, 32, 0, stream>>>(a); break;
    case kOfb: chain_packed_kernel<kOfb><<<grid, 32, 0, stream>>>(a); break;
    case kMac: chain_packed_kernel<kMac><<<grid, 32, 0, stream>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// The uniform entry: B = 32W messages of nb blocks, one key size; the MAC's
// tail, lastadd and prevadd may be null (tail and lastadd together).
extern "C" int micro_aes_chain_packed(const uint32_t* kpw, const uint8_t* ivs,
                                      const uint8_t* blocks, const int* nvalid,
                                      const uint8_t* tail, const uint8_t* lastadd,
                                      const uint8_t* prevadd, uint8_t* out,
                                      int kind, int rounds, int w, int nb, int tile,
                                      cudaStream_t stream) {
  const bool consts = tail != nullptr || lastadd != nullptr || prevadd != nullptr;
  if (tile < 1 || w % tile || (kind == kMac && tile != 1) || !aligned16(ivs) ||
      !aligned16(blocks) || !aligned16(out) || !aligned16(tail) || !aligned16(lastadd) ||
      !aligned16(prevadd) || (kind != kMac && consts) ||
      (consts && (tail == nullptr || lastadd == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{kpw, nullptr, ivs, blocks, nvalid, tail, lastadd, prevadd, out, rounds, w, nb,
               tile};
  return launch(a, kind, (w + 1) / 2, stream);
}

// The ragged entry: W words (even) under the descriptors `desc`.
extern "C" int micro_aes_chain_ragged(const uint32_t* kpw, const int64_t* desc,
                                      const uint8_t* ivs, const uint8_t* blocks, uint8_t* out,
                                      int kind, int w, cudaStream_t stream) {
  if (w % 2 || kind == kMac || !aligned16(ivs) || !aligned16(blocks) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{kpw, desc, ivs, blocks, nullptr, nullptr, nullptr, nullptr, out, 0, w, 0, 1};
  return launch(a, kind, w / 2, stream);
}
