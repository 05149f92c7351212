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
// nb, 16]; wh null or uint8[B, 16]; c0, blocks, out and wh 16-byte aligned.
//
// What bounds it on the card: integer ALU issue.  No step needs another, so
// the work is a bitsliced AES of 32 blocks per (word, step) pair, ~1,050
// gates a round (AES-128), against 32 bytes moved per block.  The first
// design ran the serial chains' layout: a half-warp per word, a
// lane per byte, 24 shuffles a round and one-byte loads and stores, ~2,250
// instructions a step per lane at AES-128, ~36,000 per 32 blocks (PERF.md).
// Here a (word, step) pair is one group of 4/NC threads holding the 32
// blocks' state as planes (bit j = message j): with NC = 4 one thread holds
// all 128 planes, as K10's cipher half does (gcm_chain.cu); with NC = 2 or 1
// the state's columns are spread over 2 or 4 threads and ShiftRows moves the
// rows that change hands by shuffles (24 a round at NC = 1), so that small
// batches fill more of the card.  The rest of a step is straight code:
//  * the counters in the plane domain: c0's planes are made once per block
//    (one ballot per plane), bytes 0..8 stay, and bytes 9..15 + u are a
//    bitsliced add of the step u (two logic operations a bit), so there are
//    no counter transposes;
//  * the round keys of the block's (at most two) words staged once in
//    shared memory, read as 16-byte words (a column's four planes of a bit);
//  * the keystream back to words by one 32x32 transpose per column, XORed
//    onto 16-byte (NC = 4), 8- or 4-byte words of the 32 blocks, the
//    threads of a warp on neighbouring words.
// Counted on an H100 (tools/k15_k1_ab.py sass): a round is 1,872
// instructions at NC = 4 (1,836 LOP3, 32 LDS.128; ~23,400 per 32 blocks at
// AES-128) and 503 a thread at NC = 1 (467 LOP3, 24 SHFL, 8 LDS.128);
// 255, 128 and 64 registers at NC = 4, 2, 1, no spill.  CCM's whitener is
// step u = 0, written to wh; the payload then runs from c0 + 1.  Every
// address depends on the word, the step and the round only.
#include <cuda_runtime.h>

#include "aes_bitslice.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxThreads = 128;
constexpr int kStageLoads = 8;

// The state of a (word, step) pair over the G = 4/NC threads of its group:
// thread h holds columns c = NC*h + cl (cl < NC), s[cl][r][b] = the plane of
// bit b of byte 4c + r.

template <int NC>
__device__ __forceinline__ void sub_bytes(uint32_t (&s)[NC][4][8]) {
#pragma unroll
  for (int cl = 0; cl < NC; ++cl)
#pragma unroll
    for (int r = 0; r < 4; ++r) uaes::sbox_fwd(s[cl][r]);
}

// ShiftRows: row r of column c takes row r of column (c + r) % 4, which
// thread (h + (cl + r) / NC) % G holds as its column (cl + r) % NC.
template <int NC>
__device__ __forceinline__ void shift_rows(uint32_t (&s)[NC][4][8], int h, unsigned group) {
  constexpr int G = 4 / NC;
  uint32_t t[NC][4][8];
#pragma unroll
  for (int cl = 0; cl < NC; ++cl)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int lc = (cl + r) % NC, dh = (cl + r) / NC;
#pragma unroll
      for (int b = 0; b < 8; ++b)
        t[cl][r][b] = dh % G == 0 ? s[lc][r][b]
                                  : __shfl_sync(group, s[lc][r][b], (h + dh) % G, G);
    }
#pragma unroll
  for (int cl = 0; cl < NC; ++cl)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int b = 0; b < 8; ++b) s[cl][r][b] = t[cl][r][b];
}

// MixColumns on each column the thread holds: out_r = xtime(s_r ^ s_{r+1})
// ^ s_r ^ (s_0 ^ s_1 ^ s_2 ^ s_3).
template <int NC>
__device__ __forceinline__ void mix_columns(uint32_t (&s)[NC][4][8]) {
#pragma unroll
  for (int cl = 0; cl < NC; ++cl) {
    uint32_t col[8], o[4][8];
#pragma unroll
    for (int b = 0; b < 8; ++b) col[b] = s[cl][0][b] ^ s[cl][1][b] ^ s[cl][2][b] ^ s[cl][3][b];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t d[8], x[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) d[b] = s[cl][r][b] ^ s[cl][(r + 1) % 4][b];
      uaes::xtime(d, x);
#pragma unroll
      for (int b = 0; b < 8; ++b) o[r][b] = x[b] ^ s[cl][r][b] ^ col[b];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int b = 0; b < 8; ++b) s[cl][r][b] = o[r][b];
  }
}

// AddRoundKey from one round's 128 planes in shared memory (plane b*16 + p):
// a column's four planes of bit b are one 16-byte word.
template <int NC>
__device__ __forceinline__ void add_key(uint32_t (&s)[NC][4][8], const uint32_t* kr, int h) {
#pragma unroll
  for (int cl = 0; cl < NC; ++cl)
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const uint4 k = *reinterpret_cast<const uint4*>(kr + b * 16 + 4 * (NC * h + cl));
      s[cl][0][b] ^= k.x;
      s[cl][1][b] ^= k.y;
      s[cl][2][b] ^= k.z;
      s[cl][3][b] ^= k.w;
    }
}

template <int NC>
__device__ __forceinline__ void encrypt(uint32_t (&s)[NC][4][8], const uint32_t* kps, int rounds,
                                        int h, unsigned group) {
  add_key<NC>(s, kps, h);
#pragma unroll 1
  for (int r = 1; r < rounds; ++r) {
    sub_bytes<NC>(s);
    shift_rows<NC>(s, h, group);
    mix_columns<NC>(s);
    add_key<NC>(s, kps + r * 128, h);
  }
  sub_bytes<NC>(s);
  shift_rows<NC>(s, h, group);
  add_key<NC>(s, kps + rounds * 128, h);
}

// The counter planes of step u: c0's planes (`base`, plane b*16 + p), with
// the 56-bit window of bytes 9..15 plus u as a bitsliced add.  Bit i of the
// window (0 = the lowest bit of byte 15) is plane i % 8 of byte 15 - i / 8:
// column 3 holds bits 0..31, rows 3..1 of column 2 bits 32..55; byte 8 (row
// 0 of column 2) and the carry out of byte 9 stay out.  u < 2^32, so the
// high part adds the carry alone.  Threads without column 3 or 2 add 0.
template <int NC>
__device__ __forceinline__ void counter(uint32_t (&s)[NC][4][8], const uint32_t* base,
                                        uint32_t u, int h, unsigned group) {
  constexpr int G = 4 / NC, l3 = 3 % NC, h3 = 3 / NC, l2 = 2 % NC, h2 = 2 / NC;
#pragma unroll
  for (int cl = 0; cl < NC; ++cl)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int b = 0; b < 8; ++b) s[cl][r][b] = base[b * 16 + 4 * (NC * h + cl) + r];
  const uint32_t v = h == h3 ? u : 0u;
  uint32_t cy = 0u;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    uint32_t& x = s[l3][3 - i / 8][i % 8];
    const uint32_t a = x, m = 0u - ((v >> i) & 1u);
    x = a ^ cy ^ m;
    cy = (a & cy) | (m & (a | cy));
  }
  if constexpr (h2 != h3) cy = __shfl_sync(group, cy, h3, G);  // NC = 1: column 3's carry
  if (h != h2) cy = 0u;
#pragma unroll
  for (int i = 32; i < 56; ++i) {
    uint32_t& x = s[l2][3 - (i - 32) / 8][i % 8];
    const uint32_t a = x;
    x = a ^ cy;
    cy &= a;
  }
}

// The thread's NC words of one block: XORed with the keystream words k
// (x non-null), or k alone (the whitener).
template <int NC>
__device__ __forceinline__ void put_words(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                                          const uint32_t (&k)[NC]) {
  if constexpr (NC == 4) {
    uint4 v = x ? __ldg(reinterpret_cast<const uint4*>(x)) : make_uint4(0u, 0u, 0u, 0u);
    v.x ^= k[0];
    v.y ^= k[1];
    v.z ^= k[2];
    v.w ^= k[3];
    *reinterpret_cast<uint4*>(y) = v;
  } else if constexpr (NC == 2) {
    uint2 v = x ? __ldg(reinterpret_cast<const uint2*>(x)) : make_uint2(0u, 0u);
    v.x ^= k[0];
    v.y ^= k[1];
    *reinterpret_cast<uint2*>(y) = v;
  } else {
    *y = (x ? __ldg(x) : 0u) ^ k[0];
  }
}

// The (word, step) pairs are numbered word-major, pair = word * S + u, with
// S = the steps (nb, and one more for the whitener) or, where a block of
// warps would span more than two words, S = PB, one word a block and the
// pairs at u >= steps idle.  Block x takes pairs x*PB .. x*PB + PB - 1, a
// group of G = 4/NC threads each, and stages the key planes and c0's planes
// of its (at most two) words in shared memory; groups past the last pair
// stop after staging, so the card holds only live groups.
template <int NC>
__global__ void __launch_bounds__(kMaxThreads)
ctr_packed_kernel(const uint32_t* __restrict__ kpw, const uint4* __restrict__ c0,
                  const uint32_t* __restrict__ blocks, uint32_t* __restrict__ out,
                  uint32_t* __restrict__ wh, int rounds, int w, int nb, int stride, int per_block) {
  constexpr int G = 4 / NC;
  __shared__ __align__(16) uint32_t kps[2][uaes::kMaxKeyPlaneWords];
  __shared__ uint32_t base[2][128];
  const int whiten = wh != nullptr ? 1 : 0;
  const long long first = static_cast<long long>(blockIdx.x) * per_block;
  const int w0 = static_cast<int>(first / stride);
  const int nwords = min(static_cast<int>((first + per_block - 1) / stride), w - 1) - w0 + 1;
  const int lane = threadIdx.x & 31;
  const int nkeys = (rounds + 1) * 128, threads = blockDim.x;
  for (int k = 0; k < nwords; ++k) {
    const int word = w0 + k;
    const uint4 c = __ldg(c0 + 32 * static_cast<size_t>(word) + lane);
    // the key planes, kStageLoads loads in flight a thread
    for (int q0 = threadIdx.x; q0 < nkeys; q0 += kStageLoads * threads) {
      uint32_t v[kStageLoads];
#pragma unroll
      for (int i = 0; i < kStageLoads; ++i) {
        const int q = q0 + i * threads;
        v[i] = q < nkeys ? __ldg(kpw + static_cast<size_t>(q) * w + word) : 0u;
      }
#pragma unroll
      for (int i = 0; i < kStageLoads; ++i)
        if (q0 + i * threads < nkeys) kps[k][q0 + i * threads] = v[i];
    }
    // bit j of base[k][b*16 + p] = bit b of byte p of message 32 word + j
    for (int q = threadIdx.x >> 5; q < 128; q += threads >> 5) {
      const int p = q & 15;
      const uint32_t x = p < 4 ? c.x : p < 8 ? c.y : p < 12 ? c.z : c.w;
      const uint32_t bits = __ballot_sync(kFull, (x >> (8 * (p & 3) + (q >> 4))) & 1u);
      if (lane == 0) base[k][q] = bits;
    }
  }
  __syncthreads();
  const long long pair = first + threadIdx.x / G;
  const int word = static_cast<int>(pair / stride);
  const int u = static_cast<int>(pair - static_cast<long long>(word) * stride);
  const bool live = word < w && u < nb + whiten;
  const unsigned group = __ballot_sync(kFull, live);  // whole groups: the shuffles' lanes
  if (!live) return;
  const int h = threadIdx.x % G, k = word - w0;
  uint32_t s[NC][4][8];
  counter<NC>(s, base[k], static_cast<uint32_t>(u), h, group);
  encrypt<NC>(s, kps[k], rounds, h, group);
  // column c's planes, transposed, are word c of the 32 keystream blocks
#pragma unroll
  for (int cl = 0; cl < NC; ++cl) {
    uint32_t a[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) a[i] = s[cl][i / 8][i % 8];
    uaes::transpose32(a);
#pragma unroll
    for (int j = 0; j < 32; ++j) s[cl][j / 8][j % 8] = a[j];
  }
  const int t = u - whiten;
  const size_t msg0 = 32 * static_cast<size_t>(word);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    uint32_t ks[NC];
#pragma unroll
    for (int cl = 0; cl < NC; ++cl) ks[cl] = s[cl][j / 8][j % 8];
    if (t < 0) {
      put_words<NC>(nullptr, wh + (msg0 + j) * 4 + NC * h, ks);
    } else {
      const size_t at = ((msg0 + j) * nb + t) * 4 + NC * h;
      put_words<NC>(blocks + at, out + at, ks);
    }
  }
}

// Blocks of up to kMaxThreads threads; word-major pairs when a block spans
// at most two words, else one word a block (one warp, idle pairs past the
// steps: only when the steps are fewer than a warp's groups).
template <int NC>
int launch(const uint32_t* kpw, const uint8_t* c0, const uint8_t* blocks, uint8_t* out,
           uint8_t* wh, int rounds, int w, int nb, cudaStream_t stream) {
  constexpr int G = 4 / NC, warp_pairs = 32 / G;
  const int steps = nb + (wh != nullptr ? 1 : 0);
  int per_block = kMaxThreads / G, stride = steps;
  if (steps + 1 < per_block) per_block = max(warp_pairs, (steps + 1) / warp_pairs * warp_pairs);
  if (steps + 1 < per_block) stride = per_block;
  const long long blocks_n = (static_cast<long long>(w) * stride + per_block - 1) / per_block;
  if (blocks_n > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  ctr_packed_kernel<NC><<<static_cast<unsigned>(blocks_n), per_block * G, 0, stream>>>(
      kpw, reinterpret_cast<const uint4*>(c0), reinterpret_cast<const uint32_t*>(blocks),
      reinterpret_cast<uint32_t*>(out), reinterpret_cast<uint32_t*>(wh), rounds, w, nb, stride,
      per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// wh non-null: CCM's whitener E(c0) there, the payload from c0 + 1.  cols:
// the state columns a thread holds (4, 2 or 1), which the CUDA tests and
// tools/k15_k1_ab.py force to cover and time each layout.  The wrapper
// passes 0: the ranking measured on an H100 (tools/k15_k1_ab.py cols,
// PERF.md), 4 from 24,576 (word, step) pairs where each block holds whole
// words (blocks that span two words ran 10-16 % slower at 4 columns, 2-4 %
// at 2), else 2 from 6,144 pairs, else 1 (latency-bound: more threads a
// pair).
extern "C" int micro_aes_ctr_packed(const uint32_t* kpw, const uint8_t* c0, const uint8_t* blocks,
                                    uint8_t* out, uint8_t* wh, int rounds, int w, int nb,
                                    int cols, cudaStream_t stream) {
  const int steps = nb + (wh != nullptr ? 1 : 0);
  const long long pairs = static_cast<long long>(w) * steps;
  if (cols == 0) cols = pairs >= 24576 && steps % kMaxThreads == 0 ? 4 : pairs >= 6144 ? 2 : 1;
  switch (cols) {
    case 4: return launch<4>(kpw, c0, blocks, out, wh, rounds, w, nb, stream);
    case 2: return launch<2>(kpw, c0, blocks, out, wh, rounds, w, nb, stream);
    case 1: return launch<1>(kpw, c0, blocks, out, wh, rounds, w, nb, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
