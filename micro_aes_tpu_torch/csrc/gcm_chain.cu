// K10: the lane-packed multi-key GCM chain.  Every lane (a message, or a
// segment of one) runs, for t = 0..nb-1:
//   ctr = c0 + t on the 56-bit big-endian window (bytes 9..15)
//   out_t = x_t ^ E_k(ctr)                    (the lane's own key)
//   G = (G ^ src_t) * H                       (the lane's own H)
// with the step masks of ops/chain.py (freeze, source, last block, inject).
//
// Replaces micro_aes_tpu/ops/pallas_chain.py:gcm_chain_fused_raw
// (_gcm_kernel), where the serial order came from the TPU's sequential grid
// and 32 lanes shared each bitsliced word.
//
// Contract: kpw uint32[R+1, 8, 16, W] lane-packed key planes (W = B/32),
// htab uint32[16384, W] per-lane halving table (row (i*4+k)*32+j, column w
// = LE word k of halve^i(H) of lane 32w+j), c0/init/tail/initadd
// uint8[B, 16], blocks uint8[B, nb, 16], masks/lastm/srcm/initm
// uint32[nb, W] (bit j of word w = lane 32w+j) -> out uint8[B, nb, 16],
// g uint8[B, 16].
//
// What bounds it on the card: integer ALU issue.  Per block, the cipher is
// ~1,100 (AES-256) logic operations and the GHASH product another ~1,700,
// against 32 bytes moved.  The two halves want different layouts, so the
// entry point runs two kernels back to back on the stream:
//  * the cipher, fully parallel: one thread per (word column, step) builds
//    the 32 lanes' counter blocks in registers, transposes them to planes,
//    runs the bitsliced rounds with the column's lane-packed keys (read
//    through L1, addresses by round only) and xors the keystream onto the
//    32 blocks, which neighbouring threads (neighbouring steps) read and
//    write as contiguous 16-byte words;
//  * the fold, serial in t: one thread per lane holds G, the source and H
//    as four big-endian words and forms G * H as 128 masked XORs of H's
//    halvings, regenerating each halving in registers (a funnel shift and a
//    conditional XOR) instead of reading the 2 KB per-lane table on every
//    step (2 KB per block: 2 GB for a 16 MB batch).  It reads only H, the
//    table's i = 0 rows.
// Parallelism comes from the lanes: the caller splits long messages into
// segments (modes/seal_batch._CHAIN_LANES).  Every address depends only on
// the lane, the step and the round: no key- or data-dependent access.
#include <cuda_runtime.h>

#include "aes_bitslice.cuh"

namespace {

constexpr int kCipherThreads = 128;
constexpr int kFoldThreads = 128;

__device__ __forceinline__ uint32_t bswap32(uint32_t x) { return __byte_perm(x, 0u, 0x0123); }

// Little-endian words of counter block c + t (56-bit big-endian add over
// bytes 9..15; byte 8 and the carry out of byte 9 are untouched).
__device__ __forceinline__ void ctr_words(const uint4 c, uint32_t t, uint32_t (&o)[4]) {
  const uint32_t t3 = bswap32(c.w);
  const uint32_t v3 = t3 + t;
  const uint32_t t2 = bswap32(c.z);
  const uint32_t hi = (t2 + (v3 < t3 ? 1u : 0u)) & 0x00FFFFFFu;
  o[0] = c.x;
  o[1] = c.y;
  o[2] = bswap32((t2 & 0xFF000000u) | hi);
  o[3] = bswap32(v3);
}

__global__ void __launch_bounds__(kCipherThreads)
chain_cipher_kernel(const uint32_t* __restrict__ kpw, const uint4* __restrict__ c0,
                    const uint4* __restrict__ in, uint4* __restrict__ out,
                    int rounds, int w, int nb) {
  const long long g = static_cast<long long>(blockIdx.x) * kCipherThreads + threadIdx.x;
  if (g >= static_cast<long long>(w) * nb) return;
  const int col = static_cast<int>(g / nb);
  const uint32_t t = static_cast<uint32_t>(g % nb);

  uint32_t s[8][16];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t a[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      uint32_t o[4];
      ctr_words(__ldg(c0 + 32 * col + j), t, o);
      a[j] = o[k];
    }
    uaes::transpose32(a);  // a[r] = plane of bit r of word k
#pragma unroll
    for (int r = 0; r < 32; ++r) s[r % 8][4 * k + r / 8] = a[r];
  }

  uaes::encrypt_with(s, uaes::LaneKeyPlanes{kpw, w, col}, rounds);

  // back to words: keystream word k of lane j goes to slot (j % 8, 4k + j / 8)
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t a[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) a[r] = s[r % 8][4 * k + r / 8];
    uaes::transpose32(a);
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j % 8][4 * k + j / 8] = a[j];
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const size_t idx = static_cast<size_t>(32 * col + j) * nb + t;
    uint4 x = __ldg(in + idx);
    x.x ^= s[j % 8][j / 8];
    x.y ^= s[j % 8][4 + j / 8];
    x.z ^= s[j % 8][8 + j / 8];
    x.w ^= s[j % 8][12 + j / 8];
    out[idx] = x;
  }
}

__device__ __forceinline__ void be_words(const uint4 v, uint32_t (&o)[4]) {
  o[0] = bswap32(v.x);
  o[1] = bswap32(v.y);
  o[2] = bswap32(v.z);
  o[3] = bswap32(v.w);
}

// z = x * h in GF(2^128), GHASH bit order (bit i = byte i/8, MSB first);
// x, h, z as big-endian words (word 0 = bytes 0..3).  z = XOR_i bit_i(x) *
// halve^i(h), where halving is a 128-bit right shift with the reduction
// 0xE1 into byte 0 when the dropped bit was set (micro_aes.c:464-493).
__device__ __forceinline__ void gf_mul(const uint32_t (&x)[4], const uint32_t (&h)[4],
                                       uint32_t (&z)[4]) {
  uint32_t v0 = h[0], v1 = h[1], v2 = h[2], v3 = h[3];
  z[0] = z[1] = z[2] = z[3] = 0u;
#pragma unroll
  for (int i = 0; i < 128; ++i) {
    const uint32_t m = static_cast<uint32_t>(static_cast<int32_t>(x[i >> 5] << (i & 31)) >> 31);
    z[0] ^= v0 & m;
    z[1] ^= v1 & m;
    z[2] ^= v2 & m;
    z[3] ^= v3 & m;
    const uint32_t red = 0xE1000000u & (0u - (v3 & 1u));
    v3 = __funnelshift_r(v3, v2, 1);
    v2 = __funnelshift_r(v2, v1, 1);
    v1 = __funnelshift_r(v1, v0, 1);
    v0 = (v0 >> 1) ^ red;
  }
}

__device__ __forceinline__ uint32_t lane_mask(const uint32_t* __restrict__ m, size_t idx, int j) {
  return 0u - ((__ldg(m + idx) >> j) & 1u);
}

__global__ void __launch_bounds__(kFoldThreads)
chain_fold_kernel(const uint32_t* __restrict__ htab, const uint4* __restrict__ init,
                  const uint4* __restrict__ src, const uint32_t* __restrict__ masks,
                  const uint32_t* __restrict__ lastm, const uint32_t* __restrict__ srcm,
                  const uint32_t* __restrict__ initm, const uint4* __restrict__ tail,
                  const uint4* __restrict__ initadd, uint4* __restrict__ g_out, int b, int nb) {
  const int lane = blockIdx.x * kFoldThreads + threadIdx.x;
  if (lane >= b) return;
  const int w = b / 32, col = lane >> 5, j = lane & 31;
  uint32_t h[4], g[4], tl[4], ia[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = bswap32(__ldg(htab + static_cast<size_t>(k * 32 + j) * w + col));
  be_words(__ldg(init + lane), g);
  be_words(__ldg(tail + lane), tl);
  be_words(__ldg(initadd + lane), ia);

#pragma unroll 1
  for (int t = 0; t < nb; ++t) {
    const size_t mi = static_cast<size_t>(t) * w + col;
    const uint32_t keep = lane_mask(masks, mi, j);
    const uint32_t last = lane_mask(lastm, mi, j);
    const uint32_t use = lane_mask(srcm, mi, j);
    const uint32_t inj = lane_mask(initm, mi, j);
    uint32_t x[4], v[4], p[4];
    be_words(__ldg(src + static_cast<size_t>(lane) * nb + t), x);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t m = x[k] ^ (last & (x[k] ^ (x[k] & tl[k])));
      v[k] = g[k] ^ (m & use) ^ (inj & ia[k]);
    }
    gf_mul(v, h, p);
#pragma unroll
    for (int k = 0; k < 4; ++k) g[k] ^= keep & (p[k] ^ g[k]);
  }
  g_out[lane] = make_uint4(bswap32(g[0]), bswap32(g[1]), bswap32(g[2]), bswap32(g[3]));
}

}  // namespace

extern "C" int micro_aes_gcm_chain(const uint32_t* kpw, const uint32_t* htab, const uint8_t* c0,
                                   const uint8_t* init, const uint8_t* blocks,
                                   const uint32_t* masks, const uint32_t* lastm,
                                   const uint32_t* srcm, const uint32_t* initm,
                                   const uint8_t* tail, const uint8_t* initadd, uint8_t* out,
                                   uint8_t* g, int rounds, int b, int nb, int decrypt,
                                   cudaStream_t stream) {
  const int w = b / 32;
  const long long cipher_threads = static_cast<long long>(w) * nb;
  if (cipher_threads > 0) {
    const int grid = static_cast<int>((cipher_threads + kCipherThreads - 1) / kCipherThreads);
    chain_cipher_kernel<<<grid, kCipherThreads, 0, stream>>>(
        kpw, reinterpret_cast<const uint4*>(c0), reinterpret_cast<const uint4*>(blocks),
        reinterpret_cast<uint4*>(out), rounds, w, nb);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const uint8_t* src = decrypt ? blocks : out;  // GCM folds the ciphertext
  chain_fold_kernel<<<(b + kFoldThreads - 1) / kFoldThreads, kFoldThreads, 0, stream>>>(
      htab, reinterpret_cast<const uint4*>(init), reinterpret_cast<const uint4*>(src), masks,
      lastm, srcm, initm, reinterpret_cast<const uint4*>(tail),
      reinterpret_cast<const uint4*>(initadd), reinterpret_cast<uint4*>(g), b, nb);
  return static_cast<int>(cudaGetLastError());
}
