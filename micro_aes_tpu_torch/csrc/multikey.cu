// K9: the multi-key block cipher, a key per message: out = E_k(in) (or
// D_k(in)) for every 32-block row, k the key of the row's message, and
// optionally out ^= x (the JAX package's cipher-and-xor contract).
//
// Replaces micro_aes_tpu/ops/pallas_multikey.py:ctrw_fused_multikey
// (_mk_kernel, on a (message, tile) grid whose key block follows the
// message index).
//
// Contract (ops/multikey.py): rks uint8[*, 16] round keys, one 16-byte row
// per round (a message's R+1 rows consecutive); in, x and out uint8[N, 16]
// blocks (16-byte aligned).  Each row of 32 blocks has a descriptor int32[4]
// = (krow, rounds, first, valid): its message's round keys start at row
// krow of rks, its blocks are first .. first + valid - 1 (valid <= 32) of
// in, x and out, and blocks past valid are neither read nor written.  The
// ragged entry takes the descriptors from memory (ops/multikey.
// multikey_layout: rows sorted by rounds, each rounds group padded to whole
// warps, so a warp runs one round count); the uniform entry computes them
// from (B, Wm, R): row w under message w / Wm, blocks 32w .. 32w + 31 (the
// w-major stream of the JAX contract, whose row w is bytes 512w .. 512w +
// 511 of the blocks).  x is null on the batch paths (cipher only).
//
// What bounds it on the card: integer ALU issue, as in K2/K3.  One thread
// owns one row: it loads its 32 blocks with 32 16-byte loads in flight and
// transposes them into 128 plane words in registers (the first design
// staged the counter rows and then the data rows through shared memory,
// each thread waiting on one load at a time), runs the bitsliced cipher,
// and stores the row the same way.
//
// The round keys: counted on an H100 (tools/mk_ab.py sass, PERF.md), the
// first design's round was 2,173 instructions against K3's 1,878, whose
// broadcast key planes come from shared memory: each thread expanded its
// own round key into 128 plane words (a shift and a LOP3 or move per word,
// ~300 instructions a round).  Here each lane flips its plane words by its
// own round key with a predicated NOT per word, which ran faster than the
// shift-and-mask form on an H100.  Staging the planes of a warp's messages
// in shared memory as K3 does was 3-5 % faster only where a warp holds at
// most two messages (8 KiB and longer), and slower on a ragged mix of
// shorter ones (PERF.md).
// No address depends on key or data.  Every row is checked against the
// buffers, so a bad descriptor skips its row.
#include <cuda_runtime.h>

#include "aes_bitslice.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kRows = 128;   // rows (threads) per block

struct Args {
  const uint8_t* rks;   // round-key rows, 16 bytes each
  const int4* desc;     // ragged: (krow, rounds, first, valid) per row; null: uniform
  const uint4* in;      // the cipher's input blocks
  const uint4* x;       // XORed onto the output (null: the cipher alone)
  uint4* out;
  int rounds, wm, w;    // uniform: R and rows per message; w rows
  int krows, nblocks;   // rows of rks; blocks of in, x and out
};

__device__ __forceinline__ uint32_t& word(uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

struct Row {
  int krow, rounds, first, valid;
};

__device__ __forceinline__ Row row_of(const Args& a, int row) {
  if (a.desc != nullptr) {
    const int4 d = __ldg(a.desc + row);
    return {d.x, d.y, d.z, d.w};
  }
  return {(row / a.wm) * (a.rounds + 1), a.rounds, 32 * row, 32};
}

// One lane's own round keys in device memory (the Key interface of
// aes_bitslice.cuh), each plane word flipped where its key bit is set: a
// test into a predicate and a predicated NOT per word.
struct LaneRoundKeys {
  const uint8_t* rk;
  __device__ __forceinline__ void add(uint32_t (&s)[8][16], int r) const {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(rk) + r);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int b = 0; b < 8; ++b)
#pragma unroll
      for (int p = 0; p < 16; ++p)
        asm("{ .reg .pred q; setp.ne.u32 q, %1, 0; @q not.b32 %0, %0; }"
            : "+r"(s[b][p]) : "r"(w[p >> 2] & (1u << (8 * (p & 3) + b))));
  }
};

// The planes of a row's blocks (block j at in[j] while j < valid, zero
// after), with the 32 loads in flight before the transposes.
__device__ __forceinline__ void load_planes(uint32_t (&s)[8][16], const uint4* __restrict__ in,
                                            int valid) {
  uint4 v[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) v[j] = j < valid ? __ldg(in + j) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t a[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) a[j] = word(v[j], k);
    uaes::transpose32(a);  // a[r] = plane of bit r of word k
#pragma unroll
    for (int r = 0; r < 32; ++r) s[r % 8][4 * k + r / 8] = a[r];
  }
}

// The inverse: the planes back into blocks, XORed with x (if any), stored
// while j < valid.
__device__ __forceinline__ void store_planes(const uint32_t (&s)[8][16],
                                             const uint4* __restrict__ x,
                                             uint4* __restrict__ out, int valid) {
  uint4 v[32];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t a[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) a[r] = s[r % 8][4 * k + r / 8];
    uaes::transpose32(a);  // a[j] = word k of block j
#pragma unroll
    for (int j = 0; j < 32; ++j) word(v[j], k) = a[j];
  }
  if (x != nullptr) {
#pragma unroll
    for (int j0 = 0; j0 < 32; j0 += 8) {  // eight loads in flight at a time
      uint4 y[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        y[j] = j0 + j < valid ? __ldg(x + j0 + j) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j0 + j].x ^= y[j].x;
        v[j0 + j].y ^= y[j].y;
        v[j0 + j].z ^= y[j].z;
        v[j0 + j].w ^= y[j].w;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 32; ++j)
    if (j < valid) out[j] = v[j];
}

template <bool DECRYPT, class Key>
__device__ __forceinline__ void cipher(uint32_t (&s)[8][16], const Key& key, int rounds) {
  if (DECRYPT) {
    uaes::decrypt_with(s, key, rounds);
  } else {
    uaes::encrypt_with(s, key, rounds);
  }
}

template <bool DECRYPT>
__global__ void __launch_bounds__(kRows) multikey_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRows + threadIdx.x;
  if (row - lane >= a.w) return;  // a whole idle warp
  // A warp runs its first row's rounds.  A lane past the last row, or whose
  // row disagrees or points outside rks or the blocks, is idle: it runs the
  // first row's key and stores nothing.
  Row d = row_of(a, row < a.w ? row : a.w - 1);
  const int rounds = __shfl_sync(kFull, d.rounds, 0);
  const int krow0 = __shfl_sync(kFull, d.krow, 0);
  if ((rounds != 10 && rounds != 12 && rounds != 14) || krow0 < 0 || krow0 + rounds >= a.krows)
    return;  // the same in every lane of the warp
  if (row >= a.w || d.rounds != rounds || d.krow < 0 || d.krow + rounds >= a.krows ||
      d.valid < 0 || d.valid > 32 || d.first < 0 || d.first > a.nblocks - d.valid) {
    d.krow = krow0;
    d.valid = 0;
  }

  uint32_t s[8][16];
  load_planes(s, a.in + d.first, d.valid);
  cipher<DECRYPT>(s, LaneRoundKeys{a.rks + 16 * static_cast<size_t>(d.krow)}, rounds);
  store_planes(s, a.x == nullptr ? nullptr : a.x + d.first, a.out + d.first, d.valid);
}

int launch(const Args& a, int decrypt, cudaStream_t stream) {
  auto kernel = decrypt ? multikey_kernel<true> : multikey_kernel<false>;
  kernel<<<(a.w + kRows - 1) / kRows, kRows, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// The uniform entry: B*Wm rows of the w-major streams, message w / Wm under
// R = rounds; out = x ^ E(in) (D when decrypt), or E(in) when x is null.
extern "C" int micro_aes_multikey(const uint8_t* rks, const uint4* in, const uint4* x,
                                  uint4* out, int rounds, int wm, int w, int decrypt,
                                  cudaStream_t stream) {
  if (wm <= 0 || w % wm || !aligned16(in) || !aligned16(x) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{rks, nullptr, in, x, out, rounds, wm, w, w / wm * (rounds + 1), 32 * w};
  return launch(a, decrypt, stream);
}

// The ragged entry: w rows under the descriptors `desc` (w a multiple of
// 32), krows round-key rows, nblocks blocks of in and out.  Rows that point
// outside them are skipped (see the kernel).
extern "C" int micro_aes_multikey_ragged(const uint8_t* rks, const int4* desc, const uint4* in,
                                         uint4* out, int w, int krows, int nblocks, int decrypt,
                                         cudaStream_t stream) {
  if (w % 32 || !aligned16(desc) || !aligned16(in) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{rks, desc, in, nullptr, out, 0, 1, w, krows, nblocks};
  return launch(a, decrypt, stream);
}
