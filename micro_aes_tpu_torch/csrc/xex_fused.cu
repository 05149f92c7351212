// The single-key cipher-and-xor and the two XEX forms, on the w-major
// stream:
//   K8  out = C_K(blocks) ^ xor, blocks and xor two caller-supplied streams;
//       replaces micro_aes_tpu/ops/pallas_seal.py:ctrw_fused (_ctrw_kernel);
//   K6  XTS: out = off ^ C_K(in ^ off), off = base * alpha^jj for block jj
//       of a row, expanded in the kernel from a base per block; replaces
//       pallas_seal.py:xex_fused (_xex_kernel, _alpha_pow_grid, _xex_expand);
//   K7  OCB: out = D_i ^ C_K(in ^ D_i), D_i = D_0 ^ XOR of L_b over the set
//       bits b of gray(i), i = 32 * row + jj + 1; replaces
//       pallas_seal.py:ocb_fused (_ocb_kernel, _ocb_offsets).
// C_K is the encryption, or the decryption when `decrypt` is set (the open
// direction of XTS and OCB).
//
// Contracts (ops/xex_kernels.py): kp uint32[(R+1)*128, 1] key planes;
// streams uint32[W, 128] (lane 4j+k = little-endian word k of block 32w+j);
// K6 base uint32[W, 128] (lane 4j+k = word k of block j's base, every lane
// its own); K7 d0l uint32[1, 128], lbl uint32[>= nbits, 128] (lane 4j+k is
// word k of D_0 or L_b for block j: the bulk engine replicates them, every
// lane counts on its own), nbits <= 32.
//
// K8 is K3's body (aes_bitslice.cuh ctr_xor_body) with the caller's blocks
// for counters (RowBlocks): each thread reads its own row of the blocks
// stream from device memory (16-byte loads that L1 serves to the thread's
// next loads) and turns it into planes, while the block's first thread
// copies the block's rows of the xor stream into shared memory by TMA (a
// cp.async.bulk a row, on an mbarrier) under the cipher; after the cipher
// the output planes become words in place and go onto the staged rows in
// the word domain (xor_words_into_row), and the block stores its rows
// coalesced.  The inverse cipher is the body's DECRYPT form.  Its first
// design was the XEX body below with the xor stream as the slot, staged
// before the cipher, so that every block of the one wave waited on its 64
// KiB before its first round: 0.1022-0.1033 ms at 16 MiB AES-256 (decrypt
// 0.1097-0.1120), 1.4x K3 (H100 80GB HBM3, 700 W; PERF.md).  Staging the
// blocks stream coalesced by TMA before the cipher, each thread taking its
// row from shared memory and the xor rows copied into the same area under
// the cipher on the mbarrier's next phase, is tools/k8_k4t_ab.py probe's
// other form (PERF.md keeps both forms' times).
//
// K6 and K7 share one XEX body with ONE row buffer per thread (the "slot"):
// a generator fills the slot with the words XORed after the cipher (K6: the
// staged base row, each block jj multiplied by alpha^jj in place in the
// word domain, one funnel shift and a 0x87 fold of the jj bits that fall
// out, ~15 instructions a block; K7: the block's table of offsets, below).
// Each thread then reads its own input row from device memory, XORs the
// slot in, turns the row into planes, runs the cipher, and XORs the output
// words into the slot, which the block writes back coalesced.  One buffer
// of 128 rows per block lets two blocks share an SM at 255 registers, so
// the 16 MiB stream (32,768 rows) runs in one wave on 132 SMs.
//
// K7's table.  gray is linear over XOR, and a block's first row w0 is a
// multiple of 128, so for row w0 + t (t < 128) and block j <= 30 the index
// 32 (w0 + t) + j + 1 is 32 w0 ^ 32 t ^ (j + 1), and the offset is
// D(32 w0 + j + 1) ^ Q(t), Q(t) the XOR over the set bits c of t of
// M_c = L_{c+4} ^ L_{c+5} (gray(32 * 2^c) = 2^(c+5) + 2^(c+4); L_b = 0 for
// b >= nbits).  Block 31 of row t has index 32 (w0 + t + 1): D(32 w0) ^
// Q(t + 1) for t < 127, and D(32 (w0 + 128)) for t = 127.  Thread l owns
// lane l of every slot: it makes its start words (an nbits gray select of
// its lane of L_b) and then walks t in gray order, one XOR of an M_c and
// one store a slot, 127 steps at constant offsets; the lanes of block 31
// store each value one slot up.  Its first design ran, for each of a row's
// 32 blocks, a loop over the nbits bits of gray(i): 21 passes of 12-13
// instructions at 16 MiB, ~8,500 instructions a row, 1.27x K3's count.
// Issuing the row's input loads before the table, so that their latency
// overlaps it, ran 4 % slower and spilled 104 B (tools/k7_k4_ab.py sass
// and probe; PERF.md).
//
// K6's first design made its offsets in the plane domain: the base row
// turned into planes (4 transposes), five masked alpha^(2^b) stages over
// all 128 planes, and 4 transposes back, ~4,800 SASS instructions a row,
// 1.28x K8's first design's time at 16 MiB (H100 80GB HBM3, 700 W).  On
// that card, staging the input row coalesced through the slot (as K3
// stages its rows) made K8's first design 4-8 % slower, and K6 with its
// base and input both staged (offsets held in registers in between)
// spilled 100 B and ran 9 % slower than this form (tools/k6_k5o_ab.py
// probe; PERF.md).
//
// What bounds them on the card: integer ALU throughput and registers, as for K3
// (ctr_fused.cu): each stream byte is read and written once against ~70
// logic operations per byte (AES-256), plus K8's input transposes, K6's
// offsets and input XOR (~740 SASS instructions a row) or K7's table (a
// few hundred a row) and input XOR.  One thread owns one stream row and its
// 128 planes in registers.
// ptxas (sm_90a): chip_smoke.py's build phase prints each kernel's registers
// and spills; PERF.md keeps them.
#include <cuda_runtime.h>

#include "aes_bitslice.cuh"

namespace {

constexpr int kRows = 128;  // stream rows (threads) per block, one row each

// block * alpha^jj (1 <= jj <= 31) in place, on the block's little-endian
// words v[0..3] (micro_aes.c:449-458's doubling, jj times): one funnel shift
// of the 128-bit value by jj, and the jj bits that fall out of word 3 folded
// back with x^128 = x^7 + x^2 + x + 1.  The fold, ov ^ ov<<1 ^ ov<<2 ^ ov<<7,
// is under 2^38, so it lands in words 0 and 1 and needs no second reduction
// (its bits past 32: ov >> 30 and ov >> 25; ov >> 31 is always 0).
__device__ __forceinline__ void alpha_pow(uint32_t* v, int jj) {
  const uint32_t ov = v[3] >> (32 - jj);
  v[3] = __funnelshift_l(v[2], v[3], jj);
  v[2] = __funnelshift_l(v[1], v[2], jj);
  v[1] = __funnelshift_l(v[0], v[1], jj) ^ (ov >> 30) ^ (ov >> 25);
  v[0] = (v[0] << jj) ^ ov ^ (ov << 1) ^ (ov << 2) ^ (ov << 7);
}

// K6: the slot holds the row's bases, then, in place, their offsets (words):
// block jj's base times alpha^jj, jj a constant of the unrolled loop; block 0
// keeps its base.
struct AlphaOffsets {
  const uint32_t* base_words;
  __device__ void stage(uint32_t* slots, int w0, int w) const {
    uaes::stage_rows_in(base_words, slots, w0, kRows, w);
  }
  __device__ void make(uint32_t* slot) const {
#pragma unroll
    for (int jj = 1; jj < 32; ++jj) alpha_pow(slot + 4 * jj, jj);
  }
};

// K7: the block's 128 slots hold its rows' offset words, made before the
// barrier (K7's table, at the top): thread l makes lane l of every slot.
struct GrayOffsets {
  static_assert(kRows == 128, "a thread per lane; t runs over 7 bits");
  const uint32_t* d0l;
  const uint32_t* lbl;
  int nbits;
  __device__ void stage(uint32_t* slots, int w0, int) const {
    const int l = threadIdx.x;
    const bool last = l >= 124;  // a word of block 31
    // the walk's start, block l / 4 of row w0 (block 31: of row w0 - 1), and
    // block 31 of row w0 + 127; indices mod 2^32
    const uint32_t i0 = 32u * static_cast<uint32_t>(w0) + (last ? 0u : l / 4 + 1u);
    const uint32_t i1 = 32u * static_cast<uint32_t>(w0 + kRows);
    const uint32_t g0 = i0 ^ (i0 >> 1), g1 = i1 ^ (i1 >> 1);
    uint32_t v0 = __ldg(d0l + l), v1 = v0, lb[8];
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const uint32_t x = b < nbits ? __ldg(lbl + b * 128 + l) : 0u;
      v0 ^= (0u - ((g0 >> b) & 1u)) & x;
      v1 ^= (0u - ((g1 >> b) & 1u)) & x;
      if (b >= 4 && b < 12) lb[b - 4] = x;
    }
    uint32_t m[7];  // M_c = L_{c+4} ^ L_{c+5}, the step of bit c of t
#pragma unroll
    for (int c = 0; c < 7; ++c) m[c] = lb[c] ^ lb[c + 1];
    const int col = l - (last ? uaes::kStageStride : 0);  // block 31 one slot up
    slots[(last ? (kRows - 1) * uaes::kStageStride : 0) + l] = last ? v1 : v0;
    uint32_t v = v0;
#pragma unroll
    for (int t = 1; t < kRows; ++t) {  // slot t ^ (t >> 1): its bit __ffs(t) - 1 flips
      v ^= m[__ffs(t) - 1];
      slots[col + (t ^ (t >> 1)) * uaes::kStageStride] = v;
    }
  }
  __device__ void make(uint32_t*) const {}
};

// The planes of input row `row` read straight from device memory (16 bytes
// per block), XORed with the slot's words when PRE_XOR is set.
template <bool PRE_XOR>
__device__ __forceinline__ void load_row_planes(uint32_t (&s)[8][16], const uint32_t* __restrict__ in,
                                                const uint32_t* slot, int row, bool live) {
  uint32_t a[4][32];
  const uint4* src = reinterpret_cast<const uint4*>(in) + static_cast<size_t>(row) * 32;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const uint4 v = live ? __ldg(src + j) : make_uint4(0u, 0u, 0u, 0u);
    a[0][j] = v.x;
    a[1][j] = v.y;
    a[2][j] = v.z;
    a[3][j] = v.w;
    if (PRE_XOR) {
#pragma unroll
      for (int k = 0; k < 4; ++k) a[k][j] ^= slot[4 * j + k];
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uaes::transpose32(a[k]);  // a[k][r] = plane of bit r of word k
#pragma unroll
    for (int r = 0; r < 32; ++r) s[r % 8][4 * k + r / 8] = a[k][r];
  }
}

// K8's counters, as a policy of ctr_xor_body: the planes of row `row` of the
// caller's blocks stream, read per thread (no per-call state to stage).
struct RowBlocks {
  const uint32_t* blocks;
  __device__ __forceinline__ void stage(uint32_t*) const {}
  __device__ __forceinline__ void planes(uint32_t (&s)[8][16], const uint32_t*, int row,
                                         bool live) const {
    load_row_planes<false>(s, blocks, nullptr, row, live);
  }
};

template <bool DECRYPT>
__global__ void __launch_bounds__(kRows)
ctrw_fused_kernel(const uint32_t* __restrict__ kp, const uint32_t* __restrict__ blocks,
                  const uint32_t* __restrict__ xor_words, uint32_t* __restrict__ out, int rounds,
                  int w) {
  extern __shared__ uint32_t smem[];
  uaes::ctr_xor_body<kRows, uaes::StreamForm::kRows, DECRYPT>(smem, RowBlocks{blocks}, kp,
                                                              xor_words, out, rounds, w);
}

template <class Gen, bool DECRYPT>
__global__ void __launch_bounds__(kRows)
xex_body_kernel(Gen gen, const uint32_t* __restrict__ kp, const uint32_t* __restrict__ in,
                uint32_t* __restrict__ out, int rounds, int w) {
  extern __shared__ uint32_t smem[];
  uint32_t* kps = smem;
  uint32_t* slots = kps + uaes::kMaxKeyPlaneWords;

  const int w0 = blockIdx.x * kRows;
  uaes::copy_to_smem(kp, kps, (rounds + 1) * 128);
  gen.stage(slots, w0, w);
  __syncthreads();

  const int row = w0 + threadIdx.x;
  uint32_t* slot = slots + threadIdx.x * uaes::kStageStride;
  gen.make(slot);
  uint32_t s[8][16];
  load_row_planes<true>(s, in, slot, row, row < w);
  if (DECRYPT) {
    uaes::decrypt_state(s, kps, rounds);
  } else {
    uaes::encrypt_state(s, kps, rounds);
  }
  uaes::xor_planes_into_row(s, slot);
  __syncthreads();
  uaes::stage_rows_out(slots, out, w0, kRows, w);
}

template <class Gen>
int launch_xex(const Gen& gen, const uint32_t* kp, const uint32_t* in, uint32_t* out, int rounds,
               int w, int decrypt, cudaStream_t stream) {
  return uaes::launch_rows(decrypt ? xex_body_kernel<Gen, true> : xex_body_kernel<Gen, false>,
                           kRows, uaes::kMaxKeyPlaneWords + kRows * uaes::kStageStride, w, stream,
                           gen, kp, in, out, rounds, w);
}

}  // namespace

extern "C" int micro_aes_ctrw_fused(const uint32_t* kp, const uint32_t* ctr, const uint32_t* pt,
                                    uint32_t* out, int rounds, int w, int decrypt,
                                    cudaStream_t stream) {
  return uaes::launch_rows(decrypt ? ctrw_fused_kernel<true> : ctrw_fused_kernel<false>, kRows,
                           uaes::ctr_xor_smem_words(kRows), w, stream, kp, ctr, pt, out, rounds,
                           w);
}

extern "C" int micro_aes_xex_fused(const uint32_t* kp, const uint32_t* base, const uint32_t* pt,
                                   uint32_t* out, int rounds, int w, int decrypt,
                                   cudaStream_t stream) {
  return launch_xex(AlphaOffsets{base}, kp, pt, out, rounds, w, decrypt, stream);
}

extern "C" int micro_aes_ocb_fused(const uint32_t* kp, const uint32_t* d0l, const uint32_t* lbl,
                                   const uint32_t* pt, uint32_t* out, int nbits, int rounds,
                                   int w, int decrypt, cudaStream_t stream) {
  return launch_xex(GrayOffsets{d0l, lbl, nbits}, kp, pt, out, rounds, w, decrypt, stream);
}
