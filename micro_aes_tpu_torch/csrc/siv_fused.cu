// The GCM-SIV bulk kernels on the w-major stream (K4t and K5t on the
// transposed one):
//   K4      level-1 GHASH/POLYVAL partials of a stream, no cipher (the seal's
//           POLYVAL pass); replaces micro_aes_tpu/ops/pallas_seal.py:
//           ghash1_fused (_ghash_kernel);
//   K4t     K4 on the transposed stream [128, W], read in place; replaces
//           pallas_seal.py:ghash1_fused_t (_ghash_kernel_t);
//   K5      GCM-SIV CTR: in-kernel LE32 counters from the tag base -> bitsliced
//           AES -> keystream XOR onto the stream (the seal's second pass);
//           replaces pallas_seal.py:siv_ctrw_fused (_siv_ctr_kernel);
//   K5t     K5 on the transposed stream [128, W], read and written in place;
//           replaces pallas_seal.py:siv_ctrw_fused_t (_siv_ctr_kernel_t);
//   K5-open K5, then the level-1 POLYVAL partials of its output (the
//           recovered plaintext): the whole open in one pass; replaces
//           pallas_seal.py:siv_open_fused (_siv_open_kernel).
//
// Contracts (ops/siv_kernels.py): kp uint32[(R+1)*128, 1] key planes,
// basew uint32[1, 128] (lane 4j+k = counter base word k for block j of a
// row), ghmask uint32[1, W], W1p uint32[128, 128] (ghash_bulk.pack_level1),
// stream uint32[W, 128] (K4t and K5t: uint32[128, W]) -> out shaped as the
// stream and/or s1 int8[128, W].
//
// Counters: block j of stream row r has the words (basew[4j] + 32r + j,
// basew[4j+1], basew[4j+2], basew[4j+3]).  Only word 0 counts, and uint32_t
// addition wraps mod 2^32 with no carry into word 1, which is GCM-SIV's
// LE32 rule (the JAX _siv_ctr_tile in the word domain).  Only the term 32r
// changes from row to row, so a block turns the base into planes once
// (SivCounters::stage: 4 transposes, basew[4j] + j for word 0) and each
// row adds 32r to word 0's 32 planes as a bitsliced add, a sum and a
// majority LOP3 for each of bits 5-31 (SivCounters::planes).  The lanes
// are independent: any basew is right, not only the lane-replicated base
// the bulk engine passes.  The first design built each row's 32 counter
// blocks in the word domain and turned them into planes, 4 transposes a
// row.
//
// K5 is K3's body (aes_bitslice.cuh ctr_xor_body) with these counters: its
// input rows copied into shared memory by TMA under the cipher, and the
// keystream XORed on in the word domain (4 transposes a row, where the
// first design turned the input into planes and back, 8).
//
// K5t is the same body in its kColumns form: after the cipher each thread
// reads its row of the transposed stream straight from device memory and
// writes it straight back, a warp's 32 rows one coalesced 128-byte access a
// lane, 32 loads in flight a thread; no stage area, 8 KiB of shared memory
// a block.  Its first design was K5 between two torch transposes at the
// wrapper (0.1349-0.1355 ms at 16 MiB AES-256 against K5's 0.069); a TMA
// copy of the block's tile under the cipher, one cp.async.bulk a lane, ran
// no faster than the loads (PERF.md).
//
// K5-open is K1's body (aes_bitslice.cuh ctr_level1_body, seal direction:
// level 1 over the output planes) with these counters: 256 rows a block,
// one block per SM, W1p staged at kL1Stride and level 1 on the binary
// tensor cores (level1_mma_warp, mma.sync m16n8k256 .b1 .and.popc) after
// the stream is out.  Its first design ran level 1 as a fold on the integer
// units (level1_row), 16,384 logic operations and 4,096 LDS.128 of W1p a
// row (54,700 SASS instructions a row against 32,000 now), 0.159 ms at 16
// MiB AES-256 against 0.103 ms now (H100 80GB HBM3, 700 W; PERF.md).
//
// K4 runs level 1 on the same tensor-core product in the word domain.
// Plane (b, p) bit j is bit r of word k of block j, with b = r % 8 and
// p = 4k + r / 8, so the row's own words, word 4j+k with block j masked
// whole by bit j of ghm, are a B operand when W1p's rows are permuted the
// same way: W1w[o][4j+k] bit r = W1p[o][16 (r%8) + 4k + r/8] bit j, one
// 32x32 transpose per (o, k), made by each block in shared memory (two a
// thread).  The block's 256 rows go from device memory to the B operand
// masked, with no transposes and no planes in registers.  Its first design
// turned each row into planes (4 transposes) and ran level1_row, ~0.046 of
// its 0.070-0.076 ms at 16 MiB (PERF.md).
//
// K4t is the same kernel with the B operand filled from the transposed
// stream (ghash1_body in its StreamForm::kColumns form): thread t owns row
// w = w0 + t and reads its 128 words x_t[l W + w], l = 0..127, a warp's 32
// rows one coalesced 128-byte access a lane, in four batches of 32 loads in
// flight (lanes 32c..32c+31, blocks 8c..8c+7), masks lane l whole by bit
// l >> 2 of ghm[w] and stores its row as 32 STS.128 at rows + t kL1Stride:
// with kL1Stride = 132 the 8 threads of a quarter-warp start 4 banks apart
// and cover all 32 banks (tools/k8_k4t_ab.py probe times these stores
// against a pattern known to be free of conflicts).  Word l of B row t is
// then word
// k of block j (l = 4j + k) of row w, the word K4 puts there from the
// w-major row, so W1p is permuted as for K4 and level 1 is K4's, parity
// stores included.  Its first design was K4 behind one torch transpose of
// the 16 MiB stream at the wrapper, 0.0467-0.0468 ms of device time against
// K4's 0.0145 (PERF.md).
//
// What bounds them on the card: integer ALU issue and registers for K5 and
// K5-open, as for K1 (seal_fused.cu) and K3 (ctr_fused.cu): K5 is K3 with
// a 27-bit bitsliced add a row for its counters, K5-open is the cipher,
// the plane-domain XOR (8 transposes a row, since level 1 needs the
// stream's planes), level 1's staging and ~4,100 shared-memory fragment
// loads per warp.  K4 and K4t move 644 bytes a row against 2 x 128 x 4,096
// tensor-core operations, its W1 permutation and the parity stores: the
// tensor cores and the memory system, one block of 256 rows per SM.  K5
// and K5-open own one stream row and its 128 planes in registers a thread;
// K5's block of 128 rows stages them at kL1Stride (74 KiB, two blocks an
// SM), K5-open's of 256 at kStageStride and then kL1Stride beside W1p (one
// block an SM).  K5 and K5-open sit at the 255-register cap: ptxas
// (sm_90a) K5-open 36 B of spill stores (160 B in its first design, which
// held level1_row's table walk beside the planes); chip_smoke.py's build
// phase prints every kernel's registers and spills, and PERF.md keeps
// them.
#include <cuda_runtime.h>

#include "aes_bitslice.cuh"

namespace {

constexpr int kGhashRows = 256;  // K4 rows (threads) per block
constexpr int kGhashSmemWords = (128 + kGhashRows) * uaes::kL1Stride;  // W1w and B: 198 KiB

constexpr int kCtrRows = 128;   // K5 rows (threads) per block, as K3
constexpr int kOpenRows = 256;  // K5-open rows per block, as K1: one block per SM

// K4 and K4t (see the note at the top): the stream rows go to the MMA's B
// operand as they are, and W1p's rows are permuted to match them.  FORM says
// where the rows come from: kRows the w-major stream x [W, 128], kColumns
// the transposed one [128, W].
template <uaes::StreamForm FORM>
__device__ __forceinline__ void ghash1_body(uint32_t* smem, const uint32_t* __restrict__ ghmask,
                                            const uint32_t* __restrict__ w1p,
                                            const uint32_t* __restrict__ x,
                                            int8_t* __restrict__ s1, int w) {
  uint32_t* w1s = smem;                           // W1w, rows kL1Stride apart
  uint32_t* rows = w1s + 128 * uaes::kL1Stride;   // B: the masked rows, kL1Stride apart

  const int w0 = blockIdx.x * kGhashRows;
  if constexpr (FORM == uaes::StreamForm::kRows) {
    const uint4* x4 = reinterpret_cast<const uint4*>(x);
    // the block's rows, a warp's 32 lanes on one row's 32 blocks (512 bytes);
    // block j counts whole when bit j of its row's mask is set; dead rows are 0
#pragma unroll
    for (int n = 0; n < 32; ++n) {
      const int i = n * kGhashRows + threadIdx.x;
      const int r = i >> 5, j = i & 31, gw = w0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gw < w) {
        const uint32_t m = 0u - ((__ldg(ghmask + gw) >> j) & 1u);
        v = __ldg(x4 + static_cast<size_t>(gw) * 32 + j);
        v = make_uint4(v.x & m, v.y & m, v.z & m, v.w & m);
      }
      reinterpret_cast<uint4*>(rows + r * uaes::kL1Stride)[j] = v;
    }
  } else {
    // this thread's row w of the transposed stream, lane l at l*W + w, 32
    // loads in flight a batch; lane l counts whole when bit l >> 2 of ghm[w]
    // is set; a dead row is 0
    const int row = w0 + threadIdx.x;
    const bool live = row < w;
    const uint32_t ghm = live ? __ldg(ghmask + row) : 0u;
    uint4* b4 = reinterpret_cast<uint4*>(rows + threadIdx.x * uaes::kL1Stride);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t a[32];
#pragma unroll
      for (int i = 0; i < 32; ++i)
        a[i] = live ? __ldg(x + static_cast<size_t>(32 * c + i) * w + row) : 0u;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint32_t m = 0u - ((ghm >> (8 * c + q)) & 1u);
        b4[8 * c + q] = make_uint4(a[4 * q] & m, a[4 * q + 1] & m, a[4 * q + 2] & m,
                                   a[4 * q + 3] & m);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 128 * 32 / kGhashRows; ++n) {  // W1p as it is
    const int i = n * kGhashRows + threadIdx.x;
    reinterpret_cast<uint4*>(w1s + (i >> 5) * uaes::kL1Stride)[i & 31] =
        __ldg(reinterpret_cast<const uint4*>(w1p) + i);
  }
  __syncthreads();
  // W1w[o][4j+k] bit r = W1p[o][16 (r%8) + 4k + r/8] bit j, in place: one
  // 32x32 transpose per (o, k); the four threads of a row o are neighbouring
  // lanes of one warp, and read the row before any of them writes it
#pragma unroll 1
  for (int n = 0; n < 128 * 4 / kGhashRows; ++n) {
    const int task = n * kGhashRows + threadIdx.x;
    const int k = task & 3;
    uint32_t* wr = w1s + (task >> 2) * uaes::kL1Stride;
    uint32_t a[32];
#pragma unroll
    for (int b = 0; b < 8; ++b) {  // words 16b + 4k + c are the planes of bits r = 8c + b
      const uint4 v = reinterpret_cast<const uint4*>(wr)[4 * b + k];
      a[b] = v.x;
      a[8 + b] = v.y;
      a[16 + b] = v.z;
      a[24 + b] = v.w;
    }
    __syncwarp();
    uaes::transpose32(a);  // a[j] bit r = W1p[o][16 (r%8) + 4k + r/8] bit j
#pragma unroll
    for (int j = 0; j < 32; ++j) wr[4 * j + k] = a[j];
  }
  __syncthreads();
  const int first = threadIdx.x & ~31;
  uaes::level1_mma_warp(w1s, rows + first * uaes::kL1Stride, s1, w0 + first, w);
}

__global__ void __launch_bounds__(kGhashRows, 1)
ghash1_fused_kernel(const uint32_t* __restrict__ ghmask, const uint32_t* __restrict__ w1p,
                    const uint32_t* __restrict__ x, int8_t* __restrict__ s1, int w) {
  extern __shared__ uint32_t smem[];
  ghash1_body<uaes::StreamForm::kRows>(smem, ghmask, w1p, x, s1, w);
}

__global__ void __launch_bounds__(kGhashRows, 1)
ghash1_fused_t_kernel(const uint32_t* __restrict__ ghmask, const uint32_t* __restrict__ w1p,
                      const uint32_t* __restrict__ x_t, int8_t* __restrict__ s1, int w) {
  extern __shared__ uint32_t smem[];
  ghash1_body<uaes::StreamForm::kColumns>(smem, ghmask, w1p, x_t, s1, w);
}

// GCM-SIV's counters as a policy of the bodies (see the note at the top).
// stage: threads 0-3 each take word k of the 32 blocks, basew[4j+k] (plus j
// for word 0, wrapping per lane), and write its 32 planes into cs in the
// plane order (b, p) = (q % 8, 4k + q / 8) of its bit q: word 0's planes
// are then B = basew[4j] + j, and words 1-3's are the row's own.  planes:
// words 1-3 as staged, and word 0 as B + 32 row, a bitsliced add of a
// per-thread constant: bits 0-4 are B's, and for bits 5-31 a sum and a
// majority LOP3 a bit; the carry out of bit 31 is dropped (the LE32 wrap).
struct SivCounters {
  const uint32_t* basew;
  __device__ __forceinline__ void stage(uint32_t* cs) const {
    const int k = threadIdx.x;
    if (k < 4) {
      uint32_t a[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) a[j] = __ldg(basew + 4 * j + k) + (k == 0 ? j : 0u);
      uaes::transpose32(a);  // a[q] = plane of bit q of word k
#pragma unroll
      for (int q = 0; q < 32; ++q) cs[(q % 8) * 16 + 4 * k + q / 8] = a[q];
    }
  }
  __device__ __forceinline__ void planes(uint32_t (&s)[8][16], const uint32_t* cs, int row,
                                         bool) const {
#pragma unroll
    for (int b = 0; b < 8; ++b)
#pragma unroll
      for (int p = 0; p < 16; ++p) s[b][p] = cs[b * 16 + p];
    const uint32_t c = 32u * static_cast<uint32_t>(row);
    uint32_t carry = 0u;
#pragma unroll
    for (int q = 5; q < 32; ++q) {
      const uint32_t kq = static_cast<uint32_t>(static_cast<int32_t>(c << (31 - q)) >> 31);
      const uint32_t x = s[q % 8][q / 8];
      s[q % 8][q / 8] = x ^ kq ^ carry;
      carry = (x & kq) | (carry & (x ^ kq));
    }
  }
};

__global__ void __launch_bounds__(kCtrRows, 1)
siv_ctr_kernel(const uint32_t* __restrict__ kp, const uint32_t* __restrict__ basew,
               const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int rounds, int w) {
  extern __shared__ uint32_t smem[];
  uaes::ctr_xor_body<kCtrRows>(smem, SivCounters{basew}, kp, in, out, rounds, w);
}

__global__ void __launch_bounds__(kCtrRows, 1)
siv_ctr_t_kernel(const uint32_t* __restrict__ kp, const uint32_t* __restrict__ basew,
                 const uint32_t* __restrict__ in_t, uint32_t* __restrict__ out_t, int rounds,
                 int w) {
  extern __shared__ uint32_t smem[];
  uaes::ctr_xor_body<kCtrRows, uaes::StreamForm::kColumns>(smem, SivCounters{basew}, kp, in_t,
                                                           out_t, rounds, w);
}

__global__ void __launch_bounds__(kOpenRows, 1)
siv_open_kernel(const uint32_t* __restrict__ kp, const uint32_t* __restrict__ basew,
                const uint32_t* __restrict__ ghmask, const uint32_t* __restrict__ w1p,
                const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                int8_t* __restrict__ s1, int rounds, int w) {
  extern __shared__ uint32_t smem[];
  // opening, level 1 runs over the output planes: the recovered plaintext
  uaes::ctr_level1_body<kOpenRows, false>(smem, SivCounters{basew}, kp, ghmask, w1p, in, out, s1,
                                          rounds, w);
}

}  // namespace

extern "C" int micro_aes_ghash1_fused(const uint32_t* ghmask, const uint32_t* w1p,
                                      const uint32_t* x, int8_t* s1, int w, cudaStream_t stream) {
  return uaes::launch_rows(ghash1_fused_kernel, kGhashRows, kGhashSmemWords, w, stream, ghmask,
                           w1p, x, s1, w);
}

extern "C" int micro_aes_ghash1_fused_t(const uint32_t* ghmask, const uint32_t* w1p,
                                        const uint32_t* x_t, int8_t* s1, int w,
                                        cudaStream_t stream) {
  return uaes::launch_rows(ghash1_fused_t_kernel, kGhashRows, kGhashSmemWords, w, stream, ghmask,
                           w1p, x_t, s1, w);
}

extern "C" int micro_aes_siv_ctrw_fused(const uint32_t* kp, const uint32_t* basew,
                                        const uint32_t* pt, uint32_t* out, int rounds, int w,
                                        cudaStream_t stream) {
  return uaes::launch_rows(siv_ctr_kernel, kCtrRows, uaes::ctr_xor_smem_words(kCtrRows), w,
                           stream, kp, basew, pt, out, rounds, w);
}

extern "C" int micro_aes_siv_ctrw_fused_t(const uint32_t* kp, const uint32_t* basew,
                                          const uint32_t* pt_t, uint32_t* out_t, int rounds,
                                          int w, cudaStream_t stream) {
  return uaes::launch_rows(siv_ctr_t_kernel, kCtrRows,
                           uaes::ctr_xor_smem_words(kCtrRows, uaes::StreamForm::kColumns), w,
                           stream, kp, basew, pt_t, out_t, rounds, w);
}

extern "C" int micro_aes_siv_open_fused(const uint32_t* kp, const uint32_t* basew,
                                        const uint32_t* ghmask, const uint32_t* w1p,
                                        const uint32_t* ct, uint32_t* out, int8_t* s1, int rounds,
                                        int w, cudaStream_t stream) {
  return uaes::launch_rows(siv_open_kernel, kOpenRows, uaes::ctr_level1_smem_words(kOpenRows), w,
                           stream, kp, basew, ghmask, w1p, ct, out, s1, rounds, w);
}
