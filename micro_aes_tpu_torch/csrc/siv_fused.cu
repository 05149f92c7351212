// The GCM-SIV bulk kernels on the w-major stream:
//   K4      level-1 GHASH/POLYVAL partials of a stream, no cipher (the seal's
//           POLYVAL pass); replaces micro_aes_tpu/ops/pallas_seal.py:
//           ghash1_fused (_ghash_kernel) and, through a transpose at the
//           wrapper, ghash1_fused_t;
//   K5      GCM-SIV CTR: in-kernel LE32 counters from the tag base -> bitsliced
//           AES -> keystream XOR onto the stream (the seal's second pass);
//           replaces pallas_seal.py:siv_ctrw_fused (_siv_ctr_kernel) and,
//           through a transpose, siv_ctrw_fused_t;
//   K5-open K5, then the level-1 POLYVAL partials of its output (the
//           recovered plaintext): the whole open in one pass; replaces
//           pallas_seal.py:siv_open_fused (_siv_open_kernel).
//
// Contracts (ops/siv_kernels.py): kp uint32[(R+1)*128, 1] key planes,
// basew uint32[1, 128] (lane 4j+k = counter base word k for block j of a
// row), ghmask uint32[1, W], W1p uint32[128, 128] (ghash_bulk.pack_level1),
// stream uint32[W, 128] -> out uint32[W, 128] and/or s1 int8[128, W].
//
// Counters: block j of stream row r has the words (basew[4j] + 32r + j,
// basew[4j+1], basew[4j+2], basew[4j+3]).  Only word 0 counts, and uint32_t
// addition wraps mod 2^32 with no carry into word 1, which is GCM-SIV's
// LE32 rule (the JAX _siv_ctr_tile in the word domain).  Each thread builds
// its row's 32 counter blocks word by word in registers and turns them
// into planes with the same 32x32 transpose that reads a staged row.
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
// What bounds them on the card: integer ALU issue and registers for K5 and
// K5-open, as for K1 (seal_fused.cu) and K3 (ctr_fused.cu): K5 is K3 with a
// transpose per counter word instead of broadcast counter planes, K5-open
// is K5 plus level 1's staging and ~4,100 shared-memory fragment loads per
// warp.  K4 moves 644 bytes a row against 2 x 128 x 4,096 tensor-core
// operations, its W1 permutation and the parity stores: the tensor cores
// and the memory system, one block of 256 rows per SM.  K5 and K5-open own
// one stream row and its 128 planes in registers a thread; a block stages
// its rows in shared memory (coalesced 16-byte loads and stores, row stride
// 129 words) beside the key planes, the base and, for K5-open, W1p.  K5 and
// K5-open sit at the 255-register cap and spill: ptxas (sm_90a, CUDA 12.8)
// K5-open 36 B of spill stores (160 B in its first design, which held
// level1_row's table walk beside the planes), K5 16 B; chip_smoke.py's
// build phase prints them, K4's among them.
#include <cuda_runtime.h>

#include "aes_bitslice.cuh"

namespace {

constexpr int kGhashRows = 256;  // K4 rows (threads) per block
constexpr int kGhashSmemWords = (128 + kGhashRows) * uaes::kL1Stride;  // W1w and B: 198 KiB

constexpr int kCtrRows = 128;   // K5 rows (threads) per block, as K3
constexpr int kOpenRows = 256;  // K5-open rows per block, as K1: one block per SM

// K4 (see the note at the top): the stream rows go to the MMA's B operand as
// they are, and W1p's rows are permuted to match them.
__global__ void __launch_bounds__(kGhashRows, 1)
ghash1_fused_kernel(const uint32_t* __restrict__ ghmask, const uint32_t* __restrict__ w1p,
                    const uint32_t* __restrict__ x, int8_t* __restrict__ s1, int w) {
  extern __shared__ uint32_t smem[];
  uint32_t* w1s = smem;                           // W1w, rows kL1Stride apart
  uint32_t* rows = w1s + 128 * uaes::kL1Stride;   // B: the masked rows, kL1Stride apart

  const int w0 = blockIdx.x * kGhashRows;
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

// The counter planes of stream row `row` (see the note at the top).
__device__ __forceinline__ void siv_counter_planes(uint32_t (&s)[8][16], const uint32_t* bases,
                                                   uint32_t row) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t a[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) a[j] = bases[4 * j + k] + (k == 0 ? 32u * row + j : 0u);
    uaes::transpose32(a);  // a[r] = plane of bit r of word k: (b, p) = (r%8, 4k + r/8)
#pragma unroll
    for (int r = 0; r < 32; ++r) s[r % 8][4 * k + r / 8] = a[r];
  }
}

// GCM-SIV's counters as a policy of ctr_level1_body: the base staged
struct SivCounters {
  const uint32_t* basew;
  __device__ __forceinline__ void stage(uint32_t* cs) const { uaes::copy_to_smem(basew, cs, 128); }
  __device__ __forceinline__ void planes(uint32_t (&s)[8][16], const uint32_t* cs, int row,
                                         bool) const {
    siv_counter_planes(s, cs, static_cast<uint32_t>(row));
  }
};

__global__ void __launch_bounds__(kCtrRows, 1)
siv_ctr_kernel(const uint32_t* __restrict__ kp, const uint32_t* __restrict__ basew,
               const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int rounds, int w) {
  extern __shared__ uint32_t smem[];
  uint32_t* kps = smem;
  uint32_t* bases = kps + uaes::kMaxKeyPlaneWords;
  uint32_t* stage = bases + 128;

  const int w0 = blockIdx.x * kCtrRows;
  uaes::copy_to_smem(kp, kps, (rounds + 1) * 128);
  uaes::copy_to_smem(basew, bases, 128);
  uaes::stage_rows_in(in, stage, w0, kCtrRows, w);
  __syncthreads();

  const int row = w0 + threadIdx.x;
  uint32_t s[8][16];
  siv_counter_planes(s, bases, static_cast<uint32_t>(row));
  uaes::encrypt_state(s, kps, rounds);
  uaes::xor_stream_row<false, false>(s, stage + threadIdx.x * uaes::kStageStride);
  __syncthreads();
  uaes::stage_rows_out(stage, out, w0, kCtrRows, w);
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

template <class Kernel, class... Args>
int launch(Kernel kernel, int rows, int smem_words, int w, cudaStream_t stream, Args... args) {
  const size_t smem = smem_words * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(w + rows - 1) / rows, rows, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int micro_aes_ghash1_fused(const uint32_t* ghmask, const uint32_t* w1p,
                                      const uint32_t* x, int8_t* s1, int w, cudaStream_t stream) {
  return launch(ghash1_fused_kernel, kGhashRows, kGhashSmemWords, w, stream, ghmask, w1p, x, s1,
                w);
}

extern "C" int micro_aes_siv_ctrw_fused(const uint32_t* kp, const uint32_t* basew,
                                        const uint32_t* pt, uint32_t* out, int rounds, int w,
                                        cudaStream_t stream) {
  return launch(siv_ctr_kernel, kCtrRows,
                uaes::kMaxKeyPlaneWords + 128 + kCtrRows * uaes::kStageStride, w, stream, kp,
                basew, pt, out, rounds, w);
}

extern "C" int micro_aes_siv_open_fused(const uint32_t* kp, const uint32_t* basew,
                                        const uint32_t* ghmask, const uint32_t* w1p,
                                        const uint32_t* ct, uint32_t* out, int8_t* s1, int rounds,
                                        int w, cudaStream_t stream) {
  return launch(siv_open_kernel, kOpenRows, uaes::ctr_level1_smem_words(kOpenRows), w, stream,
                kp, basew, ghmask, w1p, ct, out, s1, rounds, w);
}
