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
// What bounds them on the card: integer ALU issue and registers, as for K1
// (seal_fused.cu) and K3 (ctr_fused.cu): K4 is K1's level-1 fold without
// the cipher (~16,400 logic operations per row against 576 bytes moved),
// K5 is K3 with a transpose per counter word instead of broadcast counter
// planes, K5-open is K5 plus K4's fold.  One thread owns one stream row and
// its 128 planes in registers; a block stages its rows in shared memory
// (coalesced 16-byte loads and stores, row stride 129 words) beside the key
// planes, the base and, where it folds, W1p.
// ptxas (sm_90a): chip_smoke.py's build phase prints each kernel's registers
// and spills; PERF.md keeps them.
#include <cuda_runtime.h>

#include "aes_bitslice.cuh"

namespace {

constexpr int kW1Words = 128 * 128;
constexpr int kGhashRows = 256;  // K4 rows (threads) per block: 193 KiB of shared memory

// rows per block: K5-open holds W1p too and runs one block per SM, as K1;
// K5 runs as K3
template <bool OPEN>
struct SivRows {
  static constexpr int value = OPEN ? 256 : 128;
};

__global__ void __launch_bounds__(kGhashRows, 1)
ghash1_fused_kernel(const uint32_t* __restrict__ ghmask, const uint32_t* __restrict__ w1p,
                    const uint32_t* __restrict__ x, int8_t* __restrict__ s1, int w) {
  extern __shared__ uint32_t smem[];
  uint32_t* w1s = smem;
  uint32_t* stage = w1s + kW1Words;

  const int w0 = blockIdx.x * kGhashRows;
  uaes::copy_to_smem(w1p, w1s, kW1Words);
  uaes::stage_rows_in(x, stage, w0, kGhashRows, w);
  __syncthreads();

  const int row = w0 + threadIdx.x;
  const bool live = row < w;
  uint32_t s[8][16];
  uaes::row_to_planes(s, stage + threadIdx.x * uaes::kStageStride);
  uaes::level1_row(s, live ? ghmask[row] : 0u, w1s, s1, row, w, live);
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

template <bool OPEN>
__global__ void __launch_bounds__(SivRows<OPEN>::value, 1)
siv_ctr_kernel(const uint32_t* __restrict__ kp, const uint32_t* __restrict__ basew,
               const uint32_t* __restrict__ ghmask, const uint32_t* __restrict__ w1p,
               const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
               int8_t* __restrict__ s1, int rounds, int w) {
  constexpr int kRows = SivRows<OPEN>::value;
  extern __shared__ uint32_t smem[];
  uint32_t* kps = smem;
  uint32_t* bases = kps + uaes::kMaxKeyPlaneWords;
  uint32_t* w1s = bases + 128;
  uint32_t* stage = w1s + (OPEN ? kW1Words : 0);

  const int w0 = blockIdx.x * kRows;
  uaes::copy_to_smem(kp, kps, (rounds + 1) * 128);
  uaes::copy_to_smem(basew, bases, 128);
  if (OPEN) uaes::copy_to_smem(w1p, w1s, kW1Words);
  uaes::stage_rows_in(in, stage, w0, kRows, w);
  __syncthreads();

  const int row = w0 + threadIdx.x;
  const bool live = row < w;
  uint32_t s[8][16];
  siv_counter_planes(s, bases, static_cast<uint32_t>(row));
  uaes::encrypt_state(s, kps, rounds);
  // opening, s becomes the output planes: the recovered plaintext
  uaes::xor_stream_row<OPEN, false>(s, stage + threadIdx.x * uaes::kStageStride);
  __syncthreads();
  uaes::stage_rows_out(stage, out, w0, kRows, w);
  if (OPEN) uaes::level1_row(s, live ? ghmask[row] : 0u, w1s, s1, row, w, live);
}

template <bool OPEN>
int launch_siv(const uint32_t* kp, const uint32_t* basew, const uint32_t* ghmask,
               const uint32_t* w1p, const uint32_t* in, uint32_t* out, int8_t* s1, int rounds,
               int w, cudaStream_t stream) {
  constexpr int kRows = SivRows<OPEN>::value;
  const size_t smem = (uaes::kMaxKeyPlaneWords + 128 + (OPEN ? kW1Words : 0)
                       + kRows * uaes::kStageStride) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(siv_ctr_kernel<OPEN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (w + kRows - 1) / kRows;
  siv_ctr_kernel<OPEN><<<blocks, kRows, smem, stream>>>(kp, basew, ghmask, w1p, in, out, s1,
                                                        rounds, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int micro_aes_ghash1_fused(const uint32_t* ghmask, const uint32_t* w1p,
                                      const uint32_t* x, int8_t* s1, int w, cudaStream_t stream) {
  const size_t smem = (kW1Words + kGhashRows * uaes::kStageStride) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(ghash1_fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (w + kGhashRows - 1) / kGhashRows;
  ghash1_fused_kernel<<<blocks, kGhashRows, smem, stream>>>(ghmask, w1p, x, s1, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int micro_aes_siv_ctrw_fused(const uint32_t* kp, const uint32_t* basew,
                                        const uint32_t* pt, uint32_t* out, int rounds, int w,
                                        cudaStream_t stream) {
  return launch_siv<false>(kp, basew, nullptr, nullptr, pt, out, nullptr, rounds, w, stream);
}

extern "C" int micro_aes_siv_open_fused(const uint32_t* kp, const uint32_t* basew,
                                        const uint32_t* ghmask, const uint32_t* w1p,
                                        const uint32_t* ct, uint32_t* out, int8_t* s1, int rounds,
                                        int w, cudaStream_t stream) {
  return launch_siv<true>(kp, basew, ghmask, w1p, ct, out, s1, rounds, w, stream);
}
