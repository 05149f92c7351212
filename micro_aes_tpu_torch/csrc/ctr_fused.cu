// K3: fused CTR keystream (no GHASH): in-kernel big-endian GCM counters ->
// bitsliced AES -> keystream XOR onto the stream.
//
// Replaces micro_aes_tpu/ops/pallas_seal.py:ctr_fused (_ctr_kernel,
// _ctr_words_tile).
//
// Contract: kp uint32[(R+1)*128, 1] key planes, j0c uint32[128, 1] (J0's
// bits as 0/0xFFFFFFFF words, index b*16+p), lohi uint32[2, W] (per-row
// counter value, 32-aligned, and its 24-bit byte-9..11 extension),
// pt uint32[W, 128] w-major stream -> uint32[W, 128].
//
// The TPU kernel derives its counters in the word domain and butterflies
// them into planes; here they are built directly in the plane domain (as
// the JAX package's ctr_fused_jnp twin does), which needs no transpose:
// bits 0..4 are fixed lane patterns and the rest are per-row broadcasts.
//
// The body is aes_bitslice.cuh's ctr_xor_body with GCM's counters (K5 runs
// it with GCM-SIV's): one thread owns one stream row (32 blocks) and its
// 128 planes in registers; the block's input rows arrive in shared memory
// by TMA (a cp.async.bulk a row, on an mbarrier) while the cipher runs, and
// the keystream goes onto them as words (4 transposes a row).  Its first
// design staged the rows before the cipher and XORed in the plane domain: 8
// transposes a row, the input into planes and the result back.  The
// word-domain XOR was what gained; the rows copied by cp.async (16 bytes a
// thread) instead of TMA ran slower than staging them before the cipher
// (tools/k3_k5_ab.py probe; PERF.md).
//
// What bounds it on the card: integer ALU issue and registers, as in K2
// (cipher_planes.cu): each stream byte is read and written once against
// ~70 logic operations (AES-256), and the keystream's 4 transposes a row.
// 74 KiB of shared memory a block, two blocks of 128 rows an SM, so the 16
// MiB stream runs in one wave on 132 SMs.  ptxas (sm_90a): chip_smoke.py's
// build phase prints the registers and spills; PERF.md keeps them.
#include <cuda_runtime.h>

#include "aes_bitslice.cuh"

namespace {

constexpr int kRows = 128;  // stream rows (threads) per block
constexpr int kSmemWords = uaes::ctr_xor_smem_words(kRows);

__global__ void __launch_bounds__(kRows)
ctr_fused_kernel(const uint32_t* __restrict__ kp, const uint32_t* __restrict__ j0c,
                 const uint32_t* __restrict__ lohi, const uint32_t* __restrict__ pt,
                 uint32_t* __restrict__ ct, int rounds, int w) {
  extern __shared__ uint32_t smem[];
  uaes::ctr_xor_body<kRows>(smem, uaes::GcmCounters{j0c, lohi, w}, kp, pt, ct, rounds, w);
}

}  // namespace

extern "C" int micro_aes_ctr_fused(const uint32_t* kp, const uint32_t* j0c, const uint32_t* lohi,
                                   const uint32_t* pt, uint32_t* ct, int rounds, int w,
                                   cudaStream_t stream) {
  return uaes::launch_rows(ctr_fused_kernel, kRows, kSmemWords, w, stream, kp, j0c, lohi, pt, ct,
                           rounds, w);
}
