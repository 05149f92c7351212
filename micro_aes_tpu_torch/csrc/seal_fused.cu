// K1: fused AES-GCM seal/open body: in-kernel GCM counter planes ->
// bitsliced AES-128/192/256 -> keystream XOR onto the stream -> masked
// level-1 GHASH partial of every 32-block row.
//
// Replaces micro_aes_tpu/ops/pallas_seal.py:seal_fused (_seal_kernel,
// _seal_math); K1t, the same body on the transposed stream, replaces
// seal_fused_t (_seal_kernel_t).
//
// Contract: kp uint32[(R+1)*128, 1], j0c uint32[128, 1], lohi uint32[2, W],
// ghmask uint32[1, W] (bit j of word w set = stream position 32w+j is a
// message block), W1p uint32[128, 128] (the plane-ordered level-1 GHASH
// table W1^T, int8[128, 4096] with column c = 32-lane j * 128 + plane q,
// packed by lane: bit j of W1p[o][q] = W1^T[o, j*128 + q]) and the w-major
// stream pt uint32[W, 128] -> (out uint32[W, 128], s1 int8[128, W]) with
// s1[o, w] = sum_c W1^T[o, c] * bit_c(row w) mod 2 over the ciphertext bits
// (the input bits when opening).
//
// Level 1 is a GF(2) product, s1[o, w] = parity(popc(A_o AND B_w)) over
// 4,096 bits, with A_o = W1p's row o and B_w = row w's 128 masked planes
// (ghash_bulk.pack_level1 packs both as word q, bit j; 64 KiB, where the TPU
// kernel's int8 table is 512 KiB).  That is the binary tensor cores'
// product (mma.sync m16n8k256 .b1 .and.popc).  The first design
// ran it as 16,384 3-input logic operations per row with 4,096 LDS.128 of
// W1p, ~0.078 ms at 16 MiB (AES-256) on an H100, as much as the cipher
// (PERF.md).
// Now, after the cipher and the stream are out, each thread writes its
// masked planes into the stage area (rows kL1Stride = 132 words apart) and
// each warp multiplies W1p by its 32 rows in 512 binary MMAs, both operands
// read by ldmatrix from shared memory, and stores the parities through a
// byte tile in its rows' area (aes_bitslice.cuh level1_mma_warp).  The
// body is aes_bitslice.cuh's ctr_level1_body with GCM's counters; K5-open
// (siv_fused.cu) runs the same body with GCM-SIV's.
//
// What bounds it on the card: integer ALU issue and registers, in the
// cipher: ~2,500 logic operations per round per 32 blocks (see
// cipher_planes.cu), the two stream transposes, and level 1's staging and
// ~4,100 shared-memory fragment loads per warp; HBM traffic is only the
// stream twice plus 1/16 of it for s1.  One thread owns one stream row and
// its 128 planes in registers; a block of 256 rows stages its rows in
// shared memory (coalesced 16-byte loads and stores, row stride 129 words,
// then 132 for level 1) beside the key planes and W1p, 206 KiB in all, one
// block per SM.  ptxas (sm_90a, CUDA 12.8): 255 registers; spill stores 36
// bytes (seal) and 124 bytes (open).
//
// K1t (micro_aes_seal_fused_t) takes the transposed stream pt_t
// uint32[128, W] (column w, lane 4j+k = word k of block 32w+j) -> (out
// uint32[128, W], s1 int8[128, W]): ctr_level1_body in its kColumns form,
// which reads and writes the stream in place after the cipher, a warp's 32
// rows one coalesced 128-byte access a lane, and stages only level 1's B
// operand.  Its first design was K1 between two torch transposes at the
// wrapper, 16 MiB of HBM read and written for each (0.1685 ms at 16 MiB
// AES-256 against K1's 0.1007-0.1118; PERF.md).
#include <cuda_runtime.h>

#include "aes_bitslice.cuh"

namespace {

constexpr int kRows = 256;  // stream rows (threads) per block
constexpr int kSmemWords = uaes::ctr_level1_smem_words(kRows);

template <bool BITS_FROM_INPUT>
__global__ void __launch_bounds__(kRows, 1)
seal_fused_kernel(const uint32_t* __restrict__ kp, const uint32_t* __restrict__ j0c,
                  const uint32_t* __restrict__ lohi, const uint32_t* __restrict__ ghmask,
                  const uint32_t* __restrict__ w1p, const uint32_t* __restrict__ pt,
                  uint32_t* __restrict__ ct, int8_t* __restrict__ s1, int rounds, int w) {
  extern __shared__ uint32_t smem[];
  uaes::ctr_level1_body<kRows, BITS_FROM_INPUT>(smem, uaes::GcmCounters{j0c, lohi, w}, kp,
                                                ghmask, w1p, pt, ct, s1, rounds, w);
}

// K1t: the same body on the transposed stream, read and written in place.
template <bool BITS_FROM_INPUT>
__global__ void __launch_bounds__(kRows, 1)
seal_fused_t_kernel(const uint32_t* __restrict__ kp, const uint32_t* __restrict__ j0c,
                    const uint32_t* __restrict__ lohi, const uint32_t* __restrict__ ghmask,
                    const uint32_t* __restrict__ w1p, const uint32_t* __restrict__ pt_t,
                    uint32_t* __restrict__ ct_t, int8_t* __restrict__ s1, int rounds, int w) {
  extern __shared__ uint32_t smem[];
  uaes::ctr_level1_body<kRows, BITS_FROM_INPUT, uaes::StreamForm::kColumns>(
      smem, uaes::GcmCounters{j0c, lohi, w}, kp, ghmask, w1p, pt_t, ct_t, s1, rounds, w);
}

}  // namespace

extern "C" int micro_aes_seal_fused(const uint32_t* kp, const uint32_t* j0c, const uint32_t* lohi,
                                    const uint32_t* ghmask, const uint32_t* w1p,
                                    const uint32_t* pt, uint32_t* ct, int8_t* s1, int rounds,
                                    int w, int bits_from_input, cudaStream_t stream) {
  return uaes::launch_rows(bits_from_input ? seal_fused_kernel<true> : seal_fused_kernel<false>,
                           kRows, kSmemWords, w, stream, kp, j0c, lohi, ghmask, w1p, pt, ct, s1,
                           rounds, w);
}

extern "C" int micro_aes_seal_fused_t(const uint32_t* kp, const uint32_t* j0c,
                                      const uint32_t* lohi, const uint32_t* ghmask,
                                      const uint32_t* w1p, const uint32_t* pt_t, uint32_t* ct_t,
                                      int8_t* s1, int rounds, int w, int bits_from_input,
                                      cudaStream_t stream) {
  return uaes::launch_rows(
      bits_from_input ? seal_fused_t_kernel<true> : seal_fused_t_kernel<false>, kRows, kSmemWords,
      w, stream, kp, j0c, lohi, ghmask, w1p, pt_t, ct_t, s1, rounds, w);
}
