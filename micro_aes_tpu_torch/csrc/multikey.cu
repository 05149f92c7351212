// K9: multi-key cipher-and-xor, a key per message: out = in ^ E_k(ctr) (or
// D_k(ctr)) for every 32-block stream row, k the key of the row's message.
//
// Replaces micro_aes_tpu/ops/pallas_multikey.py:ctrw_fused_multikey
// (_mk_kernel, on a (message, tile) grid whose key block follows the
// message index).
//
// Contract: rks uint8[B, R+1, 16] round keys (16-byte aligned), ctr and in
// uint32[B*Wm, 128] w-major streams (row w: blocks 32w..32w+31, lane 4j+k =
// little-endian word k of block 32w+j), row w under the key of message
// w / Wm -> out uint32[B*Wm, 128].  The Python wrapper keeps the JAX
// package's key-plane contract and passes the round keys those planes
// encode.
//
// What bounds it on the card: integer ALU issue, as in K2/K3 (about 70
// logic operations per stream byte for AES-256).  Keys change per row, so
// instead of staging 128 plane words per round of every message in shared
// memory (7.5 KB per AES-256 message, up to 16 messages per block of 128
// rows), each thread expands its message's 16 round-key bytes of a round
// into broadcast planes in registers: one 16-byte load and about 3
// operations per plane word, some 15 % of a round's S-box work.  Like K3,
// a block of 128 threads stages its counter rows and then its data rows in
// shared memory with coalesced 16-byte loads, one row per thread.
#include <cuda_runtime.h>

#include "aes_bitslice.cuh"

namespace {

constexpr int kRows = 128;  // stream rows (threads) per block
constexpr int kSmemWords = kRows * uaes::kStageStride;

template <bool DECRYPT>
__global__ void __launch_bounds__(kRows)
ctrw_multikey_kernel(const uint8_t* __restrict__ rks, const uint32_t* __restrict__ ctr,
                     const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                     int rounds, int wm, int w) {
  extern __shared__ uint32_t stage[];
  const int w0 = blockIdx.x * kRows;
  const int row = w0 + threadIdx.x;
  uint32_t* mine = stage + threadIdx.x * uaes::kStageStride;

  uaes::stage_rows_in(ctr, stage, w0, kRows, w);
  __syncthreads();
  uint32_t s[8][16];
  uaes::row_to_planes(s, mine);
  __syncthreads();  // the stage now takes the data rows
  uaes::stage_rows_in(in, stage, w0, kRows, w);

  const int msg = row < w ? row / wm : 0;
  const uaes::RoundKeyBytes key{rks + static_cast<size_t>(msg) * (rounds + 1) * 16};
  if (DECRYPT) {
    uaes::decrypt_with(s, key, rounds);
  } else {
    uaes::encrypt_with(s, key, rounds);
  }
  __syncthreads();
  uaes::xor_stream_row<false, false>(s, mine);
  __syncthreads();
  uaes::stage_rows_out(stage, out, w0, kRows, w);
}

}  // namespace

extern "C" int micro_aes_ctrw_multikey(const uint8_t* rks, const uint32_t* ctr, const uint32_t* in,
                                       uint32_t* out, int rounds, int wm, int w, int decrypt,
                                       cudaStream_t stream) {
  const size_t smem = kSmemWords * sizeof(uint32_t);
  auto kernel = decrypt ? ctrw_multikey_kernel<true> : ctrw_multikey_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (w + kRows - 1) / kRows;
  kernel<<<blocks, kRows, smem, stream>>>(rks, ctr, in, out, rounds, wm, w);
  return static_cast<int>(cudaGetLastError());
}
