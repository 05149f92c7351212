// K16: the RFC 3394 key-wrap wheel over B = 32W independent messages, each
// under its own key-encryption key, 32 messages per 32-bit plane word.  Per
// message, with A the 8-byte integrity register and R[0..n-1] the semiblocks
// (micro_aes.c:1829-1893), 6n steps:
//   wrap    step s: i = s mod n, t = s + 1; B = E(A || R[i]);
//           A = B[0..7] ^ BE64(t), R[i] = B[8..15]; A starts at 0xA6...A6
//   unwrap  step s: i = (6n-1-s) mod n, t = 6n - s;
//           B = D((A ^ BE64(t)) || R[i]); A = B[0..7], R[i] = B[8..15];
//           A starts at the wrapped input's first semiblock
// and the output is A || R (the caller checks unwrap's A against 0xA6).
// Replaces micro_aes_tpu/ops/pallas_chain.py: kw_packed_fused (_kw_kernel).
//
// Contract (ops/kw_kernels.py): kpw uint32[(R+1)*128, W] lane-packed key
// planes (as K13's) in the message map of `tile` (lane_spread.cuh: tile 1 is
// the natural map of kw_packed, wide_tile(W) the wide map of JAX's
// kw_packed_fused, whose keys are packed as key_planes_packed(rks[wide_perm(B)]));
// data uint8[B, n, 8] secrets to wrap or uint8[B, n+1, 8] wrapped inputs;
// out uint8[B, n+1, 8]; data and out in natural message order; n >= 2.
//
// What bounds it on the card: the wheel.  Step s+1 needs step s's A, so the
// 6n ciphers of a message run one after another (384 at n = 64), and a batch
// has only W words of independent work: the layout is K13's
// (lane_spread.cuh), a word over the 16 lanes of a half-warp, a warp of two
// words alone on an SM sub-partition, and a step costs one lane's logic
// instructions.  The block A || R[i] needs no exchange between lanes: A's
// bytes stay in lanes 0..7 for the whole wheel, and lanes 8..15 take byte
// p - 8 of R[i] and give back the new R[i].  The BE64 step count is public,
// so its planes are all-ones or zero per lane.  Unwrap runs decrypt_spread
// (32 shuffles a round against encrypt's 24).
//
// Where R lives: in `out`, not in shared memory.  JAX bounds n only by its
// VMEM budget, and R costs n * 512 bytes per warp of two words; global memory
// caps no n.  Each of lanes 8..15 owns byte p - 8 of every semiblock of its 32
// messages, so no other thread reads or writes its bytes, and it fetches the
// next step's semiblock one step ahead, as K13 fetches its data: the first n
// steps (one pass over R) read the input, the rest read what an earlier step
// of the same thread stored in `out`.  That semiblock is never the one the
// current step stores, because n >= 2.  Plain loads (not the read-only
// path) read `out`.  No address depends on key or data.
#include <cuda_runtime.h>

#include "lane_spread.cuh"

namespace {

using spread::decrypt_spread;
using spread::encrypt_spread;
using spread::fetch;
using spread::fetch_rw;
using spread::kFull;
using spread::kKeyStride;
using spread::store_planes;
using spread::to_planes;

template <bool UNWRAP>
__global__ void __launch_bounds__(32)
kw_wheel_kernel(const uint32_t* __restrict__ kpw, const uint8_t* __restrict__ data,
                uint8_t* out, int rounds, int w, int n, int tile) {
  __shared__ uint32_t kps[2 * kKeyStride];
  const int half = threadIdx.x >> 4, p = threadIdx.x & 15;
  const int word = 2 * blockIdx.x + half;
  const bool live = word < w;  // an odd W leaves the last half-warp idle

  uint32_t* mine = kps + half * kKeyStride;
  for (int q = p; q < (rounds + 1) * 128; q += 16)
    mine[q] = live ? __ldg(kpw + static_cast<size_t>(q) * w + word) : 0u;
  __syncwarp();
  const uint32_t* kp = mine + p;
  const int src = UNWRAP ? uaes::inv_shift_src(p) : uaes::shift_src(p);
  const int row1 = 4 * (p / 4) + (p + 1) % 4, row2 = 4 * (p / 4) + (p + 2) % 4;

  const bool a_lane = p < 8;  // lanes 0..7 hold A, lanes 8..15 byte p - 8 of R[i]
  const spread::Lanes lanes = spread::lanes_of(live ? word : 0, tile);
  const size_t in_row = static_cast<size_t>(UNWRAP ? n + 1 : n) * 8;
  const size_t out_row = static_cast<size_t>(n + 1) * 8;
  const size_t in_stride = in_row * lanes.step, out_stride = out_row * lanes.step;
  // byte p - 8 of R[0] of the word's first message, in the input and in out
  const uint8_t* r_in = data + lanes.msg0 * in_row + (UNWRAP ? 8 : 0) + (p & 7);
  uint8_t* r_out = out + lanes.msg0 * out_row + 8 + (p & 7);

  uint32_t raw[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) raw[j] = 0u;
  uint32_t a[8];
  if constexpr (UNWRAP) {
    if (live && a_lane) fetch(raw, data + lanes.msg0 * in_row + p, in_stride);
    to_planes(raw, a);
  } else {
#pragma unroll
    for (int b = 0; b < 8; ++b) a[b] = (0xA6u >> b) & 1u ? kFull : 0u;
  }

  const int nsteps = 6 * n;
  int i = UNWRAP ? n - 1 : 0;  // step 0's semiblock
  if (live && !a_lane) fetch(raw, r_in + static_cast<size_t>(i) * 8, in_stride);
  for (int s = 0; s < nsteps; ++s) {
    uint32_t x[8];
    to_planes(raw, x);
    const int next = UNWRAP ? (i == 0 ? n - 1 : i - 1) : (i + 1 == n ? 0 : i + 1);
    if (live && !a_lane && s + 1 < nsteps) {
      if (s + 1 < n)  // the first pass over R reads the input
        fetch(raw, r_in + static_cast<size_t>(next) * 8, in_stride);
      else
        fetch_rw(raw, r_out + static_cast<size_t>(next) * 8, out_stride);
    }
    // byte p of BE64(t): t < 2^32, so only bytes 4..7 can be nonzero
    const uint32_t t = UNWRAP ? static_cast<uint32_t>(nsteps - s) : static_cast<uint32_t>(s + 1);
    const uint32_t tbyte = (p >= 4 && p < 8) ? (t >> (8 * (7 - p))) & 0xFFu : 0u;
    uint32_t tp[8], st[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) tp[b] = 0u - ((tbyte >> b) & 1u);
    if constexpr (UNWRAP) {
#pragma unroll
      for (int b = 0; b < 8; ++b) st[b] = a_lane ? a[b] ^ tp[b] : x[b];
      decrypt_spread(st, kp, rounds, src, row1, row2);
    } else {
#pragma unroll
      for (int b = 0; b < 8; ++b) st[b] = a_lane ? a[b] : x[b];
      encrypt_spread(st, kp, rounds, src, row1, row2);
    }
    if (a_lane) {
#pragma unroll
      for (int b = 0; b < 8; ++b) a[b] = UNWRAP ? st[b] : st[b] ^ tp[b];
    } else if (live) {
      store_planes(st, r_out + static_cast<size_t>(i) * 8, out_stride);
    }
    i = next;
  }
  if (live && a_lane) store_planes(a, out + lanes.msg0 * out_row + p, out_stride);
}

}  // namespace

extern "C" int micro_aes_kw_wheel(const uint32_t* kpw, const uint8_t* data, uint8_t* out,
                                  int unwrap, int rounds, int w, int n, int tile,
                                  cudaStream_t stream) {
  if (n < 2 || tile < 1 || w % tile) return static_cast<int>(cudaErrorInvalidValue);
  if (unwrap)
    kw_wheel_kernel<true><<<(w + 1) / 2, 32, 0, stream>>>(kpw, data, out, rounds, w, n, tile);
  else
    kw_wheel_kernel<false><<<(w + 1) / 2, 32, 0, stream>>>(kpw, data, out, rounds, w, n, tile);
  return static_cast<int>(cudaGetLastError());
}
