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
// The ragged entry (micro_aes_kw_ragged) runs words of different n and KEK
// sizes in one launch: kpw uint32[15*128, W] (the round keys padded to 15),
// and per word a descriptor int64[4] = (n, rounds | live << 8, msg0, off)
// (msg0 unused): slot j < live has its row of n+1 semiblocks at off +
// 8 (n+1) j of data
// and of out (to wrap, R in semiblocks 1..n and semiblock 0 unused).  The two
// words of a warp share n and rounds; an idle word (live 0) pads a run with
// an odd number of words.  The uniform entry is the same kernel with every
// word's descriptor computed from (n, rounds, tile).
//
// What bounds it on the card: the wheel.  Step s+1 needs step s's A, so the
// 6n ciphers of a message run one after another (384 at n = 64), and a batch
// has only W words of independent work: the layout is K13's
// (lane_spread.cuh), a word over the 16 lanes of a half-warp, a warp of two
// words alone on an SM sub-partition, and a step costs one warp's
// instruction stream.  The block A || R[i] needs no exchange between lanes:
// A's bytes stay in lanes 0..7 for the whole wheel, and lanes 8..15 take
// byte p - 8 of R[i] and give back the new R[i].  The BE64 step count is
// public, so its planes are all-ones or zero per lane.
//
// The first design (PR 8), counted on an H100 (tools/spread_ab.py sass): a
// round loop of 152 instructions (unwrap 181: 32 SHFL), and 760-800 more a
// step, where lanes 8..15 alone fetched R[i] with 32 one-byte loads from one
// of two places and stored it with 32 one-byte stores (206-239 IMAD a step
// of address arithmetic) while lanes 0..7 waited: at AES-128 a wrap step was
// ~2,130 instructions.  This design moves the semiblocks as rows, shared by
// the whole warp: lane q loads the next step's R of slot q of both words (two
// 8-byte loads, one step ahead), puts them in shared memory at the step, and
// every lane reads byte p of the 32 rows (lanes 0..7 read bytes they do not
// use instead of branching); the new R goes back the same way (two 8-byte
// stores per lane).  The rounds are unrolled for AES-128 (and AES-192 to
// wrap; lane_spread.cuh): a step of 1,733 instructions to wrap and 1,985 to
// unwrap at AES-128 (2,125 and 2,426 before); AES-256 keeps the rolled
// loop, which timed 11-17 % faster than its unrolled 2,300-2,700.  One
// kernel per direction picks the instance per warp from its words' rounds,
// for uniform and ragged launches alike.  The rows are not staged by
// cp.async here: later passes read semiblocks that the same thread stored
// to `out` a pass earlier, an ordering that plain loads keep.
//
// Where R lives: in `out`, not in shared memory.  JAX bounds n only by its
// VMEM budget, and R costs n * 512 bytes per warp of two words; global memory
// caps no n.  Lane q owns slot q's semiblocks of both words, so no other
// thread reads or writes them: it loads the next step's semiblock one step
// ahead, the first n steps (one pass over R) from the input, the rest from
// what an earlier step of the same thread stored in `out` (plain loads, not
// the read-only path).  That semiblock is never the one the current step
// stores, because n >= 2.  No address depends on key or data.
#include <cuda_runtime.h>

#include "lane_spread.cuh"

namespace {

using spread::kFull;
using spread::kKeyRows;
using spread::kStageRows;
using spread::kStageWord;
using spread::planes_from_stage;
using spread::stage_from_planes;

struct Args {
  const uint32_t* kpw;   // key plane q of word v at kpw[q * w + v]
  const int64_t* desc;   // ragged: int64[W, 4] per word; null: uniform
  const uint8_t* data;
  uint8_t* out;
  int rounds, w, n, tile;
};

// A word: `live` message slots; slot j's input row at in_off + j * in_stride
// (R[0] at in_r more), its output row at out_off + j * out_stride.
struct Word {
  int n, rounds, live, in_r;
  size_t in_off, in_stride, out_off, out_stride;
};

template <bool UNWRAP>
__device__ __forceinline__ Word word_of(const Args& a, int word) {
  Word d;
  if (a.desc != nullptr) {
    const int64_t* e = a.desc + 4 * static_cast<size_t>(word);
    d.n = static_cast<int>(e[0]);
    d.rounds = static_cast<int>(e[1] & 0xFF);
    d.live = static_cast<int>(e[1] >> 8);
    d.in_r = 8;
    d.in_off = d.out_off = static_cast<size_t>(e[3]);
    d.in_stride = d.out_stride = static_cast<size_t>(d.n + 1) * 8;
  } else {
    const bool live = word < a.w;  // an odd W leaves the last half-warp idle
    const spread::Lanes l = spread::lanes_of(live ? word : 0, a.tile);
    const size_t in_row = static_cast<size_t>(UNWRAP ? a.n + 1 : a.n) * 8;
    const size_t out_row = static_cast<size_t>(a.n + 1) * 8;
    d.n = a.n;
    d.rounds = a.rounds;
    d.live = live ? 32 : 0;
    d.in_r = UNWRAP ? 8 : 0;
    d.in_off = l.msg0 * in_row;
    d.in_stride = in_row * l.step;
    d.out_off = l.msg0 * out_row;
    d.out_stride = out_row * l.step;
  }
  return d;
}

// The 6n steps of the warp's two words.  Lane q moves the semiblocks of slot
// q of both words (r[h] holds the next step's R), lane p = q & 15 of half h
// computes byte p of word h's block A || R[i].
template <bool UNWRAP, int ROUNDS>
__device__ __forceinline__ void wheel_steps(const Args& a, const Word (&wd)[2], const uint4* kq,
                                            uint4* in_st, uint4* out_st) {
  const int lane = threadIdx.x, half = lane >> 4, p = lane & 15;
  const int n = wd[0].n, rounds = wd[0].rounds;
  const int src = UNWRAP ? uaes::inv_shift_src(p) : uaes::shift_src(p);
  const int row1 = 4 * (p / 4) + (p + 1) % 4, row2 = 4 * (p / 4) + (p + 2) % 4;
  const uint8_t* my_in = reinterpret_cast<const uint8_t*>(in_st) + half * kStageWord + p;
  uint8_t* my_out = reinterpret_cast<uint8_t*>(out_st) + half * kStageWord + p;
  uint2* in_rows = reinterpret_cast<uint2*>(in_st);    // semiblock c of row j: [2j + c]
  const uint2* out_rows = reinterpret_cast<const uint2*>(out_st);
  const int hw = kStageWord / 8;                       // uint2 per word of the stage
  const bool mine[2] = {lane < wd[0].live, lane < wd[1].live};
  const uint8_t* in[2];
  uint8_t* out[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    in[h] = a.data + wd[h].in_off + lane * wd[h].in_stride;
    out[h] = a.out + wd[h].out_off + lane * wd[h].out_stride;
  }
  const bool a_lane = p < 8;  // lanes 0..7 hold A, lanes 8..15 byte p - 8 of R[i]

  uint32_t av[8];
  if constexpr (UNWRAP) {  // A starts at the wrapped input's first semiblock
#pragma unroll
    for (int h = 0; h < 2; ++h)
      in_rows[h * hw + 2 * lane] =
          mine[h] ? *reinterpret_cast<const uint2*>(in[h]) : make_uint2(0u, 0u);
    __syncwarp();
    planes_from_stage(my_in, av);
  } else {
#pragma unroll
    for (int b = 0; b < 8; ++b) av[b] = (0xA6u >> b) & 1u ? kFull : 0u;
  }

  const int nsteps = 6 * n;
  int i = UNWRAP ? n - 1 : 0;  // step 0's semiblock
  uint2 r[2] = {};
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (mine[h]) r[h] = *reinterpret_cast<const uint2*>(in[h] + wd[h].in_r + i * 8);
  for (int s = 0; s < nsteps; ++s) {
    __syncwarp();  // the previous step's stage reads are done
    in_rows[2 * lane + 1] = r[0];
    in_rows[hw + 2 * lane + 1] = r[1];
    __syncwarp();
    uint32_t x[8];
    planes_from_stage(my_in, x);
    const int next = UNWRAP ? (i == 0 ? n - 1 : i - 1) : (i + 1 == n ? 0 : i + 1);
    if (s + 1 < nsteps) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (mine[h])  // the first pass over R reads the input, later ones out
          r[h] = s + 1 < n ? *reinterpret_cast<const uint2*>(in[h] + wd[h].in_r + next * 8)
                           : *reinterpret_cast<const uint2*>(out[h] + 8 + next * 8);
    }
    // byte p of BE64(t): t < 2^32, so only bytes 4..7 can be nonzero
    const uint32_t t = UNWRAP ? static_cast<uint32_t>(nsteps - s) : static_cast<uint32_t>(s + 1);
    const uint32_t tbyte = (p >= 4 && p < 8) ? (t >> (8 * (7 - p))) & 0xFFu : 0u;
    uint32_t tp[8], st[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) tp[b] = 0u - ((tbyte >> b) & 1u);
    if constexpr (UNWRAP) {
#pragma unroll
      for (int b = 0; b < 8; ++b) st[b] = a_lane ? av[b] ^ tp[b] : x[b];
      spread::decrypt_rounds<ROUNDS>(st, kq, rounds, src, row1, row2);
    } else {
#pragma unroll
      for (int b = 0; b < 8; ++b) st[b] = a_lane ? av[b] : x[b];
      spread::encrypt_rounds<ROUNDS>(st, kq, rounds, src, row1, row2);
    }
#pragma unroll
    for (int b = 0; b < 8; ++b) av[b] = UNWRAP ? st[b] : st[b] ^ tp[b];  // used in lanes 0..7
    stage_from_planes(st, my_out);
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (mine[h]) *reinterpret_cast<uint2*>(out[h] + 8 + i * 8) = out_rows[h * hw + 2 * lane + 1];
    i = next;
  }
  __syncwarp();
  stage_from_planes(av, my_out);
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (mine[h]) *reinterpret_cast<uint2*>(out[h]) = out_rows[h * hw + 2 * lane];
}

// The instance of the rounds a key size runs: unrolled for AES-128 (and
// AES-192 to wrap) while a step stays under ~2,150 instructions; a longer
// unrolled step ran slower than the rolled loop (0) on an H100 (PERF.md).
template <bool UNWRAP>
__host__ __device__ constexpr int instance(int rounds) {
  return rounds == 10 || (rounds == 12 && !UNWRAP) ? rounds : 0;
}

template <bool UNWRAP>
__global__ void __launch_bounds__(32) kw_wheel_kernel(Args a) {
  __shared__ uint4 keys[2 * kKeyRows];
  __shared__ uint4 in_st[kStageRows], out_st[kStageRows];
  const int half = threadIdx.x >> 4, p = threadIdx.x & 15;
  const Word wd[2] = {word_of<UNWRAP>(a, 2 * blockIdx.x), word_of<UNWRAP>(a, 2 * blockIdx.x + 1)};
  uint4* mine = keys + half * kKeyRows;
  const Word me = half ? wd[1] : wd[0];  // a select, not a local-memory index
  spread::stage_keys(mine, a.kpw, a.w, 2 * blockIdx.x + half, me.rounds, me.live > 0, p);
  __syncwarp();
  const uint4* kq = mine + p;
  if (wd[0].rounds == 10)  // the same in both words of the warp
    wheel_steps<UNWRAP, 10>(a, wd, kq, in_st, out_st);
  else if (wd[0].rounds == 12)
    wheel_steps<UNWRAP, instance<UNWRAP>(12)>(a, wd, kq, in_st, out_st);
  else
    wheel_steps<UNWRAP, 0>(a, wd, kq, in_st, out_st);
}

int launch(const Args& a, int unwrap, int grid, cudaStream_t stream) {
  if (unwrap)
    kw_wheel_kernel<true><<<grid, 32, 0, stream>>>(a);
  else
    kw_wheel_kernel<false><<<grid, 32, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned8(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 7u) == 0; }

}  // namespace

// The uniform entry: B = 32W messages of n semiblocks, one KEK size.
extern "C" int micro_aes_kw_wheel(const uint32_t* kpw, const uint8_t* data, uint8_t* out,
                                  int unwrap, int rounds, int w, int n, int tile,
                                  cudaStream_t stream) {
  if (n < 2 || tile < 1 || w % tile || !aligned8(data) || !aligned8(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{kpw, nullptr, data, out, rounds, w, n, tile};
  return launch(a, unwrap, (w + 1) / 2, stream);
}

// The ragged entry: W words (even) under the descriptors `desc`, n >= 2 each.
extern "C" int micro_aes_kw_ragged(const uint32_t* kpw, const int64_t* desc,
                                   const uint8_t* data, uint8_t* out, int unwrap, int w,
                                   cudaStream_t stream) {
  if (w % 2 || !aligned8(data) || !aligned8(out)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{kpw, desc, data, out, 0, w, 0, 1};
  return launch(a, unwrap, w / 2, stream);
}
