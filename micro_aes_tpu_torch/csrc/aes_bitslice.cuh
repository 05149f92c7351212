// Bitsliced AES building blocks shared by the port's kernels
// (cipher_planes.cu, seal_fused.cu, ctr_fused.cu, multikey.cu, gcm_chain.cu,
// siv_fused.cu, xex_fused.cu).
//
// One thread owns one 32-block group: the 128 state bits of 32 blocks are
// 128 plane words s[b][p] (bit b of byte position p, bit j of the word =
// block j), held in registers.  SubBytes is the Boyar-Peralta circuit (the
// inverse is the derived program of core/bitslice.py, emitted into
// sbox_inv.cuh), ShiftRows is a compile-time register renaming,
// MixColumns a few XORs per plane, AddRoundKey an XOR with broadcast
// 0/0xFFFFFFFF key planes read from shared memory at addresses that depend
// only on the round and the plane index.  No address depends on key or
// data: the kernels are constant time like the TPU kernels they replace.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace uaes {

constexpr int kMaxRounds = 14;
constexpr int kMaxKeyPlaneWords = (kMaxRounds + 1) * 128;

// ---------------------------------------------------------------------------
// S-box: Boyar & Peralta, "A new combinational logic minimization technique
// with applications to cryptology" (SEA 2010).  Inputs/outputs are
// LSB-first planes x[0..7]; the netlist's U/S vectors are MSB-first.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void bp_top(const uint32_t (&x)[8], uint32_t (&y)[22]) {
  const uint32_t u0 = x[7], u1 = x[6], u2 = x[5], u3 = x[4];
  const uint32_t u4 = x[3], u5 = x[2], u6 = x[1], u7 = x[0];
  const uint32_t y14 = u3 ^ u5;
  const uint32_t y13 = u0 ^ u6;
  const uint32_t y9 = u0 ^ u3;
  const uint32_t y8 = u0 ^ u5;
  const uint32_t t0 = u1 ^ u2;
  const uint32_t y1 = t0 ^ u7;
  const uint32_t y4 = y1 ^ u3;
  const uint32_t y12 = y13 ^ y14;
  const uint32_t y2 = y1 ^ u0;
  const uint32_t y5 = y1 ^ u6;
  const uint32_t y3 = y5 ^ y8;
  const uint32_t t1 = u4 ^ y12;
  const uint32_t y15 = t1 ^ u5;
  const uint32_t y20 = t1 ^ u1;
  const uint32_t y6 = y15 ^ u7;
  const uint32_t y10 = y15 ^ t0;
  const uint32_t y11 = y20 ^ y9;
  const uint32_t y7 = u7 ^ y11;
  const uint32_t y17 = y10 ^ y11;
  const uint32_t y19 = y10 ^ y8;
  const uint32_t y16 = t0 ^ y11;
  const uint32_t y21 = y13 ^ y16;
  const uint32_t y18 = u0 ^ y16;
  y[0] = y1;   y[1] = y2;   y[2] = y3;   y[3] = y4;   y[4] = y5;
  y[5] = y6;   y[6] = y7;   y[7] = y8;   y[8] = y9;   y[9] = y10;
  y[10] = y11; y[11] = y12; y[12] = y13; y[13] = y14; y[14] = y15;
  y[15] = y16; y[16] = y17; y[17] = y18; y[18] = y19; y[19] = y20;
  y[20] = y21; y[21] = u7;
}

// Shared nonlinear middle: GF(2^8) inversion in the circuit's basis.
__device__ __forceinline__ void bp_middle(const uint32_t (&y)[22], uint32_t (&z)[18]) {
  const uint32_t y1 = y[0], y2 = y[1], y3 = y[2], y4 = y[3], y5 = y[4];
  const uint32_t y6 = y[5], y7 = y[6], y8 = y[7], y9 = y[8], y10 = y[9];
  const uint32_t y11 = y[10], y12 = y[11], y13 = y[12], y14 = y[13];
  const uint32_t y15 = y[14], y16 = y[15], y17 = y[16], y18 = y[17];
  const uint32_t y19 = y[18], y20 = y[19], y21 = y[20], u7 = y[21];
  const uint32_t t2 = y12 & y15;
  const uint32_t t3 = y3 & y6;
  const uint32_t t4 = t3 ^ t2;
  const uint32_t t5 = y4 & u7;
  const uint32_t t6 = t5 ^ t2;
  const uint32_t t7 = y13 & y16;
  const uint32_t t8 = y5 & y1;
  const uint32_t t9 = t8 ^ t7;
  const uint32_t t10 = y2 & y7;
  const uint32_t t11 = t10 ^ t7;
  const uint32_t t12 = y9 & y11;
  const uint32_t t13 = y14 & y17;
  const uint32_t t14 = t13 ^ t12;
  const uint32_t t15 = y8 & y10;
  const uint32_t t16 = t15 ^ t12;
  const uint32_t t17 = t4 ^ t14;
  const uint32_t t18 = t6 ^ t16;
  const uint32_t t19 = t9 ^ t14;
  const uint32_t t20 = t11 ^ t16;
  const uint32_t t21 = t17 ^ y20;
  const uint32_t t22 = t18 ^ y19;
  const uint32_t t23 = t19 ^ y21;
  const uint32_t t24 = t20 ^ y18;
  const uint32_t t25 = t21 ^ t22;
  const uint32_t t26 = t21 & t23;
  const uint32_t t27 = t24 ^ t26;
  const uint32_t t28 = t25 & t27;
  const uint32_t t29 = t28 ^ t22;
  const uint32_t t30 = t23 ^ t24;
  const uint32_t t31 = t22 ^ t26;
  const uint32_t t32 = t31 & t30;
  const uint32_t t33 = t32 ^ t24;
  const uint32_t t34 = t23 ^ t33;
  const uint32_t t35 = t27 ^ t33;
  const uint32_t t36 = t24 & t35;
  const uint32_t t37 = t36 ^ t34;
  const uint32_t t38 = t27 ^ t36;
  const uint32_t t39 = t29 & t38;
  const uint32_t t40 = t25 ^ t39;
  const uint32_t t41 = t40 ^ t37;
  const uint32_t t42 = t29 ^ t33;
  const uint32_t t43 = t29 ^ t40;
  const uint32_t t44 = t33 ^ t37;
  const uint32_t t45 = t42 ^ t41;
  z[0] = t44 & y15;  z[1] = t37 & y6;   z[2] = t33 & u7;   z[3] = t43 & y16;
  z[4] = t40 & y1;   z[5] = t29 & y7;   z[6] = t42 & y11;  z[7] = t45 & y17;
  z[8] = t41 & y10;  z[9] = t44 & y12;  z[10] = t37 & y3;  z[11] = t33 & y4;
  z[12] = t43 & y13; z[13] = t40 & y5;  z[14] = t29 & y2;  z[15] = t42 & y9;
  z[16] = t45 & y14; z[17] = t41 & y8;
}

__device__ __forceinline__ void bp_bottom(const uint32_t (&z)[18], uint32_t (&x)[8]) {
  const uint32_t t46 = z[15] ^ z[16];
  const uint32_t t47 = z[10] ^ z[11];
  const uint32_t t48 = z[5] ^ z[13];
  const uint32_t t49 = z[9] ^ z[10];
  const uint32_t t50 = z[2] ^ z[12];
  const uint32_t t51 = z[2] ^ z[5];
  const uint32_t t52 = z[7] ^ z[8];
  const uint32_t t53 = z[0] ^ z[3];
  const uint32_t t54 = z[6] ^ z[7];
  const uint32_t t55 = z[16] ^ z[17];
  const uint32_t t56 = z[12] ^ t48;
  const uint32_t t57 = t50 ^ t53;
  const uint32_t t58 = z[4] ^ t46;
  const uint32_t t59 = z[3] ^ t54;
  const uint32_t t60 = t46 ^ t57;
  const uint32_t t61 = z[14] ^ t57;
  const uint32_t t62 = t52 ^ t58;
  const uint32_t t63 = t49 ^ t58;
  const uint32_t t64 = z[4] ^ t59;
  const uint32_t t65 = t61 ^ t62;
  const uint32_t t66 = z[1] ^ t63;
  const uint32_t s0 = t59 ^ t63;
  const uint32_t s6 = ~(t56 ^ t62);
  const uint32_t s7 = ~(t48 ^ t60);
  const uint32_t t67 = t64 ^ t65;
  const uint32_t s3 = t53 ^ t66;
  const uint32_t s4 = t51 ^ t66;
  const uint32_t s5 = t47 ^ t65;
  const uint32_t s1 = ~(t64 ^ s3);
  const uint32_t s2 = ~(t55 ^ t67);
  x[7] = s0; x[6] = s1; x[5] = s2; x[4] = s3;
  x[3] = s4; x[2] = s5; x[1] = s6; x[0] = s7;
}

}  // namespace uaes

#include "sbox_inv.cuh"  // uaes::inv_top / uaes::inv_bottom (generated)

namespace uaes {

__device__ __forceinline__ void sbox_fwd(uint32_t (&x)[8]) {
  uint32_t y[22], z[18];
  bp_top(x, y);
  bp_middle(y, z);
  bp_bottom(z, x);
}

__device__ __forceinline__ void sbox_inv(uint32_t (&x)[8]) {
  uint32_t y[22], z[18];
  inv_top(x, y);
  bp_middle(y, z);
  inv_bottom(z, x);
}

// Byte position p = 4*col + row.  ShiftRows: out[p] = in[shift_src(p)].
__host__ __device__ constexpr int shift_src(int p) {
  return 4 * ((p / 4 + p % 4) % 4) + p % 4;
}
__host__ __device__ constexpr int inv_shift_src(int p) {
  return 4 * ((p / 4 - p % 4 + 4) % 4) + p % 4;
}

// GF(2^8) doubling on 8 planes: y = x<<1 ^ 0x1b*(x>>7).
__device__ __forceinline__ void xtime(const uint32_t (&v)[8], uint32_t (&o)[8]) {
  o[0] = v[7];
  o[1] = v[0] ^ v[7];
  o[2] = v[1];
  o[3] = v[2] ^ v[7];
  o[4] = v[3] ^ v[7];
  o[5] = v[4];
  o[6] = v[5];
  o[7] = v[6];
}

__device__ __forceinline__ void sub_bytes(uint32_t (&s)[8][16]) {
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    uint32_t x[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) x[b] = s[b][p];
    sbox_fwd(x);
#pragma unroll
    for (int b = 0; b < 8; ++b) s[b][p] = x[b];
  }
}

__device__ __forceinline__ void inv_sub_bytes(uint32_t (&s)[8][16]) {
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    uint32_t x[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) x[b] = s[b][p];
    sbox_inv(x);
#pragma unroll
    for (int b = 0; b < 8; ++b) s[b][p] = x[b];
  }
}

template <bool INVERSE>
__device__ __forceinline__ void shift_rows(uint32_t (&s)[8][16]) {
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    uint32_t t[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) t[p] = s[b][INVERSE ? inv_shift_src(p) : shift_src(p)];
#pragma unroll
    for (int p = 0; p < 16; ++p) s[b][p] = t[p];
  }
}

// MixColumns: out_r = 2 s_r ^ 3 s_{r+1} ^ s_{r+2} ^ s_{r+3}
//                   = xtime(s_r ^ s_{r+1}) ^ s_r ^ (s_0 ^ s_1 ^ s_2 ^ s_3).
__device__ __forceinline__ void mix_columns(uint32_t (&s)[8][16]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t o[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p0 = 4 * c + r, p1 = 4 * c + (r + 1) % 4;
      uint32_t d[8], x[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) d[b] = s[b][p0] ^ s[b][p1];
      xtime(d, x);
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const uint32_t col = s[b][4 * c] ^ s[b][4 * c + 1] ^ s[b][4 * c + 2] ^ s[b][4 * c + 3];
        o[r][b] = x[b] ^ s[b][p0] ^ col;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int b = 0; b < 8; ++b) s[b][4 * c + r] = o[r][b];
  }
}

// InvMixColumns = MixColumns o (column multiply by d(z) = {04}z^2 + {05}),
// since c(z) d(z) = c^-1(z) mod z^4 + 1.
__device__ __forceinline__ void inv_mix_columns(uint32_t (&s)[8][16]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t x4[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t v[8], x2[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) v[b] = s[b][4 * c + r];
      xtime(v, x2);
      xtime(x2, x4[r]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int b = 0; b < 8; ++b) s[b][4 * c + r] ^= x4[r][b] ^ x4[(r + 2) % 4][b];
  }
  mix_columns(s);
}

__device__ __forceinline__ void add_round_key(uint32_t (&s)[8][16], const uint32_t* kps, int r) {
  const uint32_t* k = kps + r * 128;
#pragma unroll
  for (int b = 0; b < 8; ++b)
#pragma unroll
    for (int p = 0; p < 16; ++p) s[b][p] ^= k[b * 16 + p];
}

// Where the round keys come from.  Each source has add(s, r), the
// AddRoundKey of round r; the addresses depend on the round only.
//
// One key's broadcast planes, (rounds+1)*128 words in shared memory.
struct SmemKeyPlanes {
  const uint32_t* kps;
  __device__ __forceinline__ void add(uint32_t (&s)[8][16], int r) const { add_round_key(s, kps, r); }
};

// Lane-packed planes (a key per lane): word column `col` of a
// [(rounds+1)*128, stride] array in device memory.
struct LaneKeyPlanes {
  const uint32_t* kpw;
  int stride;
  int col;
  __device__ __forceinline__ void add(uint32_t (&s)[8][16], int r) const {
#pragma unroll
    for (int b = 0; b < 8; ++b)
#pragma unroll
      for (int p = 0; p < 16; ++p)
        s[b][p] ^= __ldg(kpw + static_cast<size_t>(r * 128 + b * 16 + p) * stride + col);
  }
};

template <class Key>
__device__ __forceinline__ void encrypt_with(uint32_t (&s)[8][16], const Key& key, int rounds) {
  key.add(s, 0);
#pragma unroll 1
  for (int r = 1; r < rounds; ++r) {
    sub_bytes(s);
    shift_rows<false>(s);
    mix_columns(s);
    key.add(s, r);
  }
  sub_bytes(s);
  shift_rows<false>(s);
  key.add(s, rounds);
}

template <class Key>
__device__ __forceinline__ void decrypt_with(uint32_t (&s)[8][16], const Key& key, int rounds) {
  key.add(s, rounds);
#pragma unroll 1
  for (int r = rounds - 1; r > 0; --r) {
    shift_rows<true>(s);
    inv_sub_bytes(s);
    key.add(s, r);
    inv_mix_columns(s);
  }
  shift_rows<true>(s);
  inv_sub_bytes(s);
  key.add(s, 0);
}

// kps: (rounds+1)*128 key-plane words in shared memory.
__device__ __forceinline__ void encrypt_state(uint32_t (&s)[8][16], const uint32_t* kps, int rounds) {
  encrypt_with(s, SmemKeyPlanes{kps}, rounds);
}

__device__ __forceinline__ void decrypt_state(uint32_t (&s)[8][16], const uint32_t* kps, int rounds) {
  decrypt_with(s, SmemKeyPlanes{kps}, rounds);
}

// Cooperative copy of n words from device memory into shared memory.
__device__ __forceinline__ void copy_to_smem(const uint32_t* __restrict__ src, uint32_t* dst, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// LSB-first 32x32 bit transpose (Hacker's Delight butterfly, 5 stages):
// out[i] bit j == in[j] bit i.
__device__ __forceinline__ void transpose32(uint32_t (&a)[32]) {
#pragma unroll
  for (int stage = 0; stage < 5; ++stage) {
    const int j = 16 >> stage;
    const uint32_t m = stage == 0 ? 0x0000FFFFu
                     : stage == 1 ? 0x00FF00FFu
                     : stage == 2 ? 0x0F0F0F0Fu
                     : stage == 3 ? 0x33333333u
                                  : 0x55555555u;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int k = ((i & ~(j - 1)) << 1) | (i & (j - 1));  // bit j of k clear
      const uint32_t t = ((a[k] >> j) ^ a[k + j]) & m;
      a[k] ^= t << j;
      a[k + j] ^= t;
    }
  }
}

// ---------------------------------------------------------------------------
// The w-major stream: row w of a uint32[W, 128] stream holds blocks
// 32w..32w+31, lane 4j+k = little-endian word k of block 32w+j.  A block of
// ROWS threads stages ROWS rows in shared memory (row stride 129 words, so a
// thread walking its own row hits 32 distinct banks across the warp), one
// row per thread.
// ---------------------------------------------------------------------------

constexpr int kStageStride = 129;

__device__ __forceinline__ void stage_rows_in(const uint32_t* __restrict__ src, uint32_t* stage,
                                              int w0, int rows, int w) {
  const uint4* src4 = reinterpret_cast<const uint4*>(src);
  for (int i = threadIdx.x; i < rows * 32; i += blockDim.x) {
    const int r = i >> 5, c4 = i & 31;
    const int gw = w0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gw < w) v = __ldg(src4 + static_cast<size_t>(gw) * 32 + c4);
    uint32_t* d = stage + r * kStageStride + 4 * c4;
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  }
}

__device__ __forceinline__ void stage_rows_out(const uint32_t* stage, uint32_t* __restrict__ dst,
                                               int w0, int rows, int w) {
  uint4* dst4 = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < rows * 32; i += blockDim.x) {
    const int r = i >> 5, c4 = i & 31;
    const int gw = w0 + r;
    if (gw < w) {
      const uint32_t* s = stage + r * kStageStride + 4 * c4;
      dst4[static_cast<size_t>(gw) * 32 + c4] = make_uint4(s[0], s[1], s[2], s[3]);
    }
  }
}

// GCM counter planes of one row (ops/counter.counter_planes_be in plane
// form): byte positions 0..8 broadcast J0's bits (j0c: 128 words of
// 0/0xFFFFFFFF, index b*16+p), bits 0..4 of the 32-aligned counter are fixed
// lane patterns, bits 5..31 broadcast from lo and bits 32..55 from the
// 24-bit extension hi (bytes 9..11).
__host__ __device__ constexpr uint32_t low_bit_pattern(int k) {
  return k == 0 ? 0xAAAAAAAAu : k == 1 ? 0xCCCCCCCCu : k == 2 ? 0xF0F0F0F0u
       : k == 3 ? 0xFF00FF00u : 0xFFFF0000u;
}

__device__ __forceinline__ void counter_planes(uint32_t (&s)[8][16], const uint32_t* j0c,
                                               uint32_t lo, uint32_t hi) {
#pragma unroll
  for (int b = 0; b < 8; ++b) {
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      if (p <= 8) {
        s[b][p] = j0c[b * 16 + p];
      } else if (p >= 12) {
        const int k = 8 * (15 - p) + b;
        s[b][p] = k < 5 ? low_bit_pattern(k) : 0u - ((lo >> k) & 1u);
      } else {
        const int k = 8 * (11 - p) + b;
        s[b][p] = 0u - ((hi >> k) & 1u);
      }
    }
  }
}

// The planes of a staged row's 32 blocks: s[b][p] bit j = bit b of byte p of
// block j, where row[4j+k] = little-endian word k of block j.
__device__ __forceinline__ void row_to_planes(uint32_t (&s)[8][16], const uint32_t* row) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t a[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) a[j] = row[4 * j + k];
    transpose32(a);  // a[r] = plane of bit r of word k
#pragma unroll
    for (int r = 0; r < 32; ++r) s[r % 8][4 * k + r / 8] = a[r];
  }
}

// a[j] = word k of block j of the stream, in place: the keystream planes of
// word k from ks XORed on in the plane domain.  When KEEP is set, those
// planes of ks are overwritten with the GHASH-side planes: the input planes
// if BITS_FROM_INPUT (GCM open), else the output planes (seal).
template <bool KEEP, bool BITS_FROM_INPUT>
__device__ __forceinline__ void xor_stream_word(uint32_t (&ks)[8][16], int k, uint32_t (&a)[32]) {
  transpose32(a);  // a[r] = plane of bit r of word k: (b, p) = (r%8, 4k + r/8)
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const int b = r % 8, p = 4 * k + r / 8;
    const uint32_t in = a[r];
    a[r] = in ^ ks[b][p];
    if (KEEP) ks[b][p] = BITS_FROM_INPUT ? in : a[r];
  }
  transpose32(a);
}

// XOR the keystream planes ks onto this thread's staged row, in place
// (KEEP and BITS_FROM_INPUT as for xor_stream_word).
template <bool KEEP, bool BITS_FROM_INPUT>
__device__ __forceinline__ void xor_stream_row(uint32_t (&ks)[8][16], uint32_t* row) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t a[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) a[j] = row[4 * j + k];
    xor_stream_word<KEEP, BITS_FROM_INPUT>(ks, k, a);
#pragma unroll
    for (int j = 0; j < 32; ++j) row[4 * j + k] = a[j];
  }
}

// ---------------------------------------------------------------------------
// The transposed stream: uint32[128, W], word (lane l, row w) at l*W + w,
// lane 4j+k = little-endian word k of block 32w+j (the layout the JAX
// package's _t kernels take on the TPU).  A thread owns row w as in the
// w-major form, and reads lane l of its row at l*W + w: across a warp the 32
// threads of 32 neighbouring rows touch 32 neighbouring words, one coalesced
// 128-byte access, so this form needs no staging and no transpose.  The
// bodies below take the form as a template parameter: kRows is the w-major
// stream staged in shared memory (K1, K3, K5, K5-open, K8), kColumns the
// transposed one read and written in place (K1t, K5t; K4t's level-1 operand
// in siv_fused.cu).
// ---------------------------------------------------------------------------

enum class StreamForm { kRows, kColumns };

// K1t's keystream XOR: xor_stream_row<true, BITS_FROM_INPUT> on this
// thread's row of the transposed stream, read from `in` and written to
// `out` straight (lane 4j+k at (4j+k)*w + row); a row at or past w is
// neither read nor stored.
template <bool BITS_FROM_INPUT>
__device__ __forceinline__ void xor_stream_column(uint32_t (&ks)[8][16],
                                                  const uint32_t* __restrict__ in,
                                                  uint32_t* __restrict__ out, int row, int w,
                                                  bool live) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t a[32];
#pragma unroll
    for (int j = 0; j < 32; ++j)
      a[j] = live ? __ldg(in + static_cast<size_t>(4 * j + k) * w + row) : 0u;
    xor_stream_word<true, BITS_FROM_INPUT>(ks, k, a);
    if (live) {
#pragma unroll
      for (int j = 0; j < 32; ++j) out[static_cast<size_t>(4 * j + k) * w + row] = a[j];
    }
  }
}

// Word k of the 32 blocks whose planes are s: a[j] = word k of block j.
// The planes of word k, (b, p) = (r % 8, 4k + r / 8) for its bit r, are
// gathered by compile-time renaming.
__device__ __forceinline__ void plane_word(const uint32_t (&s)[8][16], int k, uint32_t (&a)[32]) {
#pragma unroll
  for (int r = 0; r < 32; ++r) a[r] = s[r % 8][4 * k + r / 8];
  transpose32(a);
}

// The word-domain XOR of K6-K8 (xex_fused.cu): slot ^= the words of the
// planes s (slot rows kStageStride apart, so word by word).
__device__ __forceinline__ void xor_planes_into_row(const uint32_t (&s)[8][16], uint32_t* slot) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t a[32];
    plane_word(s, k, a);
#pragma unroll
    for (int j = 0; j < 32; ++j) slot[4 * j + k] ^= a[j];
  }
}

// The planes s turned into words in place (4 transposes, each over the 32
// planes of one word): afterwards s[j % 8][4k + j / 8] is word k of block j.
__device__ __forceinline__ void planes_to_words(uint32_t (&s)[8][16]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t a[32];
    plane_word(s, k, a);
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j % 8][4 * k + j / 8] = a[j];
  }
}

// The word-domain XOR of K3 and K5: a staged row (16-byte aligned) ^= the
// words that planes_to_words left in s, one LDS.128, 4 XORs and one STS.128
// a block.
__device__ __forceinline__ void xor_words_into_row(const uint32_t (&s)[8][16], uint32_t* row) {
  uint4* r4 = reinterpret_cast<uint4*>(row);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    uint4 v = r4[j];
    v.x ^= s[j % 8][j / 8];
    v.y ^= s[j % 8][4 + j / 8];
    v.z ^= s[j % 8][8 + j / 8];
    v.w ^= s[j % 8][12 + j / 8];
    r4[j] = v;
  }
}

// The word-domain XOR of K5t: lane 4j+k of this thread's row of the
// transposed stream, in[(4j+k)*w + row], ^= word k of block j as
// planes_to_words left it in s, out to out[(4j+k)*w + row].  The 32 loads of
// a word k are issued together before its stores: loads interleaved with
// stores waited one memory round trip a word (PERF.md).
__device__ __forceinline__ void xor_words_column(const uint32_t (&s)[8][16],
                                                 const uint32_t* __restrict__ in,
                                                 uint32_t* __restrict__ out, int row, int w) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t a[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) a[j] = __ldg(in + static_cast<size_t>(4 * j + k) * w + row);
#pragma unroll
    for (int j = 0; j < 32; ++j)
      out[static_cast<size_t>(4 * j + k) * w + row] = a[j] ^ s[j % 8][4 * k + j / 8];
  }
}

// ---------------------------------------------------------------------------
// Level 1 on the binary tensor cores (K1, K5-open, K4).  The level-1
// GHASH/POLYVAL partial of a 32-block row (ops/ghash_bulk level 1) is
// s1[o, row] = parity(popc(A_o AND B_row)) over 4,096 bits, with A_o = W1p's
// row o (the lane-packed table, ghash_bulk.pack_level1: word q, bit j) and
// B_row = the row's 128 planes (plane q = b*16 + p, bit j) masked by ghm
// (bit j set = block j counts): both pack bit j of word q at the same place,
// so the product needs no repacking.  Any permutation of the 4,096 bits
// applied to both gives the same product: K4 passes the row's masked words
// as they are and W1p permuted to match (siv_fused.cu).  mma.sync m16n8k256 .b1 .and.popc takes 16
// outputs x 8 rows x 256 bits a call; a warp covers its 32 rows x 128 outputs in 512 calls,
// reading both operands from shared memory with ldmatrix (the b1 fragments
// have the bytes of the s8 m16n8k32 ones).  Rows of W1p and of the staged
// planes lie kL1Stride words apart, so the 8 rows of an ldmatrix phase fall
// on 32 distinct banks.
// ---------------------------------------------------------------------------

constexpr int kL1Stride = 132;
constexpr int kL1Tile = 36;  // bytes per output in the parity tile: 8 outputs on 8 banks

// This thread's planes, masked by ghm (bit j set = block j counts), as its
// row of the staged B operand (`row` 16-byte aligned).
__device__ __forceinline__ void stage_level1_row(const uint32_t (&s)[8][16], uint32_t ghm,
                                                 uint32_t* row) {
  uint4* r4 = reinterpret_cast<uint4*>(row);
#pragma unroll
  for (int q4 = 0; q4 < 32; ++q4) {
    const int q = 4 * q4;
    r4[q4] = make_uint4(s[q / 16][q % 16] & ghm, s[q / 16][q % 16 + 1] & ghm,
                        s[q / 16][q % 16 + 2] & ghm, s[q / 16][q % 16 + 3] & ghm);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const uint32_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_and_popc(uint32_t (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// s1[o, row0 + n] for the warp's 32 staged rows n (`rows`, kL1Stride apart)
// and all 128 outputs o, W1p in `w1s` (kL1Stride apart); rows at or past w
// are not stored.  Two passes of 16 rows keep 64 accumulators live; the
// parity of a popcount sum is the parity of the AND.  The parities go
// through a byte tile [o][n] over the warp's first rows (read by then), so
// that each store writes 32 neighbouring bytes of s1.
__device__ __forceinline__ void level1_mma_warp(const uint32_t* w1s, uint32_t* rows,
                                                int8_t* __restrict__ s1, int row0, int w) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int m = lane >> 3, r = lane & 7;  // the ldmatrix row this lane addresses
  uint8_t* tile = reinterpret_cast<uint8_t*>(rows);
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    uint32_t acc[8][2][4];
#pragma unroll
    for (int mt = 0; mt < 8; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0u;
    // B: matrices (n-tile 0, words 0-3), (0, 4-7), (1, 0-3), (1, 4-7) of the chunk
    const uint32_t* pb = rows + (16 * pass + 8 * (m >> 1) + r) * kL1Stride + 4 * (m & 1);
    // A: matrices (outputs 0-7, words 0-3), (8-15, 0-3), (0-7, 4-7), (8-15, 4-7)
    const uint32_t* pa = w1s + (8 * (m & 1) + r) * kL1Stride + 4 * (m >> 1);
#pragma unroll 2
    for (int kc = 0; kc < 16; ++kc) {
      uint32_t b[4];
      ldmatrix_x4(b, pb + 8 * kc);
#pragma unroll
      for (int mt = 0; mt < 8; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, pa + 16 * mt * kL1Stride + 8 * kc);
        mma_and_popc(acc[mt][0], a, b[0], b[1]);
        mma_and_popc(acc[mt][1], a, b[2], b[3]);
      }
    }
    __syncwarp();  // rows 0..15 are read: the tile may overwrite them
    // acc[mt][nt] = D rows (outputs) 16 mt + g (+8 for i >= 2), columns (rows)
    // 16 pass + 8 nt + 2 tig (+1 for odd i)
#pragma unroll
    for (int mt = 0; mt < 8; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          tile[(16 * mt + g + 8 * (i >> 1)) * kL1Tile + 16 * pass + 8 * nt + 2 * tig + (i & 1)] =
              static_cast<uint8_t>(acc[mt][nt][i] & 1u);
  }
  __syncwarp();
  if (row0 + lane < w) {
#pragma unroll 8
    for (int o = 0; o < 128; ++o)
      s1[static_cast<size_t>(o) * w + row0 + lane] = static_cast<int8_t>(tile[o * kL1Tile + lane]);
  }
}

// ---------------------------------------------------------------------------
// The body of K1 (seal_fused.cu) and K5-open (siv_fused.cu): counter planes
// -> bitsliced AES -> keystream XOR onto the staged stream -> the stream out
// -> level 1 of the GHASH-side planes (the input's when BITS_FROM_INPUT,
// else the output's) on the binary tensor cores.  ROWS threads, a row each,
// one block per SM.  The counter policy `Ctr` has stage(cs), which copies
// its 128 words of per-call state into shared memory, and planes(s, cs, row,
// live), which builds stream row `row`'s 128 counter planes from them.
// Shared memory (ctr_level1_smem_words): the key planes, the counter state,
// W1p at kL1Stride, and the stage area (rows kStageStride apart for the
// stream, then kL1Stride apart for level 1's B operand).
//
// The kColumns form (K1t) stages no stream: after the cipher each thread
// reads its row's words straight from the transposed stream, XORs in the
// plane domain and writes them straight back (xor_stream_column), and the
// stage area holds only level 1's B operand, each warp its own 32 rows, so
// no block-wide barrier stands between the cipher and level 1.
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int ctr_level1_smem_words(int rows) {
  return kMaxKeyPlaneWords + 128 + 128 * kL1Stride + rows * kL1Stride;
}

template <int ROWS, bool BITS_FROM_INPUT, StreamForm FORM = StreamForm::kRows, class Ctr>
__device__ __forceinline__ void ctr_level1_body(uint32_t* smem, const Ctr& ctr,
                                                const uint32_t* __restrict__ kp,
                                                const uint32_t* __restrict__ ghmask,
                                                const uint32_t* __restrict__ w1p,
                                                const uint32_t* __restrict__ in,
                                                uint32_t* __restrict__ out,
                                                int8_t* __restrict__ s1, int rounds, int w) {
  static_assert(kL1Stride >= kStageStride, "the stage area holds both row forms");
  constexpr bool kColumns = FORM == StreamForm::kColumns;
  uint32_t* kps = smem;
  uint32_t* cs = kps + kMaxKeyPlaneWords;
  uint32_t* w1s = cs + 128;
  uint32_t* stage = w1s + 128 * kL1Stride;

  const int w0 = blockIdx.x * ROWS;
  copy_to_smem(kp, kps, (rounds + 1) * 128);
  ctr.stage(cs);
  for (int i = threadIdx.x; i < 128 * 32; i += blockDim.x)  // W1p's rows kL1Stride apart
    reinterpret_cast<uint4*>(w1s + (i >> 5) * kL1Stride)[i & 31] =
        __ldg(reinterpret_cast<const uint4*>(w1p) + i);
  if constexpr (!kColumns) stage_rows_in(in, stage, w0, ROWS, w);
  __syncthreads();

  const int row = w0 + threadIdx.x;
  const bool live = row < w;
  const uint32_t ghm = live ? ghmask[row] : 0u;

  uint32_t s[8][16];
  ctr.planes(s, cs, row, live);
  encrypt_state(s, kps, rounds);
  // s becomes the GHASH-side planes (plane q = b*16 + p, the row order of
  // the plane-ordered W1)
  if constexpr (kColumns) {
    xor_stream_column<BITS_FROM_INPUT>(s, in, out, row, w, live);
  } else {
    xor_stream_row<true, BITS_FROM_INPUT>(s, stage + threadIdx.x * kStageStride);
    __syncthreads();
    stage_rows_out(stage, out, w0, ROWS, w);
    __syncthreads();  // the stage area now takes level 1's B operand
  }
  stage_level1_row(s, ghm, stage + threadIdx.x * kL1Stride);
  __syncwarp();     // a warp reads back only its own 32 rows
  const int first = threadIdx.x & ~31;
  level1_mma_warp(w1s, stage + first * kL1Stride, s1, w0 + first, w);
}

// GCM's counters as a policy of the bodies (K1, K3): J0's planes staged,
// each row's 32-aligned counter and its 24-bit extension from lohi.
struct GcmCounters {
  const uint32_t* j0c;
  const uint32_t* lohi;
  int w;
  __device__ __forceinline__ void stage(uint32_t* cs) const { copy_to_smem(j0c, cs, 128); }
  __device__ __forceinline__ void planes(uint32_t (&s)[8][16], const uint32_t* cs, int row,
                                         bool live) const {
    const uint32_t lo = live ? __ldg(lohi + row) : 0u;
    const uint32_t hi = live ? __ldg(lohi + static_cast<size_t>(w) + row) : 0u;
    counter_planes(s, cs, lo, hi);
  }
};

// ---------------------------------------------------------------------------
// The body of K3 (ctr_fused.cu), K5 (siv_fused.cu) and K8 (xex_fused.cu):
// the block's first thread starts one cp.async.bulk (TMA) copy a row of the
// block's input rows into the stage area (rows kL1Stride apart), completing
// on an mbarrier, while the block stages its key planes and counter state
// and each thread runs counter planes -> bitsliced AES -> the keystream
// turned into words in place; then each thread waits on the mbarrier, XORs
// its keystream words onto its staged row in the word domain, and the block
// stores its rows.  A keystream XOR never needs the input as planes: 4
// transposes a row, not 8.  ROWS threads, a row each; the counter policy
// `Ctr` is as for ctr_level1_body (K8's reads its row of the caller's block
// stream into planes).  DECRYPT runs the inverse cipher (K8's decrypt
// direction).  Shared memory (ctr_xor_smem_words): the key planes, the
// counter state, the stage area and the mbarrier.
//
// The kColumns form (K5t) copies nothing under the cipher and has no stage
// area: after it each thread reads its row's words straight from the
// transposed stream, XORs them in the word domain and writes them straight
// back (xor_words_column).  A TMA copy of the block's tile under the cipher
// (one cp.async.bulk a lane, for w a multiple of 4) ran no faster (PERF.md).
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int ctr_xor_smem_words(int rows,
                                                     StreamForm form = StreamForm::kRows) {
  return kMaxKeyPlaneWords + 128 + (form == StreamForm::kRows ? rows * kL1Stride + 2 : 0);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Rows w0 .. w0 + live - 1 of the w-major stream into the stage area
// (kL1Stride apart, 16-byte aligned), one 512-byte cp.async.bulk a row, all
// completing on phase 0 of the mbarrier `bar`.  One thread runs it; nothing
// waits here (wait_rows_bulk does).
__device__ __forceinline__ void stage_rows_bulk(const uint32_t* __restrict__ src, uint32_t* stage,
                                                uint64_t* bar, int w0, int live) {
  const unsigned b = smem_u32(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(live * 512)
               : "memory");
  for (int r = 0; r < live; ++r)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_u32(stage + r * kL1Stride)), "l"(src + static_cast<size_t>(w0 + r) * 128),
        "r"(512), "r"(b)
        : "memory");
}

// Until phase 0 of `bar` completes: then the rows it tracks are visible to
// this thread.
__device__ __forceinline__ void wait_rows_bulk(uint64_t* bar) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_u32(bar))
        : "memory");
}

// The stage area's rows (kL1Stride apart) out to rows w0.. of the stream,
// 16-byte loads and stores, coalesced; rows at or past w are not stored.
template <int ROWS>
__device__ __forceinline__ void stage_rows_out_wide(const uint32_t* stage,
                                                    uint32_t* __restrict__ dst, int w0, int w) {
  uint4* dst4 = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int n = 0; n < 32; ++n) {
    const int i = n * ROWS + threadIdx.x;
    const int r = i >> 5, c4 = i & 31;
    if (w0 + r < w)
      dst4[static_cast<size_t>(w0 + r) * 32 + c4] =
          reinterpret_cast<const uint4*>(stage + r * kL1Stride)[c4];
  }
}

template <int ROWS, StreamForm FORM = StreamForm::kRows, bool DECRYPT = false, class Ctr>
__device__ __forceinline__ void ctr_xor_body(uint32_t* smem, const Ctr& ctr,
                                             const uint32_t* __restrict__ kp,
                                             const uint32_t* __restrict__ in,
                                             uint32_t* __restrict__ out, int rounds, int w) {
  constexpr bool kColumns = FORM == StreamForm::kColumns;
  uint32_t* kps = smem;
  uint32_t* cs = kps + kMaxKeyPlaneWords;
  uint32_t* stage = cs + 128;
  uint64_t* bar = reinterpret_cast<uint64_t*>(stage + ROWS * kL1Stride);

  const int w0 = blockIdx.x * ROWS;
  if constexpr (!kColumns) {
    if (threadIdx.x == 0)  // the copy runs under the cipher
      stage_rows_bulk(in, stage, bar, w0, min(ROWS, w - w0));
  }
  copy_to_smem(kp, kps, (rounds + 1) * 128);
  ctr.stage(cs);
  __syncthreads();

  const int row = w0 + threadIdx.x;
  const bool live = row < w;
  uint32_t s[8][16];
  ctr.planes(s, cs, row, live);
  if constexpr (DECRYPT) {
    decrypt_state(s, kps, rounds);
  } else {
    encrypt_state(s, kps, rounds);
  }
  planes_to_words(s);
  if constexpr (kColumns) {
    if (live) xor_words_column(s, in, out, row, w);
  } else {
    wait_rows_bulk(bar);
    if (live) xor_words_into_row(s, stage + threadIdx.x * kL1Stride);
    __syncthreads();
    stage_rows_out_wide<ROWS>(stage, out, w0, w);
  }
}


// Launches `kernel` with `rows` threads a block, a thread a stream row, over
// W rows, with `smem_words` words of dynamic shared memory; 0 or the CUDA
// error.
template <class Kernel, class... Args>
int launch_rows(Kernel kernel, int rows, int smem_words, int w, cudaStream_t stream,
                Args... args) {
  const size_t smem = smem_words * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(w + rows - 1) / rows, rows, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace uaes
