"""K6's offsets in the word domain (csrc/xex_fused.cu) against the port's
plain version, ops/xex_kernels.xex_offsets, on the CPU.

The kernel makes the offset of block jj of a row, base * alpha^jj, from the
base's four little-endian words by one funnel shift by jj and one fold of
the jj bits that fall out of word 3 (x^128 = x^7 + x^2 + x + 1: the fold
is under 2^38, so it lands in words 0 and 1 and needs no second
reduction).  `alpha_pow_words` below is that arithmetic on Python ints; the
plain version reaches the same offsets by five masked stages.  The plain
version is held against the JAX package's xex_fused_jnp by
tests/test_torch_xts.py, so this file needs no JAX call.
"""
import numpy as np
import pytest
import torch

from micro_aes_tpu_torch.ops.xex_kernels import xex_offsets

M32 = 0xFFFFFFFF


def alpha_pow_words(v, jj):
    """base * alpha^jj (0 <= jj <= 31) on four little-endian 32-bit words,
    as xex_fused.cu computes it."""
    w0, w1, w2, w3 = v
    if jj == 0:
        return [w0, w1, w2, w3]
    ov = w3 >> (32 - jj)

    def funnel(lo, hi):  # __funnelshift_l(lo, hi, jj)
        return ((hi << jj) | (lo >> (32 - jj))) & M32

    fold = ov ^ (ov << 1) ^ (ov << 2) ^ (ov << 7)  # < 2^38
    return [((w0 << jj) ^ fold) & M32, funnel(w0, w1) ^ (fold >> 32), funnel(w1, w2),
            funnel(w2, w3)]


def _bases(kind, rng, w):
    x = rng.integers(0, 2**32, (w, 128), dtype=np.uint32)
    if kind == "all_ones":
        x[:] = M32
    elif kind == "word3_top_bit":
        x[:, 3::4] = 0x80000000
    elif kind == "word3_all_ones":
        x[:, 3::4] = M32
    return x


def _as_int(v):
    return sum(int(v[k]) << (32 * k) for k in range(4))


@pytest.mark.parametrize("kind", ("random", "all_ones", "word3_top_bit", "word3_all_ones"))
def test_word_domain_offsets_match_plain_version(kind):
    """Every jj = 0..31 of every row: the kernel's one-shift form equals
    xex_offsets, and (as a check of the model itself) the 128-bit value
    doubled jj times with the 0x87 tap."""
    base = _bases(kind, np.random.default_rng(12), 4)
    want = xex_offsets(torch.from_numpy(base.view(np.int32))).numpy().view(np.uint32)
    for r in range(base.shape[0]):
        for jj in range(32):
            v = [int(x) for x in base[r, 4 * jj: 4 * jj + 4]]
            got = alpha_pow_words(v, jj)
            assert got == [int(x) for x in want[r, 4 * jj: 4 * jj + 4]], (kind, r, jj)
            d = _as_int(v)
            for _ in range(jj):
                d = ((d << 1) & ((1 << 128) - 1)) ^ (0x87 if d >> 127 else 0)
            assert _as_int(got) == d, (kind, r, jj)
