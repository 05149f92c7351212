"""K5's and K5-open's GCM-SIV counters in the plane domain
(csrc/siv_fused.cu SivCounters), modelled with numpy and held against the
port's counter stream (ops/siv_kernels._siv_ctrw_stream, which the plain
versions use) and Python ints: word 0 of block j of row r is
basew[4j] + 32r + j mod 2^32, built as the planes of B = basew[4j] + j (once
a block) plus 32r as a bitsliced add, bits 5-31, the carry out of bit 31
dropped.  No JAX; under a second."""
import numpy as np
import pytest
import torch

from micro_aes_tpu_torch.ops.siv_kernels import _siv_ctrw_stream

_M32 = (1 << 32) - 1


def _word0_by_plane_add(basew: np.ndarray, rows) -> np.ndarray:
    """uint32[len(rows), 32]: word 0 of each row's 32 blocks, as the kernel
    makes it."""
    b = (basew[0::4].astype(np.uint64) + np.arange(32, dtype=np.uint64)) & _M32
    planes = [int(sum(((int(b[j]) >> q) & 1) << j for j in range(32))) for q in range(32)]
    out = np.zeros((len(rows), 32), dtype=np.uint64)
    for i, r in enumerate(rows):
        c = (32 * r) & _M32
        s, carry = list(planes), 0
        for q in range(5, 32):
            kq = _M32 if (c >> q) & 1 else 0
            x = s[q]
            s[q] = x ^ kq ^ carry
            carry = (x & kq) | (carry & (x ^ kq))
        for j in range(32):
            out[i, j] = sum(((s[q] >> j) & 1) << q for q in range(32))
    return out.astype(np.uint32)


def _bases(rng, w):
    lanes = rng.integers(0, 2**32, 128, dtype=np.uint64).astype(np.uint32)
    wrap = lanes.copy()
    wrap[0::4] = (-32 * (w // 2) - 5) & _M32       # word 0 wraps inside row w // 2
    lane_wrap = lanes.copy()
    lane_wrap[0::4] = [_M32 - j % 7 for j in range(32)]  # B wraps for j >= 7
    return {"random_lanes": lanes, "wrap_in_row": wrap, "lane_wrap": lane_wrap}


@pytest.mark.parametrize("case", ("random_lanes", "wrap_in_row", "lane_wrap"))
def test_plane_domain_counter_add_matches_counter_stream(case):
    w = 300
    basew = _bases(np.random.default_rng(14), w)[case]
    rows = (0, 1, 2, w // 2 - 1, w // 2, w // 2 + 1, 257, w - 1)
    got = _word0_by_plane_add(basew, rows)
    stream = _siv_ctrw_stream(torch.from_numpy(basew.view(np.int32)).reshape(1, 128), w)
    want = stream.numpy().view(np.uint32)[list(rows)]
    np.testing.assert_array_equal(got, want[:, 0::4])
    np.testing.assert_array_equal(want[:, 1::4], np.broadcast_to(basew[1::4], (len(rows), 32)))
    np.testing.assert_array_equal(want[:, 2::4], np.broadcast_to(basew[2::4], (len(rows), 32)))
    np.testing.assert_array_equal(want[:, 3::4], np.broadcast_to(basew[3::4], (len(rows), 32)))
    # rows past 2^27, where 32r itself wraps mod 2^32
    far = (2**27 - 1, 2**27, 2**31 + 3)
    expect = [[(int(basew[4 * j]) + 32 * r + j) & _M32 for j in range(32)] for r in far]
    np.testing.assert_array_equal(_word0_by_plane_add(basew, far), np.array(expect, np.uint32))
