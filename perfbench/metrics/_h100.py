"""The yardstick's frozen roofline arithmetic for one NVIDIA H100 SXM.

Copied from chip_smoke.py (`aes_gates`, `bound`, `LEVEL1_MMA` and the peak
constants) so that a later change to the program cannot move it.  The least
time of a call's work is the larger of its bytes moved once over the HBM
rate and its operations over the matching peak:

* AES: the 2-input logic gates of one bitsliced AES of 32 blocks, halved (a
  LOP3 does at most two), over the INT32 issue rate.  That rate is derived
  from published unit counts, not read from a data sheet: 132 SMs x 64
  INT32 lanes x 1.98 GHz boost (half the lanes behind the data sheet's 67
  TFLOP/s float32, which counts an FMA as two).
* GHASH: at the cheapest rate any kernel of the program uses, the binary
  tensor-core product of level 1 (an AND and an add per output bit and
  input bit: 2 x 128 x 128 a block), at the int8 dense peak of 1,979 TOP/s
  (NVIDIA's H100 SXM data sheet, at its 700 W power limit).
* Bytes: 3.35 TB/s of HBM3 (the same data sheet).

The two units run side by side, so the larger of the two operation times
counts, and then the larger of that and the byte time.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
TENSOR_OPS_PER_S = 1.979e15
CLOCK_HZ = 1.98e9
INT32_PER_S = 132 * 64 * CLOCK_HZ
PEAK_SOURCE = ("NVIDIA H100 SXM data sheet (dense, 700 W): 3.35 TB/s HBM3, 1,979 TOP/s int8; "
               "INT32 issue 132 SMs x 64 lanes x 1.98 GHz")

# level1_mma_warp: an AND and an add per (output, bit) over a row of 32 blocks
LEVEL1_MMA = 2 * 128 * 4096
GHASH_OPS_PER_BLOCK = LEVEL1_MMA / 32

# The inverse S-box's two linear layers as the program derives them
# (micro_aes_tpu_torch/core/bitslice.py, `_INV_TOP_OPS` and `_INV_BOT_OPS`,
# randomized-restart Paar CSE with seed 0; also csrc/sbox_inv.cuh): 29 and
# 35 XORs around the shared 62-gate middle.
INV_TOP_XORS = 29
INV_BOT_XORS = 35


def aes_gates(rounds: int, decrypt: bool = False) -> int:
    """One bitsliced AES of 32 blocks: S-boxes (115 gates forward, the
    inverse programs plus the shared 62-gate middle backward), MixColumns
    (528, InvMixColumns 352 more), AddRoundKey (128)."""
    sbox = INV_TOP_XORS + 62 + INV_BOT_XORS if decrypt else 115
    mix = 528 + (352 if decrypt else 0)
    return rounds * (16 * sbox + 128) + (rounds - 1) * mix + 128


def bound(nbytes: float, gates: float, tensor_ops: float = 0) -> tuple[float, str]:
    """(bound_ms, bound_by) from the bytes moved, the gates done and the
    tensor-core operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(gates / 2 / INT32_PER_S, tensor_ops / TENSOR_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def least_ms(work: dict) -> float:
    """The least time of a call's work: work["bytes"] moved once,
    work["aes"] a list of (rounds, decrypt, blocks), work["ghash_blocks"]."""
    gates = sum(aes_gates(r, d) * n / 32 for r, d, n in work["aes"])
    return bound(work["bytes"], gates, work.get("ghash_blocks", 0) * GHASH_OPS_PER_BLOCK)[0]
